// K3: int8 x int8 -> int32 3-D convolution with a fused epilogue,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU package's models/resnet3d_int8.py::_conv_i8 (line 131,
// an XLA conv_general_dilated with preferred_element_type=int32, no Pallas
// kernel) and the elementwise work that wraps it in _forward: the dequant
// o * (s_act * s_w[c]) + b[c] (lines 210-218), the ReLU and the next quant
// point clip(round(h / s_next), -127, 127) (_quantize, lines 150-152).
// Stock PyTorch has no CUDA int8 convolution, so this path runs nowhere on
// the card without it.
//
// Layouts. Activations are NDHWC int8, contiguous (C_in innermost). Weights
// are [C_out][kd][kh][kw][C_in] int8, so each output channel's K = k^3 *
// C_in products are one contiguous run (the wrapper re-lays the DHWIO
// export once). Output is NDHWC: row m = (b, d, h, w) of the output grid,
// column n = output channel. Zero padding d * (k - 1) / 2 on each side,
// kernel 1 or 3, any stride and dilation.
//
// As a GEMM: M = B * D_out * H_out * W_out, N = C_out, K = k^3 * C_in, with
// A (M x K) never written out (an implicit GEMM): step s of the K loop is
// tap s / (C_in / 32), channels 32 * (s % (C_in / 32)) .. + 31, so the K
// index of step s is 32 * s in the weights' layout as well.
//
// Design (simple and right first; wgmma, TMA and a persistent ring are
// later work): one block of 4 warps computes a 128 x 64 output tile.
//   - Each of the 128 threads owns one output row of the tile: it decodes
//     its voxel once and, per K step, copies the 32 input bytes of its tap
//     with two 16-byte cp.async into shared memory, zero-filled (src-size
//     0) where the tap falls in the padding or the row is past M. The 64
//     weight rows of the step take one 16-byte cp.async per thread.
//   - A 4-stage cp.async ring keeps three steps in flight while the warps
//     compute on the fourth.
//   - Shared rows are 48 bytes apart, so the fragment loads (row g, bytes
//     4t..4t+3 for lane 4g + t) hit 32 distinct banks.
//   - Each warp computes 32 x 64 of the tile with
//     mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32: 2 x 8 tiles of
//     16 x 8, 64 int32 accumulators a thread.
//   - The epilogue works from the accumulators in registers and writes two
//     neighbouring channels at once:
//       mode 0: int32 out (tests);
//       mode 1: int8 out, q = clip(rint(relu(o * k[c] + b[c]) / s_next));
//       mode 2: float32 out, o * k[c] + b[c].
//     k[c] = s_act * s_w[c] is computed once per export in float32. The
//     float operations are the TPU package's, in its order and rounding:
//     a multiply and an add that nvcc must not contract into an FMA
//     (__fmul_rn, __fadd_rn), a true division (__fdiv_rn, never a
//     reciprocal), rintf (half to even, as round there). So the kernel is
//     bit-equal to the plain version (ops/int8_conv.py), whose sums are
//     exact (|sum| <= 127^2 * 27 * 512 < 2^31) in every epilogue.
//
// What bounds it on this card: tensor-core operations. At the flagship's
// shapes (B = 8, 91x109x91 input) the 19 block convolutions of a ResNet-18
// forward are 1.16 TOP (dense taps, padding included), 0.59 ms at the
// H100's 1,979 TOP/s int8 dense rate; the 1x1x1 shortcuts alone are bound
// by their bytes. mma.sync reaches only part of that rate on Hopper, and
// the A tile is gathered again for every tap (from L2 mostly).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ops/_build.py);
// bound with ctypes through the extern "C" entry points at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // output rows (voxels) of a block's tile
constexpr int kBN = 64;         // output channels of a block's tile
constexpr int kBK = 32;         // K bytes of one step (one m16n8k32)
constexpr int kRow = kBK + 16;  // shared-memory row stride in bytes
constexpr int kStages = 4;      // cp.async ring depth
constexpr int kThreads = 128;   // 4 warps, each 32 rows x 64 channels

struct Params {
  const int8_t* x;      // (B, D, H, W, C) int8
  const int8_t* w;      // (N, k, k, k, C) int8
  void* out;            // (M, N) int32 / int8 / float32
  const float* kscale;  // (N,) s_act * s_w[c]      (modes 1, 2)
  const float* bias;    // (N,) folded BN bias     (modes 1, 2)
  float s_next;         // next quant point's scale (mode 1)
  int D, H, W, C;
  int Do, Ho, Wo, N;
  int ksize, stride, dil, pad;
  long long M;
  int K;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float dequant(int v, float k, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(v), k), b);
}

__device__ __forceinline__ int8_t requant(float h, float s_next) {
  float q = rintf(__fdiv_rn(fmaxf(h, 0.0f), s_next));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) conv_i8_kernel(const Params p) {
  __shared__ __align__(128) int8_t a_s[kStages][kBM * kRow];
  __shared__ __align__(128) int8_t b_s[kStages][kBN * kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // this thread's A row: one output voxel, decoded once
  const long long m = m0 + tid;
  const bool m_ok = m < p.M;
  int od = 0, oh = 0, ow = 0;
  long long bi = 0;
  if (m_ok) {
    long long t = m;
    ow = static_cast<int>(t % p.Wo);
    t /= p.Wo;
    oh = static_cast<int>(t % p.Ho);
    t /= p.Ho;
    od = static_cast<int>(t % p.Do);
    bi = t / p.Do;
  }
  const int id0 = od * p.stride - p.pad;
  const int ih0 = oh * p.stride - p.pad;
  const int iw0 = ow * p.stride - p.pad;
  const int8_t* xb = p.x + bi * p.D * p.H * p.W * static_cast<long long>(p.C);
  // this thread's B chunk: half a weight row of the step
  const int bn = tid >> 1;
  const int bhalf = (tid & 1) * 16;
  const bool n_ok = n0 + bn < p.N;
  const int8_t* wrow = p.w + static_cast<long long>(n_ok ? n0 + bn : 0) * p.K + bhalf;

  const int cchunks = p.C / kBK;
  const int kk = p.ksize * p.ksize;
  const int steps = kk * p.ksize * cchunks;

  auto load = [&](int stage, int s) {
    const int tap = s / cchunks;
    const int c0 = (s - tap * cchunks) * kBK;
    const int kd = tap / kk;
    const int kh = (tap / p.ksize) % p.ksize;
    const int kw = tap % p.ksize;
    const int id = id0 + kd * p.dil;
    const int ih = ih0 + kh * p.dil;
    const int iw = iw0 + kw * p.dil;
    const bool ok = m_ok && static_cast<unsigned>(id) < static_cast<unsigned>(p.D) &&
                    static_cast<unsigned>(ih) < static_cast<unsigned>(p.H) &&
                    static_cast<unsigned>(iw) < static_cast<unsigned>(p.W);
    const int8_t* src =
        ok ? xb + ((static_cast<long long>(id) * p.H + ih) * p.W + iw) * p.C + c0 : p.x;
    const uint32_t dst = smem_addr(&a_s[stage][tid * kRow]);
    cp_async16(dst, src, ok ? 16 : 0);
    cp_async16(dst + 16, ok ? src + 16 : src, ok ? 16 : 0);
    const int8_t* wsrc = n_ok ? wrow + static_cast<long long>(s) * kBK : p.w;
    cp_async16(smem_addr(&b_s[stage][bn * kRow + bhalf]), wsrc, n_ok ? 16 : 0);
  };

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }

  const int g = lane >> 2;        // fragment row / column group
  const int t4 = (lane & 3) * 4;  // fragment byte offset in K
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s landed for all; everyone is done with step s - 1
    const int nxt = s + kStages - 1;
    if (nxt < steps) load(nxt % kStages, nxt);
    cp_async_commit();

    const int8_t* a_t = a_s[s % kStages];
    const int8_t* b_t = b_s[s % kStages];
    uint32_t af[2][4];
    uint32_t bf[8][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* r0 = a_t + (warp * 32 + i * 16 + g) * kRow + t4;
      const int8_t* r1 = r0 + 8 * kRow;
      af[i][0] = lds32(r0);
      af[i][1] = lds32(r1);
      af[i][2] = lds32(r0 + 16);
      af[i][3] = lds32(r1 + 16);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int8_t* r = b_t + (j * 8 + g) * kRow + t4;
      bf[j][0] = lds32(r);
      bf[j][1] = lds32(r + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }
  cp_async_wait<0>();

  // epilogue: lane (g, t) holds rows g and g + 8 of each 16 x 8 tile,
  // channels 2t and 2t + 1
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + warp * 32 + i * 16 + g + half * 8;
      if (row >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + j * 8 + t2;
        if (col >= p.N) continue;  // N % 8 == 0: col and col + 1 are both in or both out
        const int v0 = acc[i][j][half * 2];
        const int v1 = acc[i][j][half * 2 + 1];
        const long long o = row * p.N + col;
        if (MODE == 0) {
          *reinterpret_cast<int2*>(static_cast<int*>(p.out) + o) = make_int2(v0, v1);
        } else {
          const float h0 = dequant(v0, p.kscale[col], p.bias[col]);
          const float h1 = dequant(v1, p.kscale[col + 1], p.bias[col + 1]);
          if (MODE == 1) {
            char2 q;
            q.x = requant(h0, p.s_next);
            q.y = requant(h1, p.s_next);
            *reinterpret_cast<char2*>(static_cast<int8_t*>(p.out) + o) = q;
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) = make_float2(h0, h1);
          }
        }
      }
    }
  }
}

}  // namespace

// Launch K3 on `stream` (a cudaStream_t as a pointer). x: (B, D, H, W, C)
// int8; w: (N, k, k, k, C) int8; out: (B, Do, Ho, Wo, N) of int32 (mode 0),
// int8 (mode 1) or float32 (mode 2); kscale, bias: (N,) float32 (modes 1,
// 2). The caller checks C % 32 == 0, N % 8 == 0, contiguity, 16-byte
// alignment and the output size. Does not synchronise; returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int mad_conv_i8(const void* x, const void* w, void* out, const void* kscale,
                           const void* bias, float s_next, int batch, int D, int H, int W, int C,
                           int N, int ksize, int stride, int dil, int Do, int Ho, int Wo, int mode,
                           void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.out = out;
  p.kscale = static_cast<const float*>(kscale);
  p.bias = static_cast<const float*>(bias);
  p.s_next = s_next;
  p.D = D;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Do = Do;
  p.Ho = Ho;
  p.Wo = Wo;
  p.N = N;
  p.ksize = ksize;
  p.stride = stride;
  p.dil = dil;
  p.pad = dil * (ksize - 1) / 2;
  p.M = static_cast<long long>(batch) * Do * Ho * Wo;
  p.K = ksize * ksize * ksize * C;
  const dim3 grid(static_cast<unsigned>((p.M + kBM - 1) / kBM), (N + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      conv_i8_kernel<0><<<grid, kThreads, 0, s>>>(p);
      break;
    case 1:
      conv_i8_kernel<1><<<grid, kThreads, 0, s>>>(p);
      break;
    case 2:
      conv_i8_kernel<2><<<grid, kThreads, 0, s>>>(p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mad_conv_i8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
