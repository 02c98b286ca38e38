// K1: fused gather + per-volume min-max normalize, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU package's ops/fused_gather.py::gather_normalize_pallas
// (function at line 63, inner kernel at line 76, pallas_call at line 96).
// For each batch slot b it reads volume src[idx[b]] (vox elements of uint8,
// int16 or float32), finds the volume's min and max, and writes
//     out[b, i] = (x[i] - lo) * (1 / (hi - lo + 1e-30))     (0 if hi - lo < 1e-12)
// as float32 or bfloat16. The arithmetic is float32 and multiplies by a
// correctly rounded reciprocal, exactly as the Pallas kernel does; the
// plain PyTorch version (ops/fused_gather.py::gather_normalize_plain)
// performs the same IEEE operations, so the two agree bit for bit.
//
// What bounds it: HBM bytes. Per voxel it does a compare pair, a subtract
// and a multiply (~4 operations) against 1-4 bytes read and 2-4 written,
// far below the card's ~20 operations per byte for float32 outside the
// tensor cores. At the serving shape (B=8, 902,629 voxels) the bound is
// 36.1 MB / 3.35 TB/s = 10.8 us for uint8 -> f32 and 43.3 MB = 12.9 us
// for float32 -> bf16.
//
// Design. On the TPU one whole volume sits in VMEM for a grid step. Here a
// volume (up to 3.6 MB) is far larger than the 227 KB of shared memory a
// block may use, and blocks run in parallel in no order, so the min/max
// reduction is split across blocks in two launches:
//   pass 1, grid (S chunks x B): each block reads one chunk of its volume
//           with 16-byte vector loads (a scalar head and tail handle the
//           chunk's unaligned ends) and writes one (min, max) partial;
//   pass 2, grid (S x B): each block folds the S partials of its volume
//           and writes its chunk scaled, with coalesced element loads and
//           stores.
// The cost of two passes: the source is read twice. At batch 8 the
// gathered volumes (7-29 MB) mostly fit in the 50 MB L2, so the second
// read is served largely from L2 rather than HBM; the second launch adds
// a few microseconds of launch latency. A one-launch version that keeps
// the partials in a thread-block cluster's distributed shared memory is
// later work.
//
// An index outside [0, n_vol) never reads memory: its output row is NaN.
// The Python wrapper range-checks indices that come from the host.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ops/_build.py);
// bound with ctypes through the extern "C" entry points at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename O>
__device__ __forceinline__ O from_f32(float f);
template <>
__device__ __forceinline__ float from_f32<float>(float f) { return f; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float f) {
  return __float2bfloat16_rn(f);
}

template <typename T>
__device__ __forceinline__ void fold(float& lo, float& hi, T v) {
  const float f = static_cast<float>(v);
  lo = fminf(lo, f);
  hi = fmaxf(hi, f);
}

template <typename T>
union Vec16 {
  uint4 raw;
  T e[16 / sizeof(T)];
};

// Min and max over the block; every thread returns with the block's result.
__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float s_lo[kThreads / 32], s_hi[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = lane < kThreads / 32 ? s_lo[lane] : INFINITY;
  hi = lane < kThreads / 32 ? s_hi[lane] : -INFINITY;
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
minmax_partial(const T* __restrict__ src, long long n_vol, long long vox,
               const I* __restrict__ idx, long long chunk,
               float2* __restrict__ partial) {
  constexpr long long kVec = 16 / sizeof(T);
  const long long s = blockIdx.x, b = blockIdx.y, n_chunks = gridDim.x;
  const long long v = static_cast<long long>(idx[b]);
  float lo = INFINITY, hi = -INFINITY;
  if (v >= 0 && v < n_vol) {
    const long long begin = s * chunk;
    const long long n = min(begin + chunk, vox) - begin;
    const T* p = src + v * vox + begin;
    // elements before the first 16-byte boundary (allocations are aligned
    // to the element size, so this is a whole number of elements)
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    const long long head = min(n, static_cast<long long>(((16 - (addr & 15)) & 15) / sizeof(T)));
    for (long long i = threadIdx.x; i < head; i += kThreads) fold(lo, hi, p[i]);
    const uint4* vp = reinterpret_cast<const uint4*>(p + head);
    const long long n_vec = (n - head) / kVec;
    for (long long i = threadIdx.x; i < n_vec; i += kThreads) {
      Vec16<T> q;
      q.raw = __ldg(vp + i);
#pragma unroll
      for (int k = 0; k < kVec; ++k) fold(lo, hi, q.e[k]);
    }
    for (long long i = head + n_vec * kVec + threadIdx.x; i < n; i += kThreads)
      fold(lo, hi, p[i]);
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) partial[b * n_chunks + s] = make_float2(lo, hi);
}

template <typename T, typename I, typename O>
__global__ void __launch_bounds__(kThreads)
scale_chunk(const T* __restrict__ src, long long n_vol, long long vox,
            const I* __restrict__ idx, long long chunk,
            const float2* __restrict__ partial, O* __restrict__ out) {
  const long long s = blockIdx.x, b = blockIdx.y, n_chunks = gridDim.x;
  float lo = INFINITY, hi = -INFINITY;
  for (long long i = threadIdx.x; i < n_chunks; i += kThreads) {
    const float2 pr = partial[b * n_chunks + i];
    lo = fminf(lo, pr.x);
    hi = fmaxf(hi, pr.y);
  }
  block_minmax(lo, hi);
  const long long v = static_cast<long long>(idx[b]);
  const long long begin = s * chunk;
  const long long end = min(begin + chunk, vox);
  O* o = out + b * vox;
  if (v < 0 || v >= n_vol) {
    for (long long i = begin + threadIdx.x; i < end; i += kThreads) o[i] = from_f32<O>(NAN);
    return;
  }
  const float range = hi - lo;
  const float scale = range < 1e-12f ? 0.0f : 1.0f / (range + 1e-30f);
  const T* x = src + v * vox;
#pragma unroll 4
  for (long long i = begin + threadIdx.x; i < end; i += kThreads)
    o[i] = from_f32<O>((static_cast<float>(x[i]) - lo) * scale);
}

template <typename T, typename I, typename O>
cudaError_t launch(const void* src, long long n_vol, long long vox, const void* idx,
                   int batch, void* out, void* partial, long long chunk,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((vox + chunk - 1) / chunk), static_cast<unsigned>(batch));
  minmax_partial<T, I><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), n_vol, vox, static_cast<const I*>(idx), chunk,
      static_cast<float2*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scale_chunk<T, I, O><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), n_vol, vox, static_cast<const I*>(idx), chunk,
      static_cast<const float2*>(partial), static_cast<O*>(out));
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t dispatch_out(int out_dtype, const void* src, long long n_vol, long long vox,
                         const void* idx, int batch, void* out, void* partial,
                         long long chunk, cudaStream_t stream) {
  switch (out_dtype) {
    case 0: return launch<T, I, float>(src, n_vol, vox, idx, batch, out, partial, chunk, stream);
    case 1: return launch<T, I, __nv_bfloat16>(src, n_vol, vox, idx, batch, out, partial, chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_idx(int idx_dtype, int out_dtype, const void* src, long long n_vol,
                         long long vox, const void* idx, int batch, void* out,
                         void* partial, long long chunk, cudaStream_t stream) {
  switch (idx_dtype) {
    case 0: return dispatch_out<T, int32_t>(out_dtype, src, n_vol, vox, idx, batch, out, partial, chunk, stream);
    case 1: return dispatch_out<T, int64_t>(out_dtype, src, n_vol, vox, idx, batch, out, partial, chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// src_dtype: 0 uint8, 1 int16, 2 float32. idx_dtype: 0 int32, 1 int64.
// out_dtype: 0 float32, 1 bfloat16. partial: scratch of
// batch * ceil(vox / chunk) float2. chunk must be a multiple of 16.
// Launches on `stream` of `device`, does not synchronise, and returns
// cudaGetLastError() of the launches (0 on success).
extern "C" int mad_gather_normalize(const void* src, int src_dtype, long long n_vol,
                                    long long vox, const void* idx, int idx_dtype,
                                    int batch, void* out, int out_dtype, void* partial,
                                    long long chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || vox <= 0 || chunk <= 0 || chunk % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (src_dtype) {
    case 0: err = dispatch_idx<uint8_t>(idx_dtype, out_dtype, src, n_vol, vox, idx, batch, out, partial, chunk, st); break;
    case 1: err = dispatch_idx<int16_t>(idx_dtype, out_dtype, src, n_vol, vox, idx, batch, out, partial, chunk, st); break;
    case 2: err = dispatch_idx<float>(idx_dtype, out_dtype, src, n_vol, vox, idx, batch, out, partial, chunk, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* mad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
