// K2: atlas ROI pooling (per-ROI channel means), hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU package's ops/roi_pool.py::roi_pool_pallas (function at
// line 94, inner kernel _roi_pool_kernel at line 62, pallas_call at line
// 109). It computes
//     out[b, r, c] = sum_n [label[n] == r + 1] * feats[b, n, c] / max(count_r, 1e-6)
// for ROI ids 1..R (label 0 is background), with float32 accumulation, from
// float32 or bfloat16 features laid out (B, X, Y, Z, C) with any strides.
//
// What bounds it: HBM bytes. Each labelled voxel's C features are read once
// and added once (one add per element read): at the extraction shape
// (B = 8, 902,629 voxels, C = 64, f32, 166 ROIs) reading every voxel is
// 1,848.6 MB of features, plus 3.6 MB of voxel index and 0.34 MB of output,
// 0.553 ms at 3.35 TB/s, while the 0.46 G adds are far below the card's f32
// rate. Background voxels are never read, so for a given atlas the bound is
// the labelled share of that (chip_smoke.py::k2_bound_ms).
//
// Design: a label-sorted segmented sum, not the Pallas one-hot matmul. The
// wrapper prepares once per atlas (ops/roi_pool.py::RoiAtlas) the voxel
// indices of the labelled voxels, stably sorted by label, and the R + 1
// segment offsets; they are the same for every batch. The grid is
// (ROI, batch, 64-channel tile). In a block of 8 warps, warp w takes the
// segment's voxels w, w + 8, w + 16, ... in order; lane l adds channels
// l and l + 32 of each voxel, so with a unit channel stride a warp reads a
// voxel's 64 channels as two coalesced 128-byte rows, and four voxels are
// loaded before they are added to keep loads in flight. The 8 warp
// partials are summed in shared memory in warp order, then divided by
// max(count, 1e-6). No atomics and a fixed order of every addition make
// the output bit-identical from launch to launch; nothing but the output is
// written, and feats is read once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ops/_build.py);
// bound with ctypes through the extern "C" entry points at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileC = 64;  // channels per block: two per lane
constexpr int kUnroll = 4;  // voxels loaded before they are added

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// kDense: the spatial axes are contiguous in x, y, z order (stride_x ==
// Y * stride_y, stride_y == Z * stride_z), so voxel n sits at n * stride_z.
template <typename T, bool kDense>
__global__ void __launch_bounds__(kThreads)
roi_segment_mean(const T* __restrict__ feats, int channels, int yz, int z_size,
                 long long s_b, long long s_x, long long s_y, long long s_z,
                 long long s_c, const int* __restrict__ order,
                 const int* __restrict__ offsets, int num_rois,
                 float* __restrict__ out) {
  __shared__ float part[kWarps][kTileC];
  const int r = blockIdx.x, b = blockIdx.y, c0 = blockIdx.z * kTileC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int begin = offsets[r], end = offsets[r + 1];
  const bool va = c0 + lane < channels, vb = c0 + 32 + lane < channels;
  const long long oa = static_cast<long long>(c0 + lane) * s_c;
  const long long ob = static_cast<long long>(c0 + 32 + lane) * s_c;
  const T* base = feats + static_cast<long long>(b) * s_b;

  auto voxel = [&](int n) -> const T* {
    if (kDense) return base + static_cast<long long>(n) * s_z;
    const int x = n / yz;
    const int rem = n - x * yz;
    const int y = rem / z_size;
    const int z = rem - y * z_size;
    return base + x * s_x + y * s_y + z * s_z;
  };

  float acc_a = 0.0f, acc_b = 0.0f;
  int i = begin + warp;
  for (; i + (kUnroll - 1) * kWarps < end; i += kUnroll * kWarps) {
    float xa[kUnroll], xb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T* p = voxel(order[i + u * kWarps]);
      xa[u] = va ? to_f32(p[oa]) : 0.0f;
      xb[u] = vb ? to_f32(p[ob]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // in voxel order
      acc_a += xa[u];
      acc_b += xb[u];
    }
  }
  for (; i < end; i += kWarps) {
    const T* p = voxel(order[i]);
    acc_a += va ? to_f32(p[oa]) : 0.0f;
    acc_b += vb ? to_f32(p[ob]) : 0.0f;
  }
  part[warp][lane] = acc_a;
  part[warp][lane + 32] = acc_b;
  __syncthreads();
  if (threadIdx.x < kTileC && c0 + threadIdx.x < channels) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][threadIdx.x];
    const float count = static_cast<float>(end - begin);
    out[(static_cast<long long>(b) * num_rois + r) * channels + c0 + threadIdx.x] =
        s / fmaxf(count, 1e-6f);
  }
}

template <typename T>
cudaError_t launch(const void* feats, int batch, int y, int z, int channels,
                   long long s_b, long long s_x, long long s_y, long long s_z,
                   long long s_c, const int* order, const int* offsets,
                   int num_rois, float* out, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(num_rois), static_cast<unsigned>(batch),
                  static_cast<unsigned>((channels + kTileC - 1) / kTileC));
  const bool dense = s_y == static_cast<long long>(z) * s_z &&
                     s_x == static_cast<long long>(y) * s_y;
  const T* f = static_cast<const T*>(feats);
  if (dense)
    roi_segment_mean<T, true><<<grid, kThreads, 0, stream>>>(
        f, channels, y * z, z, s_b, s_x, s_y, s_z, s_c, order, offsets, num_rois, out);
  else
    roi_segment_mean<T, false><<<grid, kThreads, 0, stream>>>(
        f, channels, y * z, z, s_b, s_x, s_y, s_z, s_c, order, offsets, num_rois, out);
  return cudaGetLastError();
}

}  // namespace

// feats_dtype: 0 float32, 1 bfloat16. feats is (batch, x, y, z, channels)
// with element strides s_*; order holds the labelled voxel indices
// (x * y * z + ...) sorted by label, offsets the num_rois + 1 segment bounds
// into it; out is a contiguous float32 (batch, num_rois, channels).
// Launches on `stream` of `device`, does not synchronise, and returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int mad_roi_pool(const void* feats, int feats_dtype, int batch, int x,
                            int y, int z, int channels, long long s_b, long long s_x,
                            long long s_y, long long s_z, long long s_c,
                            const void* order, const void* offsets, int num_rois,
                            void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || batch > 65535 || x <= 0 || y <= 0 || z <= 0 || channels <= 0 ||
      (channels + kTileC - 1) / kTileC > 65535 || num_rois <= 0 ||
      static_cast<long long>(x) * y * z > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ord = static_cast<const int*>(order);
  const int* off = static_cast<const int*>(offsets);
  float* o = static_cast<float*>(out);
  switch (feats_dtype) {
    case 0: err = launch<float>(feats, batch, y, z, channels, s_b, s_x, s_y, s_z, s_c, ord, off, num_rois, o, st); break;
    case 1: err = launch<__nv_bfloat16>(feats, batch, y, z, channels, s_b, s_x, s_y, s_z, s_c, ord, off, num_rois, o, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* mad_roi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
