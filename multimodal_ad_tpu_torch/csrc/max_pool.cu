// K4: the backward of max_pool_3d_fast, hand-written for Hopper (sm_90a).
//
// Replaces the TPU package's ops/pool.py::max_pool_3d_fast backward (the
// custom_vjp at line 63, backward at lines 71-138), which is XLA, not
// Pallas: a dense slice/compare/pad form of the max-pool backward. For a
// channels-last input x (B, D, H, W, C), its pooled max y (B, OD, OH, OW, C)
// (window w, stride 2, padding p, padding never a maximum) and the
// cotangent g of y, it computes
//     count[m] = #{elements of window m equal to y[m]}
//     inv[m]   = g[m] / count[m]
//     dx[i]    = sum over the windows m that hold i, with x[i] == y[m], of inv[m]
// so each window's cotangent is split equally among its tied maxima (a
// stock max-pool backward gives it all to one of them).
//
// What bounds it: HBM bytes. x, y and g are read once and dx is written
// once; a few compares and adds per element are far below the float32
// rate. At the ResNet-18 stem pool (8, 46, 55, 46, 64) in bf16 that is
// 268.7 MB, 0.080 ms at 3.35 TB/s (chip_smoke.py phase 21 computes it
// from the tensors).
//
// Design: a gather, not a scatter, so no atomics and a fixed order.
//   pass A, one thread per output element, threads along C (coalesced):
//     scan the window of x for elements equal to y[m] and write inv[m] in
//     float32 to an output-sized scratch;
//   pass B, one thread per input element, threads along C: along each axis
//     the windows holding i are m in [ceil((i + p - w + 1) / 2),
//     floor((i + p) / 2)] within [0, out), at most 2 at w <= 4 (8 in all at
//     3^3, exactly 1 at 2^3/p0); sum inv[m] where x[i] == y[m] in float32,
//     the windows in the TPU form's order (descending m, its ascending
//     window offset), and write dx once in x's type.
// The indicator multiplies inv (0 * inf is NaN), as the TPU form does, so
// a window whose maximum is NaN spreads NaN as it does there. Deterministic:
// two launches are bit-identical. In float32 the sums run in the TPU form's
// order; in bf16 / fp16 the TPU form rounds inv and every partial sum to
// the type, here they are rounded once.
// Simple first: x is re-read from L2 by the overlapping windows of pass A,
// y and inv by pass B. Fusing the passes or staging a tile of the grid in
// shared memory is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ops/_build.py);
// bound with ctypes through the extern "C" entry points at the end.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

struct Dims {
  int b, d, h, w, c;     // input
  int od, oh, ow;        // output
  int window, padding;
};

// pass A: inv[m] = g[m] / count[m]
template <typename T>
__global__ void __launch_bounds__(kThreads)
split_windows(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ g,
              float* __restrict__ inv, Dims s, int n_out) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= n_out) return;
  int r = m / s.c;
  const int ch = m - r * s.c;
  const int mw = r % s.ow;
  r /= s.ow;
  const int mh = r % s.oh;
  r /= s.oh;
  const int md = r % s.od;
  const int b = r / s.od;
  const float yv = to_f32(y[m]);
  const int d0 = 2 * md - s.padding, h0 = 2 * mh - s.padding, w0 = 2 * mw - s.padding;
  int count = 0;
  for (int kd = 0; kd < s.window; ++kd) {
    const int id = d0 + kd;
    if (id < 0 || id >= s.d) continue;
    for (int kh = 0; kh < s.window; ++kh) {
      const int ih = h0 + kh;
      if (ih < 0 || ih >= s.h) continue;
      const T* row = x + ((static_cast<long long>(b) * s.d + id) * s.h + ih) * s.w * s.c + ch;
      for (int kw = 0; kw < s.window; ++kw) {
        const int iw = w0 + kw;
        if (iw < 0 || iw >= s.w) continue;
        count += to_f32(row[static_cast<long long>(iw) * s.c]) == yv;
      }
    }
  }
  inv[m] = to_f32(g[m]) / static_cast<float>(count);
}

// the windows m in [0, out) that hold input index i on one axis
__device__ __forceinline__ void window_range(int i, int out, int window, int padding,
                                             int& lo, int& hi) {
  const int t = i + padding - window + 1;
  lo = t <= 0 ? 0 : (t + 1) / 2;
  hi = min(out - 1, (i + padding) / 2);
}

// pass B: dx[i] = sum of inv[m] over the windows m holding i with x[i] == y[m]
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_windows(const T* __restrict__ x, const T* __restrict__ y,
               const float* __restrict__ inv, T* __restrict__ dx, Dims s, int n_in) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_in) return;
  int r = i / s.c;
  const int ch = i - r * s.c;
  const int iw = r % s.w;
  r /= s.w;
  const int ih = r % s.h;
  r /= s.h;
  const int id = r % s.d;
  const int b = r / s.d;
  int d_lo, d_hi, h_lo, h_hi, w_lo, w_hi;
  window_range(id, s.od, s.window, s.padding, d_lo, d_hi);
  window_range(ih, s.oh, s.window, s.padding, h_lo, h_hi);
  window_range(iw, s.ow, s.window, s.padding, w_lo, w_hi);
  const float xv = to_f32(x[i]);
  float acc = 0.f;
  for (int md = d_hi; md >= d_lo; --md) {
    for (int mh = h_hi; mh >= h_lo; --mh) {
      const int base = ((b * s.od + md) * s.oh + mh) * s.ow;
      for (int mw = w_hi; mw >= w_lo; --mw) {
        const int m = (base + mw) * s.c + ch;
        const float ind = xv == to_f32(y[m]) ? 1.f : 0.f;
        acc += ind * inv[m];
      }
    }
  }
  dx[i] = from_f32<T>(acc);
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* g, const Dims& s, int n_in,
                   int n_out, float* inv, void* dx, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  split_windows<T><<<(n_out + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      xt, yt, static_cast<const T*>(g), inv, s, n_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gather_windows<T><<<(n_in + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      xt, yt, inv, static_cast<T*>(dx), s, n_in);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16, for x, y, g and dx alike. x and
// dx are contiguous (b, d, h, w, c), y and g contiguous (b, od, oh, ow, c),
// inv a float32 scratch of y's size; every element count below 2^31 (the
// wrapper checks). Launches pass A and pass B on `stream` of `device`, does
// not synchronise, and returns cudaGetLastError() of the launches (0 on
// success).
extern "C" int mad_max_pool_backward(const void* x, const void* y, const void* g, int dtype,
                                     int b, int d, int h, int w, int c, int od, int oh,
                                     int ow, int window, int padding, void* inv, void* dx,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_in = static_cast<long long>(b) * d * h * w * c;
  const long long n_out = static_cast<long long>(b) * od * oh * ow * c;
  if (b <= 0 || c <= 0 || od <= 0 || oh <= 0 || ow <= 0 || window <= 0 || padding < 0 ||
      padding >= window || n_in >= (1LL << 31) || n_out >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims s{b, d, h, w, c, od, oh, ow, window, padding};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* iv = static_cast<float*>(inv);
  const int ni = static_cast<int>(n_in), no = static_cast<int>(n_out);
  switch (dtype) {
    case 0: err = launch<float>(x, y, g, s, ni, no, iv, dx, st); break;
    case 1: err = launch<__nv_bfloat16>(x, y, g, s, ni, no, iv, dx, st); break;
    case 2: err = launch<__half>(x, y, g, s, ni, no, iv, dx, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* mad_max_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
