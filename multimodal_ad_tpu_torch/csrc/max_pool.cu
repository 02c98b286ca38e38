// K4: the backward of max_pool_3d_fast, hand-written for Hopper (sm_90a).
//
// Replaces the TPU package's ops/pool.py::max_pool_3d_fast backward (the
// custom_vjp at line 63, backward at lines 71-138), which is XLA, not
// Pallas: a dense slice/compare/pad form of the max-pool backward. For a
// channels-last input x (B, D, H, W, C), its pooled max y (B, OD, OH, OW, C)
// (window w, stride 2, padding p, padding never a maximum) and the
// cotangent g of y, it computes
//     count[m] = #{elements of window m equal to y[m]}, in-volume ones only
//     inv[m]   = g[m] / count[m]                    (IEEE float32 division)
//     dx[i]    = sum over the windows m that hold i of [x[i] == y[m]] * inv[m]
// so each window's cotangent is split equally among its tied maxima (a
// stock max-pool backward gives it all to one of them). Along an axis the
// windows holding input i are m in [ceil((i + p - w + 1) / 2), floor((i +
// p) / 2)] within [0, out); the sum runs in float32 over descending md, then
// mh, then mw (the TPU form's ascending offset order) and is rounded once
// to x's type. The indicator multiplies inv (0 * inf is NaN), so a window
// whose maximum is NaN spreads NaN. No atomics: two launches are
// bit-identical. In float32 this is the TPU form's arithmetic; in bf16 /
// fp16 that form rounds inv and every partial sum, here they are rounded
// once.
//
// What bounds it: HBM bytes. x, y and g read once and dx written once; a
// few compares and adds an element are far below the card's rates. At the
// ResNet-18 stem pool (8, 46, 55, 46, 64) in bf16 that is 268.7 MB, 0.080
// ms at 3.35 TB/s (chip_smoke.py phase 21 computes it from the tensors).
//
// Design: one launch, nothing but dx written to device memory. The wrapper
// (ops/pool.py::k4_geometry) computes the launch geometry and passes it in
// `Geo`; each CTA decodes blockIdx once, its threads run along C in 16-byte
// units (8 bf16 / fp16 or 4 float32 channels; a C that is not a multiple,
// or an unaligned tensor, takes one-element units), and the window loops
// are unrolled for w = 2, 3, 4 (template argument; 0 runs any window).
// Both paths cut the input into blocks: along an axis, block m holds the
// inputs whose last window is m, i in {2m - p, 2m - p + 1}; its windows are
// m - ceil(w / 2) + 1 .. m, and input 2m - p + j is in window m - a for a
// <= (w - 1 - j) / 2, a fixed pattern for a fixed w.
// - w <= 2 ("direct"): windows do not overlap, each input is in at most one
//   of them. A thread takes a 2x2x2 block, counts in registers and writes
//   the block's dx: each byte read and written once.
// - w >= 3 ("staged"): a CTA owns a patch of th x tw blocks in (H, W), one
//   batch row, one group of nv units of C, and a chunk of kd block planes
//   along D, which it marches through window plane by window plane. It
//   stages in shared memory, by 16-byte cp.async, a ring of w + 2 x planes
//   of the patch with its halo (the box its windows read; positions
//   outside the volume hold NaN, which equals nothing, so padding never
//   counts), and rings of the windows' y and g planes; plane md + 1 is
//   copied while plane md is computed. For each window plane it computes
//   count and inv into a float32 ring in shared memory (each window's
//   floats in 16-byte chunks, chunk-major), then writes dx of block plane
//   md: a thread takes the 2 x 2 inputs of one plane of a block and walks
//   the block's windows once, adding each to the inputs it holds, so every
//   y and inv is read once for up to four inputs. x rows are stored by
//   column parity, so that the stride-2 window reads of neighbouring
//   threads hit neighbouring banks. Windows on a patch or chunk edge are
//   computed by both CTAs from the same values, so the result does not
//   depend on the tiling.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ops/_build.py);
// bound with ctypes through the extern "C" entry points at the end.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // shared memory a block may use on sm_90

// The launch geometry, field for field as ops/pool.py::GEO_FIELDS.
struct Geo {
  int b, d, h, w, c;                  // input
  int od, oh, ow;                     // output
  int window, padding;
  int vec, cvec, nv, lg_nv, groups;   // channels a unit, units a position, units a group
  int th, tw, kd, nph, npw, ncd;      // staged: blocks of a patch and a D-chunk, their counts
  int wlo;                            // staged: a block's first window, m + wlo
  int nwh, nww, xh, xw, xws;          // staged: windows and x box of a patch
  int nxs, nys, nis;                  // staged: x, y and inv ring slots
  int ext_d, ext_h, ext_w, ncol;      // input blocks; direct: column chunks
  int threads, grid, smem, off_y, off_g, off_inv;
};

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

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() { return __int_as_float(0x7fc00000); }
template <>
__device__ __forceinline__ __nv_bfloat16 quiet_nan<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0x7fc0);
}
template <>
__device__ __forceinline__ __half quiet_nan<__half>() { return __ushort_as_half(0x7e00); }

// A unit: 16 bytes of channels, or one element.
template <typename T, bool kVec>
struct Lanes {
  using U = uint4;
  static constexpr int kN = 16 / sizeof(T);
};
template <typename T>
struct Lanes<T, false> {
  using U = T;
  static constexpr int kN = 1;
};

// (u is taken by value: one 16-byte load, not one load a lane)
template <typename T, bool kVec>
__device__ __forceinline__ void unpack(const typename Lanes<T, kVec>::U u,
                                       float (&f)[Lanes<T, kVec>::kN]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < Lanes<T, kVec>::kN; ++j) f[j] = to_f32(e[j]);
}

// bf16 -> float32 is a 16-bit shift: two instructions a channel pair
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16, true>(const uint4 u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ typename Lanes<T, kVec>::U pack(const float (&f)[Lanes<T, kVec>::kN]) {
  typename Lanes<T, kVec>::U u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < Lanes<T, kVec>::kN; ++j) e[j] = from_f32<T>(f[j]);
  return u;
}

template <typename T, bool kVec>
__device__ __forceinline__ typename Lanes<T, kVec>::U nan_unit() {
  typename Lanes<T, kVec>::U u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < Lanes<T, kVec>::kN; ++j) e[j] = quiet_nan<T>();
  return u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Global -> shared: 16-byte units by cp.async, single elements by a load.
template <typename T, bool kVec>
__device__ __forceinline__ void copy_unit(typename Lanes<T, kVec>::U* dst,
                                          const typename Lanes<T, kVec>::U* src) {
  if constexpr (kVec)
    cp_async16(dst, src);
  else
    *dst = *src;
}

// Counts, per channel of a unit, the x units equal to the window's maximum.
template <typename T, bool kVec, bool kPacked>
struct Counter {
  static constexpr int kN = Lanes<T, kVec>::kN;
  float y[kN], n[kN];
  __device__ __forceinline__ explicit Counter(const typename Lanes<T, kVec>::U yu) {
    unpack<T, kVec>(yu, y);
#pragma unroll
    for (int j = 0; j < kN; ++j) n[j] = 0.f;
  }
  __device__ __forceinline__ void add(const typename Lanes<T, kVec>::U xu) {
    float xv[kN];
    unpack<T, kVec>(xu, xv);
#pragma unroll
    for (int j = 0; j < kN; ++j) n[j] += xv[j] == y[j] ? 1.f : 0.f;
  }
  __device__ __forceinline__ void get(float (&out)[kN]) const {
#pragma unroll
    for (int j = 0; j < kN; ++j) out[j] = n[j];
  }
};

template <typename T>
struct PairOf;
template <>
struct PairOf<__nv_bfloat16> {
  using P = __nv_bfloat162;
};
template <>
struct PairOf<__half> {
  using P = __half2;
};

// bf16 / fp16 units at a fixed window <= 4: channel pairs compared and
// counted in the type (counts <= 64, exact in both).
template <typename T>
struct Counter<T, true, true> {
  using P = typename PairOf<T>::P;
  P y[4], n[4];
  __device__ __forceinline__ explicit Counter(const uint4 yu) {
    const P* v = reinterpret_cast<const P*>(&yu);
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    const P* zero = reinterpret_cast<const P*>(&z);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      y[k] = v[k];
      n[k] = zero[k];
    }
  }
  __device__ __forceinline__ void add(const uint4 xu) {
    const P* v = reinterpret_cast<const P*>(&xu);
#pragma unroll
    for (int k = 0; k < 4; ++k) n[k] = __hadd2(n[k], __heq2(v[k], y[k]));
  }
  __device__ __forceinline__ void get(float (&out)[8]) const {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T* e = reinterpret_cast<const T*>(&n[k]);
      out[2 * k] = to_f32(e[0]);
      out[2 * k + 1] = to_f32(e[1]);
    }
  }
};

template <int kC>
__device__ __forceinline__ void load_chunk(const float* p, float* o) {
  if constexpr (kC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < kC; ++e) o[e] = p[e];
  }
}

template <int kC>
__device__ __forceinline__ void store_chunk(float* p, const float* v) {
  if constexpr (kC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kC; ++e) p[e] = v[e];
  }
}

// Calls f(row, col) over a rows x cols grid, this thread's cells from flat
// index `first` in steps of `step`; the divisions are done once, here.
struct Walk {
  int row, col, drow, dcol;
};
__device__ __forceinline__ Walk walk(int cols, int first, int step) {
  const int row = first / cols, drow = step / cols;
  return {row, first - row * cols, drow, step - drow * cols};
}
template <typename F>
__device__ __forceinline__ void for_grid(const Walk& wk, int rows, int cols, F&& f) {
  int row = wk.row, col = wk.col;
  while (row < rows) {
    f(row, col);
    row += wk.drow;
    col += wk.dcol;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
}

// A thread's columns of a rows x cols grid: col0, col0 + dcol, ... (past
// cols: none), each down rows row0, row0 + drow, ...; the column's share
// of an address is then computed once for all its rows.
struct ColWalk {
  int col0, dcol, row0, drow;
};
__device__ __forceinline__ ColWalk col_walk(int cols, int tid, int nt) {
  if (nt < cols) return {tid, nt, 0, 1};
  const int rows_a_pass = nt / cols;
  return {tid < rows_a_pass * cols ? tid % cols : cols, cols, tid / cols, rows_a_pass};
}

// w <= 2: one thread an input block (the inputs whose last window is m).
template <typename T, int kW, bool kVec>
__device__ __forceinline__ void direct_body(const T* __restrict__ x, const T* __restrict__ y,
                                            const T* __restrict__ g, T* __restrict__ dx,
                                            const Geo& s) {
  using U = typename Lanes<T, kVec>::U;
  constexpr int kN = Lanes<T, kVec>::kN;
  constexpr bool kPacked = kVec && sizeof(T) == 2 && kW != 0;
  const int win = kW ? kW : s.window;
  int r = blockIdx.x;
  const int chunk = r % s.ncol;
  r /= s.ncol;
  const int mh = r % s.ext_h;
  r /= s.ext_h;
  const int md = r % s.ext_d;
  const int b = r / s.ext_d;
  const int col = chunk * s.threads + static_cast<int>(threadIdx.x);
  if (col >= s.ext_w * s.cvec) return;
  const int mw = col / s.cvec, u = col - mw * s.cvec;
  const U* xu = reinterpret_cast<const U*>(x);
  const U* yu = reinterpret_cast<const U*>(y);
  const U* gu = reinterpret_cast<const U*>(g);
  U* du = reinterpret_cast<U*>(dx);
  const int i0d = 2 * md - s.padding, i0h = 2 * mh - s.padding, i0w = 2 * mw - s.padding;
  const bool real = md < s.od && mh < s.oh && mw < s.ow;
  U xv[2][2][2];
  bool in[2][2][2];
#pragma unroll
  for (int jd = 0; jd < 2; ++jd)
#pragma unroll
    for (int jh = 0; jh < 2; ++jh)
#pragma unroll
      for (int jw = 0; jw < 2; ++jw) {
        const int id = i0d + jd, ih = i0h + jh, iw = i0w + jw;
        in[jd][jh][jw] = id >= 0 && id < s.d && ih >= 0 && ih < s.h && iw >= 0 && iw < s.w;
        if (in[jd][jh][jw]) xv[jd][jh][jw] = xu[((b * s.d + id) * s.h + ih) * s.w * s.cvec +
                                                iw * s.cvec + u];
      }
  float inv[kN], yf[kN];
  if (real) {
    const int m = (((b * s.od + md) * s.oh + mh) * s.ow + mw) * s.cvec + u;
    Counter<T, kVec, kPacked> cnt(yu[m]);
#pragma unroll
    for (int jd = 0; jd < 2; ++jd)
#pragma unroll
      for (int jh = 0; jh < 2; ++jh)
#pragma unroll
        for (int jw = 0; jw < 2; ++jw)
          if (jd < win && jh < win && jw < win && in[jd][jh][jw]) cnt.add(xv[jd][jh][jw]);
    float n[kN], gv[kN];
    cnt.get(n);
    unpack<T, kVec>(gu[m], gv);
    unpack<T, kVec>(yu[m], yf);
#pragma unroll
    for (int j = 0; j < kN; ++j) inv[j] = __fdiv_rn(gv[j], n[j]);
  }
#pragma unroll
  for (int jd = 0; jd < 2; ++jd)
#pragma unroll
    for (int jh = 0; jh < 2; ++jh)
#pragma unroll
      for (int jw = 0; jw < 2; ++jw) {
        if (!in[jd][jh][jw]) continue;
        float acc[kN];
#pragma unroll
        for (int j = 0; j < kN; ++j) acc[j] = 0.f;
        if (real && jd < win && jh < win && jw < win) {
          float xf[kN];
          unpack<T, kVec>(xv[jd][jh][jw], xf);
#pragma unroll
          for (int j = 0; j < kN; ++j) acc[j] += (xf[j] == yf[j] ? 1.f : 0.f) * inv[j];
        }
        du[((b * s.d + i0d + jd) * s.h + i0h + jh) * s.w * s.cvec + (i0w + jw) * s.cvec + u] =
            pack<T, kVec>(acc);
      }
}

// w >= 3: a CTA marches a patch of input blocks through its D-chunk.
template <typename T, int kW, bool kVec>
__device__ __forceinline__ void staged_body(const T* __restrict__ x, const T* __restrict__ y,
                                            const T* __restrict__ g, T* __restrict__ dx,
                                            const Geo& s) {
  using U = typename Lanes<T, kVec>::U;
  constexpr int kN = Lanes<T, kVec>::kN;
  constexpr int kC = kN < 4 ? kN : 4;  // inv floats a chunk (one float4)
  constexpr int kQ = kN / kC;          // inv chunks a unit
  constexpr bool kPacked = kVec && sizeof(T) == 2 && kW != 0;
  extern __shared__ __align__(16) unsigned char smem[];
  U* xs = reinterpret_cast<U*>(smem);
  U* ys = reinterpret_cast<U*>(smem + s.off_y);
  U* gs = reinterpret_cast<U*>(smem + s.off_g);
  float* is = reinterpret_cast<float*>(smem + s.off_inv);
  const U* xu = reinterpret_cast<const U*>(x);
  const U* yu = reinterpret_cast<const U*>(y);
  const U* gu = reinterpret_cast<const U*>(g);
  U* du = reinterpret_cast<U*>(dx);
  const int win = kW ? kW : s.window;
  const int aw = (win + 1) / 2;  // a block's windows along an axis: m - aw + 1 .. m
  const int pad = s.padding;

  int r = blockIdx.x;
  const int grp = r % s.groups;
  r /= s.groups;
  const int pw = r % s.npw;
  r /= s.npw;
  const int ph = r % s.nph;
  r /= s.nph;
  const int cd = r % s.ncd;
  const int b = r / s.ncd;
  const int nvg = min(s.nv, s.cvec - grp * s.nv);  // units of this group
  const int unit0 = grp * s.nv;
  const int bh0 = ph * s.th, bw0 = pw * s.tw;                // the patch's first block
  const int mh0 = bh0 + s.wlo, mw0 = bw0 + s.wlo;            // its first window
  const int xh0 = 2 * mh0 - pad, xw0 = 2 * mw0 - pad;        // its first staged row, column
  const int k0 = cd * s.kd, k1 = min(k0 + s.kd, s.ext_d);    // the chunk's block planes
  const int mstart = max(0, k0 + s.wlo), mend = min(s.od - 1, k1 - 1);
  const int lg = s.lg_nv, nvm = s.nv - 1;
  const int x_plane = s.xh * 2 * s.xws * s.nv;  // units of an x slot
  const int w_plane = s.nwh * s.nww * s.nv;     // units of a y / g slot (inv: floats / kN)
  const int x_cols = s.xw << lg, w_cols = s.nww << lg, f_cols = s.tw << lg;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Walk ww = walk(w_cols, tid, nt), wf = walk(f_cols, tid, nt);
  const ColWalk cx = col_walk(x_cols, tid, nt), cw = col_walk(w_cols, tid, nt);

  // Calls f(d, jd, mh, mw, u) for each (input plane of block plane bd, block
  // of the patch, unit) of this thread whose plane is in the volume.
  auto for_blocks = [&](int bd, auto&& f) {
    for_grid(wf, 2 * s.th, f_cols, [&](int row, int col) {
      const int jd = row & 1, mh = bh0 + (row >> 1), mw = bw0 + (col >> lg), u = col & nvm;
      const int d = 2 * bd - pad + jd;
      if (u < nvg && d >= 0 && d < s.d && mh < s.ext_h && mw < s.ext_w) f(d, jd, mh, mw, u);
    });
  };
  // dx of a block's 2 x 2 inputs of plane d (rows 2 mh - p + jh, cols 2 mw - p + jw)
  auto store = [&](int d, int mh, int mw, int u, const float (&acc)[2][2][kN]) {
#pragma unroll
    for (int jh = 0; jh < 2; ++jh)
#pragma unroll
      for (int jw = 0; jw < 2; ++jw) {
        const int ih = 2 * mh - pad + jh, iw = 2 * mw - pad + jw;
        if (ih >= 0 && ih < s.h && iw >= 0 && iw < s.w)
          du[((b * s.d + d) * s.h + ih) * s.w * s.cvec + iw * s.cvec + unit0 + u] =
              pack<T, kVec>(acc[jh][jw]);
      }
  };

  if (mstart > mend) {  // no window holds any input of this chunk
    float zero[2][2][kN];
#pragma unroll
    for (int jh = 0; jh < 2; ++jh)
#pragma unroll
      for (int jw = 0; jw < 2; ++jw)
#pragma unroll
        for (int j = 0; j < kN; ++j) zero[jh][jw][j] = 0.f;
    for (int bd = k0; bd < k1; ++bd)
      for_blocks(bd, [&](int d, int, int mh, int mw, int u) { store(d, mh, mw, u, zero); });
    return;
  }

  // x plane xd into its ring slot; NaN outside the volume (it equals nothing)
  auto stage_x = [&](int xd) {
    U* dst = xs + ((xd % s.nxs + s.nxs) % s.nxs) * x_plane;
    const bool d_in = xd >= 0 && xd < s.d;
    const U* src = xu + (b * s.d + xd) * s.h * s.w * s.cvec + unit0;
    for (int col = cx.col0; col < x_cols; col += cx.dcol) {
      const int j = col >> lg, u = col & nvm, gw = xw0 + j;
      if (u >= nvg) continue;
      const bool col_in = d_in && gw >= 0 && gw < s.w;
      U* to = dst + ((j & 1) * s.xws + (j >> 1)) * s.nv + u;
      const U* from = src + gw * s.cvec + u;
      for (int row = cx.row0; row < s.xh; row += cx.drow) {
        const int gh = xh0 + row;
        if (col_in && gh >= 0 && gh < s.h)
          copy_unit<T, kVec>(to + row * 2 * s.xws * s.nv, from + gh * s.w * s.cvec);
        else
          to[row * 2 * s.xws * s.nv] = nan_unit<T, kVec>();
      }
    }
  };
  // y and g of window plane md into their ring slots (windows of the volume only)
  auto stage_yg = [&](int md) {
    U* yd = ys + (md % s.nys) * w_plane;
    U* gd = gs + (md & 1) * w_plane;
    const int plane = (b * s.od + md) * s.oh * s.ow * s.cvec + unit0;
    for (int col = cw.col0; col < w_cols; col += cw.dcol) {
      const int j = col >> lg, u = col & nvm, mw = mw0 + j;
      if (u >= nvg || mw < 0 || mw >= s.ow) continue;
      for (int row = cw.row0; row < s.nwh; row += cw.drow) {
        const int mh = mh0 + row;
        if (mh < 0 || mh >= s.oh) continue;
        const int src = plane + (mh * s.ow + mw) * s.cvec + u;
        const int at = (row * s.nww + j) * s.nv + u;
        copy_unit<T, kVec>(yd + at, yu + src);
        copy_unit<T, kVec>(gd + at, gu + src);
      }
    }
  };
  // dx of block plane bd: a thread takes the 2 x 2 inputs of one of its
  // planes in one block, every window that holds them in the rings. The
  // windows run in descending (md, mh, mw) order and each adds to the
  // inputs it holds, so each input's sum runs in that order; along H, input
  // jh of block mh is in windows mh - a for a <= (w - 1 - jh) / 2. A window
  // outside the output holds y = NaN and inv = 0 (count writes them): it
  // adds 0 * 0 to a sum that is never -0, so no window needs a range check.
  // xsl: the x slot of plane 2 bd - p; ysl, isl: the y, inv slots of
  // window plane min(bd, od - 1).
  auto finalize = [&](int bd, int xsl, int ysl, int isl) {
    const int d_hi = min(bd, s.od - 1);
    const int d0 = 2 * bd - pad;
    const int xsl1 = xsl + 1 == s.nxs ? 0 : xsl + 1;
    const int d_lo0 = max((d0 + pad - win + 2) >> 1, 0);
    const int d_lo1 = max((d0 + 1 + pad - win + 2) >> 1, 0);
    for_blocks(bd, [&](int d, int jd, int mh, int mw, int u) {
      const int rh = 2 * (mh - mh0), rw = mw - mw0;  // box row of jh = 0, half-column
      const int at0 = (mh - mh0) * s.nww + rw;       // the block's last window
      const U* xp = xs + (jd ? xsl1 : xsl) * x_plane;
      const int n_d = d_hi - (jd ? d_lo1 : d_lo0);   // windows along D, less one
      float xf[2][2][kN], acc[2][2][kN];
#pragma unroll
      for (int jh = 0; jh < 2; ++jh)
#pragma unroll
        for (int jw = 0; jw < 2; ++jw) {
          unpack<T, kVec>(xp[(((rh + jh) * 2 + jw) * s.xws + rw) * s.nv + u], xf[jh][jw]);
#pragma unroll
          for (int j = 0; j < kN; ++j) acc[jh][jw][j] = 0.f;
        }
      int ys_ = ysl, is_ = isl;
#pragma unroll
      for (int ad = 0; ad < aw; ++ad) {
        if (ad > n_d) break;
        const U* yp = ys + ys_ * w_plane + u;
        const float* ip = is + is_ * w_plane * kN + u * kC;
#pragma unroll
        for (int ah = 0; ah < aw; ++ah)
#pragma unroll
          for (int awi = 0; awi < aw; ++awi) {
            const int at = at0 - ah * s.nww - awi;
            float yf[kN], iv[kN];
            unpack<T, kVec>(yp[at * s.nv], yf);
#pragma unroll
            for (int q = 0; q < kQ; ++q)
              load_chunk<kC>(ip + (q * s.nwh * s.nww + at) * s.nv * kC, iv + q * kC);
#pragma unroll
            for (int jh = 0; jh < 2; ++jh)
#pragma unroll
              for (int jw = 0; jw < 2; ++jw)
                if (2 * ah <= win - 1 - jh && 2 * awi <= win - 1 - jw) {
#pragma unroll
                  for (int j = 0; j < kN; ++j)
                    acc[jh][jw][j] += (xf[jh][jw][j] == yf[j] ? 1.f : 0.f) * iv[j];
                }
          }
        ys_ = ys_ == 0 ? s.nys - 1 : ys_ - 1;
        is_ = is_ == 0 ? s.nis - 1 : is_ - 1;
      }
      store(d, mh, mw, u, acc);
    });
  };

  for (int xd = 2 * mstart - pad; xd < 2 * mstart - pad + win; ++xd) stage_x(xd);
  stage_yg(mstart);
  cp_async_commit();
  // ring slots of window plane md: its first x plane 2 md - p, its y, its inv
  int xsm = ((2 * mstart - pad) % s.nxs + s.nxs) % s.nxs;
  int ysm = mstart % s.nys, ism = mstart % s.nis;
  for (int md = mstart; md <= mend; ++md) {
    cp_async_wait_all();
    __syncthreads();  // plane md staged; every thread is done with plane md - 1
    if (md < mend) {  // copy plane md + 1 into the slots plane md - 1 held
      const int last = 2 * (md + 1) - pad + win - 1;
      for (int xd = max(2 * (md + 1) - pad, last - 1); xd <= last; ++xd) stage_x(xd);
      stage_yg(md + 1);
      cp_async_commit();
    }
    // count and inv of window plane md; windows outside the output get y =
    // NaN and inv = 0 for the finalize
    U* yp = ys + ysm * w_plane;
    const U* gp = gs + (md & 1) * w_plane;
    float* ip = is + ism * w_plane * kN;
    for_grid(ww, s.nwh, w_cols, [&](int row, int col) {
      const int j = col >> lg, u = col & nvm;
      const int mh = mh0 + row, mw = mw0 + j;
      if (u >= nvg) return;
      const int at = (row * s.nww + j) * s.nv + u;
      float iv[kN];
      if (mh < 0 || mh >= s.oh || mw < 0 || mw >= s.ow) {
        yp[at] = nan_unit<T, kVec>();
#pragma unroll
        for (int jj = 0; jj < kN; ++jj) iv[jj] = 0.f;
      } else {
        Counter<T, kVec, kPacked> cnt(yp[at]);
        int sl = xsm;
#pragma unroll
        for (int od = 0; od < win; ++od) {
          const U* pl = xs + sl * x_plane;
#pragma unroll
          for (int oh = 0; oh < win; ++oh) {
            const U* rw = pl + (2 * row + oh) * 2 * s.xws * s.nv;
#pragma unroll
            for (int ow = 0; ow < win; ++ow)
              cnt.add(rw[((ow & 1) * s.xws + j + (ow >> 1)) * s.nv + u]);
          }
          sl = sl + 1 == s.nxs ? 0 : sl + 1;
        }
        float n[kN], gv[kN];
        cnt.get(n);
        unpack<T, kVec>(gp[at], gv);
#pragma unroll
        for (int jj = 0; jj < kN; ++jj) iv[jj] = __fdiv_rn(gv[jj], n[jj]);
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        store_chunk<kC>(ip + ((q * s.nwh * s.nww + row * s.nww + j) * s.nv + u) * kC,
                        iv + q * kC);
    });
    __syncthreads();  // inv of plane md written
    // the chunk's block planes whose last window plane is md
    const int bd_last = md == s.od - 1 ? s.ext_d - 1 : md, bd0 = max(md, k0);
    for (int bd = bd0, xsl = (xsm + 2 * (bd0 - md)) % s.nxs; bd <= min(bd_last, k1 - 1); ++bd) {
      finalize(bd, xsl, ysm, ism);
      xsl = xsl + 2 >= s.nxs ? xsl + 2 - s.nxs : xsl + 2;
    }
    xsm = xsm + 2 >= s.nxs ? xsm + 2 - s.nxs : xsm + 2;
    ysm = ysm + 1 == s.nys ? 0 : ysm + 1;
    ism = ism + 1 == s.nis ? 0 : ism + 1;
  }
}

template <typename T, int kW, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 2)
max_pool_backward(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ g,
                  T* __restrict__ dx, const Geo s) {
  if constexpr (kW == 2) {
    direct_body<T, kW, kVec>(x, y, g, dx, s);
  } else if constexpr (kW >= 3) {
    staged_body<T, kW, kVec>(x, y, g, dx, s);
  } else {
    if (s.window <= 2)
      direct_body<T, 0, kVec>(x, y, g, dx, s);
    else
      staged_body<T, 0, kVec>(x, y, g, dx, s);
  }
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, T*, const Geo);

// The kernel of a window and a unit: unrolled for w = 2, 3, 4 in 16-byte
// units, the generic one otherwise; null for a unit of another width.
template <typename T>
Kernel<T> pick(int window, int vec) {
  if (vec == 1) return max_pool_backward<T, 0, false>;
  if (vec != static_cast<int>(16 / sizeof(T))) return nullptr;
  switch (window) {
    case 2: return max_pool_backward<T, 2, true>;
    case 3: return max_pool_backward<T, 3, true>;
    case 4: return max_pool_backward<T, 4, true>;
    default: return max_pool_backward<T, 0, true>;
  }
}

// The kernel of (window, vec), allowed `smem` bytes of dynamic shared memory.
template <typename T>
cudaError_t prepare(int window, int vec, int smem, Kernel<T>* kernel) {
  *kernel = pick<T>(window, vec);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* g, void* dx, const Geo& s,
                   cudaStream_t stream) {
  Kernel<T> kernel;
  const cudaError_t err = prepare<T>(s.window, s.vec, s.smem, &kernel);
  if (err != cudaSuccess) return err;
  kernel<<<s.grid, s.threads, s.smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(y),
                                                static_cast<const T*>(g), static_cast<T*>(dx), s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t blocks_per_sm(int window, int vec, int threads, int smem, int* blocks) {
  Kernel<T> kernel;
  const cudaError_t err = prepare<T>(window, vec, smem, &kernel);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16, for x, y, g and dx alike. x and
// dx are contiguous (b, d, h, w, c), y and g contiguous (b, od, oh, ow, c);
// with 16-byte units (geo vec > 1) all four are 16-byte aligned. `geo`
// holds n_geo ints, the fields of Geo in order (ops/pool.py::k4_geometry);
// every element count below 2^31 (the wrapper checks). Launches the one
// kernel on `stream` of `device`, does not synchronise, and returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int mad_max_pool_backward(const void* x, const void* y, const void* g, int dtype,
                                     const int* geo, int n_geo, void* dx, int device,
                                     void* stream) {
  if (geo == nullptr || n_geo != static_cast<int>(sizeof(Geo) / sizeof(int)))
    return static_cast<int>(cudaErrorInvalidValue);
  Geo s;
  memcpy(&s, geo, sizeof(Geo));
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_in = static_cast<long long>(s.b) * s.d * s.h * s.w * s.c;
  const long long n_out = static_cast<long long>(s.b) * s.od * s.oh * s.ow * s.c;
  if (s.b <= 0 || s.c <= 0 || s.od <= 0 || s.oh <= 0 || s.ow <= 0 || s.window <= 0 ||
      s.padding < 0 || s.padding >= s.window || n_in >= (1LL << 31) || n_out >= (1LL << 31) ||
      s.vec <= 0 || s.c % s.vec != 0 || s.cvec != s.c / s.vec || s.threads <= 0 ||
      s.threads > kMaxThreads || s.grid <= 0 || s.smem < 0 || s.smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch<float>(x, y, g, dx, s, st); break;
    case 1: err = launch<__nv_bfloat16>(x, y, g, dx, s, st); break;
    case 2: err = launch<__half>(x, y, g, dx, s, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The blocks of `threads` threads and `smem` bytes of dynamic shared memory
// that one SM of `device` holds of the kernel that a launch of (dtype,
// window, vec) runs, registers counted (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// into *blocks; returns 0 on success.
extern "C" int mad_max_pool_blocks_per_sm(int dtype, int window, int vec, int threads, int smem,
                                          int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks == nullptr || threads <= 0 || threads > kMaxThreads || smem < 0 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: err = blocks_per_sm<float>(window, vec, threads, smem, blocks); break;
    case 1: err = blocks_per_sm<__nv_bfloat16>(window, vec, threads, smem, blocks); break;
    case 2: err = blocks_per_sm<__half>(window, vec, threads, smem, blocks); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* mad_max_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
