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
// and added once (one add per element read, far below the card's float32
// rate). At the extraction shape (B = 8, C = 64, f32, the 166-ROI 2-mm
// atlas's 587,762 labelled voxels) that is 1,204 MB, 0.36 ms at 3.35 TB/s;
// background voxels are never read (chip_smoke.py::k2_bound_ms).
//
// Design: a plan of balanced tiles of contiguous z-runs, built once per
// atlas (ops/roi_pool.py::RoiAtlas): the label-sorted voxels of each ROI
// are cut into tiles of at most T voxels that never cross an ROI, and each
// tile into runs, spans of consecutive z in one (x, y) row. A run is one
// contiguous span of len * C elements in the dense map and in the U-Net's
// tap (a channels-last crop of a padded map), so it is decoded once and
// moved whole.
//   pass 1, grid (tiles, B): each block sums one tile of one batch item
//     into an f32 partial of C values in a (B, tiles, C) scratch.
//     - bulk path (unit channel stride, voxel stride C, 16-byte aligned
//       rows of whole 16-byte vectors): a producer warp stages the tile's
//       run descriptors in shared memory and one of its threads moves the
//       runs with TMA 1-D bulk copies (cp.async.bulk ... mbarrier::complete_tx)
//       into a ring of kStages 16 KB stages, one full and one empty
//       mbarrier per stage; four consumer warps sum each stage from shared
//       memory with 16-byte reads, thread (g, q) taking the 16-byte column
//       q of voxels g, g + G, g + 2G, ...;
//     - SIMT path (any other layout): eight warps stride over the tile's
//       voxels, lanes over channels, with scalar loads through the strides.
//   pass 2, grid (R, B): each block sums its ROI's tile partials in tile
//     order and divides by max(count, 1e-6).
// Deterministic: no atomics; the tile plan, the stage cut, each thread's
// voxel sequence, the order of the group sums and the order of the tile
// sums are all fixed by the atlas, so two launches are bit-identical. The
// sums run in the plan's order, not the voxel order, so the means may
// differ in the last place from another order of summation.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ops/_build.py);
// bound with ctypes through the extern "C" entry points at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- bulk path ----
constexpr int kStageBytes = 16384;
constexpr int kStages = 4;
constexpr int kConsumerWarps = 4;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kBulkThreads = kConsumers + 32;  // + one producer warp
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kMaxRowBytes = kConsumers * 16;  // one 16-byte column per consumer
constexpr int kRunBuf = 256;  // run descriptors the producer warp stages at a time

// ---- SIMT path ----
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileC = 64;  // channels per block: two per lane
constexpr int kUnroll = 4;  // voxels loaded before they are added

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// TMA 1-D bulk copy global -> shared; completes `bytes` on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Adds one 16-byte column of a voxel's features to acc.
__device__ __forceinline__ void add16(float* acc, const unsigned char* p, float) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  acc[0] += v.x;
  acc[1] += v.y;
  acc[2] += v.z;
  acc[3] += v.w;
}

__device__ __forceinline__ void add16(float* acc, const unsigned char* p, __nv_bfloat16) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    acc[2 * i] += f.x;
    acc[2 * i + 1] += f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBulkThreads)
roi_tile_bulk(const T* __restrict__ feats, int channels, long long s_b, long long s_x,
              long long s_y, const int4* __restrict__ runs, const int* __restrict__ tile_runs,
              const int* __restrict__ tile_starts, int n_tiles, float* __restrict__ partial) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte column
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ int4 s_runs[kRunBuf];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = channels * static_cast<int>(sizeof(T));  // bytes per voxel
  const int per_stage = kStageBytes / row;                 // voxels per stage
  const int nvox = tile_starts[tile + 1] - tile_starts[tile];
  const int n_stages = (nvox + per_stage - 1) / per_stage;
  const int cols = row / 16;            // 16-byte columns per voxel
  const int groups = kConsumers / cols;  // voxels summed side by side
  const int q = threadIdx.x % cols, g = threadIdx.x / cols;
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer warp: it stages the tile's run descriptors in shared memory,
    // kRunBuf at a time, so no copy waits on a global load; lane 0 issues
    // the copies, and every lane walks the same runs
    const T* base = feats + static_cast<long long>(b) * s_b;
    const int r_end = tile_runs[tile + 1];
    int buf = tile_runs[tile];  // index of the run in s_runs[0]
    auto stage_runs = [&]() {
      for (int i = lane; i < min(kRunBuf, r_end - buf); i += 32) s_runs[i] = runs[buf + i];
      __syncwarp();
    };
    stage_runs();
    int r = buf;
    int4 run = s_runs[0];
    int used = 0;  // voxels of `run` already copied
    for (int k = 0; k < n_stages; ++k) {
      const int s = k % kStages;
      if (k >= kStages) mbar_wait(&empty[s], ((k / kStages) - 1) & 1);
      const int want = min(per_stage, nvox - k * per_stage);
      if (lane == 0) mbar_expect_tx(&full[s], want * row);
      unsigned char* dst = ring + s * kStageBytes;
      for (int filled = 0; filled < want;) {
        if (used == run.w) {
          if (++r - buf == kRunBuf) {
            __syncwarp();  // every lane has read s_runs
            buf = r;
            stage_runs();
          }
          run = s_runs[r - buf];
          used = 0;
        }
        const int take = min(want - filled, run.w - used);
        if (lane == 0) {
          const T* src = base + run.x * s_x + run.y * s_y +
                         static_cast<long long>(run.z + used) * channels;
          bulk_copy(dst + filled * row, src, take * row, &full[s]);
        }
        filled += take;
        used += take;
      }
    }
  } else {  // consumers, in fixed voxel order
    for (int k = 0; k < n_stages; ++k) {
      const int s = k % kStages;
      mbar_wait(&full[s], (k / kStages) & 1);
      const int cnt = min(per_stage, nvox - k * per_stage);
      if (g < groups) {
        const unsigned char* p = ring + s * kStageBytes + q * 16;
        for (int v = g; v < cnt; v += groups) add16(acc, p + v * row, T());
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }
  __syncthreads();  // every stage consumed: the ring is free for the group sums
  float* red = reinterpret_cast<float*>(ring);  // [groups][channels]
  if (threadIdx.x < kConsumers && g < groups) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) red[g * channels + q * kVec + i] = acc[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < channels; c += kBulkThreads) {
    float sum = 0.0f;
    for (int gg = 0; gg < groups; ++gg) sum += red[gg * channels + c];
    partial[(static_cast<long long>(b) * n_tiles + tile) * channels + c] = sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_tile_simt(const T* __restrict__ feats, int channels, long long s_b, long long s_x,
              long long s_y, long long s_z, long long s_c, const int4* __restrict__ runs,
              const int* __restrict__ tile_runs, int n_tiles, float* __restrict__ partial) {
  __shared__ float part[kWarps][kTileC];
  const int tile = blockIdx.x, b = blockIdx.y, c0 = blockIdx.z * kTileC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool va = c0 + lane < channels, vb = c0 + 32 + lane < channels;
  const long long oa = static_cast<long long>(c0 + lane) * s_c;
  const long long ob = static_cast<long long>(c0 + 32 + lane) * s_c;
  const T* base = feats + static_cast<long long>(b) * s_b;
  float acc_a = 0.0f, acc_b = 0.0f;
  int pos = 0;  // tile-relative index of the run's first voxel
  for (int r = tile_runs[tile], r_end = tile_runs[tile + 1]; r < r_end; ++r) {
    const int4 run = runs[r];
    const T* p0 = base + run.x * s_x + run.y * s_y + static_cast<long long>(run.z) * s_z;
    int i = (warp - pos) & (kWarps - 1);  // warp w takes tile voxels w, w + 8, ...
    for (; i + (kUnroll - 1) * kWarps < run.w; i += kUnroll * kWarps) {
      float xa[kUnroll], xb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* p = p0 + static_cast<long long>(i + u * kWarps) * s_z;
        xa[u] = va ? to_f32(p[oa]) : 0.0f;
        xb[u] = vb ? to_f32(p[ob]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // in voxel order
        acc_a += xa[u];
        acc_b += xb[u];
      }
    }
    for (; i < run.w; i += kWarps) {
      const T* p = p0 + static_cast<long long>(i) * s_z;
      acc_a += va ? to_f32(p[oa]) : 0.0f;
      acc_b += vb ? to_f32(p[ob]) : 0.0f;
    }
    pos += run.w;
  }
  part[warp][lane] = acc_a;
  part[warp][lane + 32] = acc_b;
  __syncthreads();
  if (threadIdx.x < kTileC && c0 + threadIdx.x < channels) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w][threadIdx.x];
    partial[(static_cast<long long>(b) * n_tiles + tile) * channels + c0 + threadIdx.x] = sum;
  }
}

__global__ void __launch_bounds__(128)
roi_finish(const float* __restrict__ partial, int n_tiles, int channels,
           const int* __restrict__ roi_tiles, const int* __restrict__ offsets, int num_rois,
           float* __restrict__ out) {
  const int r = blockIdx.x, b = blockIdx.y;
  const int t0 = roi_tiles[r], t1 = roi_tiles[r + 1];
  const float count = static_cast<float>(offsets[r + 1] - offsets[r]);
  const float* p = partial + static_cast<long long>(b) * n_tiles * channels;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    float sum = 0.0f;
    for (int t = t0; t < t1; ++t) sum += p[static_cast<long long>(t) * channels + c];
    out[(static_cast<long long>(b) * num_rois + r) * channels + c] = sum / fmaxf(count, 1e-6f);
  }
}

template <typename T>
cudaError_t launch(const void* feats, bool bulk, int batch, int channels, long long s_b,
                   long long s_x, long long s_y, long long s_z, long long s_c,
                   const int4* runs, const int* tile_runs, const int* tile_starts, int n_tiles,
                   const int* roi_tiles, const int* offsets, int num_rois, float* partial,
                   float* out, cudaStream_t stream) {
  const T* f = static_cast<const T*>(feats);
  cudaError_t err;
  if (n_tiles > 0) {
    if (bulk) {
      const long long row = static_cast<long long>(channels) * sizeof(T);
      if (s_c > 1 || (s_z != 0 && s_z != channels) || row % 16 != 0 || row > kMaxRowBytes ||
          reinterpret_cast<uintptr_t>(feats) % 16 != 0 ||
          (s_b * static_cast<long long>(sizeof(T))) % 16 != 0 ||
          (s_x * static_cast<long long>(sizeof(T))) % 16 != 0 ||
          (s_y * static_cast<long long>(sizeof(T))) % 16 != 0)
        return cudaErrorInvalidValue;
      constexpr int kDevices = 64;
      static bool ring_set[kDevices] = {};  // the ring's shared memory allowed, by device
      int device = 0;
      err = cudaGetDevice(&device);
      if (err != cudaSuccess) return err;
      if (device >= kDevices || !ring_set[device]) {
        err = cudaFuncSetAttribute(roi_tile_bulk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kRingBytes);
        if (err != cudaSuccess) return err;
        if (device < kDevices) ring_set[device] = true;
      }
      roi_tile_bulk<T><<<dim3(n_tiles, batch), kBulkThreads, kRingBytes, stream>>>(
          f, channels, s_b, s_x, s_y, runs, tile_runs, tile_starts, n_tiles, partial);
    } else {
      const dim3 grid(n_tiles, batch, (channels + kTileC - 1) / kTileC);
      roi_tile_simt<T><<<grid, kThreads, 0, stream>>>(f, channels, s_b, s_x, s_y, s_z, s_c,
                                                       runs, tile_runs, n_tiles, partial);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  roi_finish<<<dim3(num_rois, batch), 128, 0, stream>>>(partial, n_tiles, channels, roi_tiles,
                                                         offsets, num_rois, out);
  return cudaGetLastError();
}

}  // namespace

// feats_dtype: 0 float32, 1 bfloat16; bulk: 1 for the TMA path (its layout
// conditions are checked again here), 0 for the SIMT path. feats is
// (batch, x, y, z, channels) with element strides s_* (0 for an axis of
// size 1). The plan (ops/roi_pool.py::RoiAtlas): runs (P, 4) int32 x, y,
// z0, length; tile_runs and tile_starts (n_tiles + 1) int32; roi_tiles and
// offsets (num_rois + 1) int32. partial is a float32 scratch of batch *
// n_tiles * channels; out a contiguous float32 (batch, num_rois, channels).
// Launches pass 1 and pass 2 on `stream` of `device`, does not
// synchronise, and returns cudaGetLastError() of the launches (0 on
// success).
extern "C" int mad_roi_pool(const void* feats, int feats_dtype, int bulk, int batch,
                            int channels, long long s_b, long long s_x, long long s_y,
                            long long s_z, long long s_c, const void* runs,
                            const void* tile_runs, const void* tile_starts, int n_tiles,
                            const void* roi_tiles, const void* offsets, int num_rois,
                            void* partial, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || batch > 65535 || channels <= 0 || num_rois <= 0 || n_tiles < 0 ||
      (channels + kTileC - 1) / kTileC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* rn = static_cast<const int4*>(runs);
  const int* tr = static_cast<const int*>(tile_runs);
  const int* ts = static_cast<const int*>(tile_starts);
  const int* rt = static_cast<const int*>(roi_tiles);
  const int* off = static_cast<const int*>(offsets);
  float* pa = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  switch (feats_dtype) {
    case 0: err = launch<float>(feats, bulk != 0, batch, channels, s_b, s_x, s_y, s_z, s_c, rn, tr, ts, n_tiles, rt, off, num_rois, pa, o, st); break;
    case 1: err = launch<__nv_bfloat16>(feats, bulk != 0, batch, channels, s_b, s_x, s_y, s_z, s_c, rn, tr, ts, n_tiles, rt, off, num_rois, pa, o, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* mad_roi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
