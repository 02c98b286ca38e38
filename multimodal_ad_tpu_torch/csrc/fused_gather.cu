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
// tensor cores. At B = 8 of 902,629 voxels the bound is 21.7 MB / 3.35 TB/s
// = 6.5 us for uint8 -> bf16, 43.3 MB = 12.9 us for float32 -> bf16 and
// 57.8 MB = 17.2 us for float32 -> float32.
//
// Design: one launch; each volume is cut into slices, one block per slice,
// and each block keeps its slice in shared memory between reading it and
// writing it, so the source is read from HBM once. On the TPU a whole
// volume sits in VMEM for one grid step; on Hopper a block has at most
// 227 KB of shared memory, so the volume's min and max are folded across
// the blocks of its slices. Each block:
//   1. moves its slice's whole 16-byte vectors, from the slice's first
//      128-byte boundary, into shared memory with TMA 1-D bulk copies of
//      16 KB (one thread issues them, one mbarrier each), folding min and
//      max over each copy as it lands and over the unaligned head and tail
//      from global memory;
//   2. exchanges its (min, max) with the other blocks of its volume;
//   3. scales the slice out of shared memory and writes it with 16-byte
//      stores aligned on the output, in loops with no branch per element.
// Two ways to exchange, one template (its mode):
//   - cluster: one thread-block cluster of 16 blocks of 512 threads per
//     volume, launched with cudaLaunchKernelEx and a cluster dimension; the
//     blocks read each other's (min, max) in distributed shared memory
//     (map_shared_rank) after the cluster barrier. Taken where a volume's
//     slices fit two blocks per SM (uint8 and int16 volumes of 91x109x91)
//     and the card can run such a cluster.
//   - grid: one cooperative launch of 4 blocks of 256 threads per SM; a
//     volume gets 4 x SMs / B slices, the blocks write their (min, max) to
//     a scratch of 2 float2 per block and meet at a grid barrier
//     (cooperative_groups). Taken for float32 volumes: a 16-block cluster
//     holding one needs 16 free SMs of one GPC, the H100 runs only 7 such
//     clusters at once, and 8 volumes took two waves (PERF.md). A
//     batch larger than the grid runs in rounds (a third instantiation),
//     the scratch alternating halves.
// The block shapes and the 16 KB copies are the fastest measured
// (scripts/kernel_bench.py, PERF.md). Where a slice exceeds its
// block's shared memory (more than 8 float32 volumes, or larger volumes),
// the rest is read from global memory in step 1 and again, mostly from
// L2, in step 3.
//
// An index outside [0, n_vol) never reads memory: its output row is NaN.
// The Python wrapper range-checks indices that come from the host.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ops/_build.py);
// bound with ctypes through the extern "C" entry points at the end.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunkBytes = 16384;  // one bulk copy, one mbarrier
constexpr int kSmemPerSm = 233472;  // shared memory of one SM on sm_90
constexpr int kClusterSize = 16;    // blocks per volume in cluster mode (non-portable)
constexpr int kOverUnroll = 4;      // 16-byte loads in flight per thread beyond shared memory

// The kernel's modes: the exchange through a cluster, or through a grid
// barrier in one round or in several (a compile-time round count keeps
// the one-round loops as fast as a plain kernel's: PERF.md).
enum Mode { kCluster, kGrid, kGridRounds };

// Threads and blocks per SM of each mode (measured best on the H100,
// PERF.md), and the dynamic shared memory a block may then use: its share
// of the SM, less 1 KB the system keeps per block and 1 KB of static
// shared memory.
template <bool kIsCluster>
struct Shape {
  static constexpr int kThreads = kIsCluster ? 512 : 256;
  static constexpr int kBlocksPerSm = kIsCluster ? 2 : 4;
  static constexpr int kMaxDynSmem = kSmemPerSm / kBlocksPerSm - 2048;
};
constexpr int kMaxChunks = (Shape<true>::kMaxDynSmem + kChunkBytes - 1) / kChunkBytes;
static_assert(Shape<false>::kMaxDynSmem <= Shape<true>::kMaxDynSmem, "kMaxChunks covers all");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void warp_minmax(float& lo, float& hi) {
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// 16 bytes of output from 16 / sizeof(O) consecutive float32 results, as
// a streaming (evict-first) store: the output is not read again here, and
// float32 output was measured faster so (PERF.md).
__device__ __forceinline__ void store16(float* o, const float* y) {
  __stcs(reinterpret_cast<float4*>(o), make_float4(y[0], y[1], y[2], y[3]));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store16(__nv_bfloat16* o, const float* y) {
  __stcs(reinterpret_cast<uint4*>(o), make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]),
                                                 pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7])));
}

__device__ __forceinline__ void store1(float* o, float y) { *o = y; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float y) { *o = __float2bfloat16_rn(y); }

// Output vectors j in [j0, j1): elements o[j * kOut + k] from x[j * kOut + k]
// (shared or global memory), scaled. The pointers do not alias, so the
// compiler may load ahead of the stores.
template <int kThreads, typename T, typename O>
__device__ __forceinline__ void scale_vectors(const T* __restrict__ x, O* __restrict__ o,
                                              int j0, int j1, float lo, float scale) {
  constexpr int kOut = 16 / sizeof(O);
  for (int j = j0 + threadIdx.x; j < j1; j += kThreads) {
    float y[kOut];
#pragma unroll
    for (int k = 0; k < kOut; ++k) y[k] = (static_cast<float>(x[j * kOut + k]) - lo) * scale;
    store16(o + j * kOut, y);
  }
}

// Block k takes slice k % per_vol of volume round * (gridDim.x / per_vol)
// + k / per_vol. Cluster mode: per_vol is the cluster size, one round.
template <typename T, typename I, typename O, int kMode>
__global__ void __launch_bounds__(Shape<kMode == kCluster>::kThreads,
                                  Shape<kMode == kCluster>::kBlocksPerSm)
gather_normalize(const T* __restrict__ src, long long n_vol, long long vox,
                 const I* __restrict__ idx, int batch, int per_vol, int rounds, long long slice,
                 int smem_bytes, float2* __restrict__ partial, O* __restrict__ out) {
  constexpr int kThreads = Shape<kMode == kCluster>::kThreads;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kOut = 16 / sizeof(O);
  extern __shared__ __align__(128) unsigned char body[];
  __shared__ __align__(8) uint64_t bar[kMaxChunks];
  __shared__ float2 s_warp[kThreads / 32];
  __shared__ float2 s_block;  // this block's (min, max), read by its cluster
  __shared__ float2 s_vol;    // the volume's (min, max)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vols_per_round = gridDim.x / per_vol;
  const int part = blockIdx.x % per_vol, slot = blockIdx.x / per_vol;
  const long long e_lo = min(vox, part * slice);
  const int n_e = static_cast<int>(min(vox, e_lo + slice) - e_lo);  // the slice's elements
  uint32_t phases = 0;  // bit k: parity of bar[k]'s next phase

  if (tid == 0) {
    for (int k = 0; k < kMaxChunks; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar[k])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  for (int round = 0; round < (kMode == kGridRounds ? rounds : 1); ++round) {
    const long long b = static_cast<long long>(round) * vols_per_round + slot;
    const long long v = b < batch ? static_cast<long long>(idx[b]) : -1;
    const bool valid = v >= 0 && v < n_vol;
    const T* x = src + (valid ? v : 0) * vox + e_lo;  // the slice; offsets below are into it
    // elements [a_lo, a_hi) are the slice's whole 16-byte vectors from its
    // first 128-byte boundary (bulk copies run fastest from 128-byte
    // aligned sources); the first `held` bytes of them go to shared memory,
    // elements [a_lo, s_hi)
    const uintptr_t p_lo = reinterpret_cast<uintptr_t>(x);
    const uintptr_t p_hi = reinterpret_cast<uintptr_t>(x + n_e);
    int a_lo = static_cast<int>(((128 - (p_lo & 127)) & 127) / sizeof(T));
    int a_hi = n_e - static_cast<int>((p_hi & 15) / sizeof(T));
    if (a_hi <= a_lo) a_lo = a_hi = n_e;  // no whole vector: all of it is head
    const int held = static_cast<int>(min(static_cast<long long>(a_hi - a_lo) * sizeof(T),
                                          static_cast<long long>(smem_bytes & ~15)));
    const int s_hi = a_lo + held / static_cast<int>(sizeof(T));
    const int n_chunks = valid ? (held + kChunkBytes - 1) / kChunkBytes : 0;

    __syncthreads();  // the barriers are set up; the last round's reads are done
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const unsigned char* g = reinterpret_cast<const unsigned char*>(x + a_lo);
      for (int k = 0; k < n_chunks; ++k) {
        const int bytes = min(kChunkBytes, held - k * kChunkBytes);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                         smem_addr(&bar[k])),
                     "r"(bytes)
                     : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];" ::"r"(smem_addr(body + k * kChunkBytes)),
            "l"(g + k * kChunkBytes), "r"(bytes), "r"(smem_addr(&bar[k]))
            : "memory");
      }
    }

    // 1. min and max of the slice
    float lo = INFINITY, hi = -INFINITY;
    if (valid) {
      for (int i = tid; i < a_lo; i += kThreads) fold(lo, hi, x[i]);
      for (int i = a_hi + tid; i < n_e; i += kThreads) fold(lo, hi, x[i]);
      const uint4* over = reinterpret_cast<const uint4*>(x + s_hi);  // beyond shared memory
      const int n_over = (a_hi - s_hi) / kVec;
      for (int i = tid; i < n_over; i += kOverUnroll * kThreads) {
        Vec16<T> q[kOverUnroll];  // loads in flight before they are folded
#pragma unroll
        for (int u = 0; u < kOverUnroll; ++u)
          if (i + u * kThreads < n_over) q[u].raw = __ldg(over + i + u * kThreads);
#pragma unroll
        for (int u = 0; u < kOverUnroll; ++u)
          if (i + u * kThreads < n_over) {
#pragma unroll
            for (int k = 0; k < kVec; ++k) fold(lo, hi, q[u].e[k]);
          }
      }
      for (int k = 0; k < n_chunks; ++k) {
        mbar_wait(&bar[k], (phases >> k) & 1);
        const uint4* c = reinterpret_cast<const uint4*>(body + k * kChunkBytes);
        const int n16 = min(kChunkBytes, held - k * kChunkBytes) / 16;
        for (int i = tid; i < n16; i += kThreads) {
          Vec16<T> q;
          q.raw = c[i];
#pragma unroll
          for (int j = 0; j < kVec; ++j) fold(lo, hi, q.e[j]);
        }
      }
    }
    phases ^= (1u << n_chunks) - 1u;
    warp_minmax(lo, hi);
    if (lane == 0) s_warp[warp] = make_float2(lo, hi);
    __syncthreads();
    float2* part_r = partial + (round & 1) * gridDim.x;
    if (warp == 0) {
      float2 w = lane < kThreads / 32 ? s_warp[lane] : make_float2(INFINITY, -INFINITY);
      warp_minmax(w.x, w.y);
      if (lane == 0) {
        if (kMode == kCluster)
          s_block = w;
        else
          part_r[blockIdx.x] = w;
      }
    }

    // 2. the volume's min and max, from its slices' (min, max)
    if constexpr (kMode == kCluster) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      if (warp == 0) {
        float2 w = lane < per_vol ? *cluster.map_shared_rank(&s_block, lane)
                                  : make_float2(INFINITY, -INFINITY);
        warp_minmax(w.x, w.y);
        if (lane == 0) s_vol = w;
      }
      asm volatile("barrier.cluster.arrive.release;" ::: "memory");  // done reading the others
    } else {
      cg::this_grid().sync();
      if (warp == 0) {
        float2 w = make_float2(INFINITY, -INFINITY);
        for (int i = lane; i < per_vol; i += 32) {
          const float2 p = __ldcg(part_r + slot * per_vol + i);  // other SMs' writes: from L2
          w.x = fminf(w.x, p.x);
          w.y = fmaxf(w.y, p.y);
        }
        warp_minmax(w.x, w.y);
        if (lane == 0) s_vol = w;
      }
    }
    __syncthreads();
    if (b >= batch) continue;
    lo = s_vol.x;
    hi = s_vol.y;
    const float range = hi - lo;
    const float scale = range < 1e-12f ? 0.0f : 1.0f / (range + 1e-30f);

    // 3. scale the slice and write it. Output vectors j cover elements
    // w_lo + j * kOut ..; those in [j_lo, j_hi) lie wholly in shared
    // memory, the others are read from global memory.
    O* o = out + b * vox + e_lo;
    const uintptr_t q_lo = reinterpret_cast<uintptr_t>(o);
    const int w_lo = min(n_e, static_cast<int>(((16 - (q_lo & 15)) & 15) / sizeof(O)));
    const int n_w = (n_e - w_lo) / kOut;
    const int w_hi = w_lo + n_w * kOut;
    if (!valid) {
      for (int i = tid; i < n_e; i += kThreads) store1(o + i, NAN);
      continue;
    }
    for (int i = tid; i < w_lo; i += kThreads) store1(o + i, (static_cast<float>(x[i]) - lo) * scale);
    for (int i = w_hi + tid; i < n_e; i += kThreads)
      store1(o + i, (static_cast<float>(x[i]) - lo) * scale);
    const int j_lo = min(n_w, max(0, (a_lo - w_lo + kOut - 1) / kOut));
    const int j_hi = max(j_lo, min(n_w, (s_hi - w_lo) / kOut));
    const T* held_x = reinterpret_cast<const T*>(body) + (w_lo - a_lo);
    scale_vectors<kThreads>(x + w_lo, o + w_lo, 0, j_lo, lo, scale);
    scale_vectors<kThreads>(held_x, o + w_lo, j_lo, j_hi, lo, scale);
    scale_vectors<kThreads>(x + w_lo, o + w_lo, j_hi, n_w, lo, scale);
  }
  // no block leaves while another block of its cluster may read its s_block
  if constexpr (kMode == kCluster) asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

struct Plan {
  int mode, per_vol, vols_per_round, rounds, smem;
  long long slice;
};

// per_vol slices of a volume; each block's slice and the shared memory
// that holds it (all of it, up to the mode's limit).
template <int kMode>
Plan plan_for(long long vox, int batch, int per_vol, int vols_per_round, size_t elem) {
  Plan p;
  p.per_vol = per_vol;
  p.vols_per_round = vols_per_round;
  p.rounds = (batch + vols_per_round - 1) / vols_per_round;
  p.mode = kMode == kCluster ? kCluster : p.rounds > 1 ? kGridRounds : kGrid;
  p.slice = ((vox + per_vol - 1) / per_vol + 15) / 16 * 16;
  const long long want = (p.slice * static_cast<long long>(elem) + 128 + 127) / 128 * 128;
  p.smem = static_cast<int>(
      std::min(want, static_cast<long long>(Shape<kMode == kCluster>::kMaxDynSmem)));
  return p;
}

template <int kMode>
cudaLaunchConfig_t config(const Plan& p, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.vols_per_round * p.per_vol));
  cfg.blockDim = dim3(Shape<kMode == kCluster>::kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = stream;
  if (kMode == kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(p.per_vol);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  } else {
    attr[0].id = cudaLaunchAttributeCooperative;  // every block resident: the grid barrier
    attr[0].val.cooperative = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets the kernel's shared-memory limit (and, in cluster mode, allows
// clusters of 16) on the current device, only where that changes it.
template <typename T, typename I, typename O, int kMode>
cudaError_t set_smem(int smem) {
  constexpr int kDevices = 64;
  static int set[kDevices] = {};  // 0: not set yet
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kDevices && set[device] == smem) return cudaSuccess;
  auto kernel = gather_normalize<T, I, O, kMode>;
  if (kMode == kCluster)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kDevices) set[device] = smem;
  return err;
}

// Cluster mode where a volume's slices fit its blocks' shared memory and
// the device can run a cluster of them; else grid mode.
template <typename T, typename I, typename O>
Plan choose(long long vox, int batch, int n_sm, cudaStream_t stream) {
  const Plan c = plan_for<kCluster>(vox, batch, kClusterSize, batch, sizeof(T));
  if (c.slice * static_cast<long long>(sizeof(T)) + 128 <= c.smem &&
      set_smem<T, I, O, kCluster>(c.smem) == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config<kCluster>(c, stream, attr);
    int active = 0;
    if (cudaOccupancyMaxActiveClusters(&active, gather_normalize<T, I, O, kCluster>, &cfg) ==
            cudaSuccess &&
        active > 0)
      return c;
  }
  (void)cudaGetLastError();  // a refused cluster query is not an error of the launch
  const int n_blocks = n_sm * Shape<false>::kBlocksPerSm;
  const int per_vol = std::max(1, n_blocks / batch);
  return plan_for<kGrid>(vox, batch, per_vol, n_blocks / per_vol, sizeof(T));
}

template <typename T, typename I, typename O, int kMode>
cudaError_t launch_mode(const Plan& p, const void* src, long long n_vol, long long vox,
                        const void* idx, int batch, void* out, void* partial,
                        cudaStream_t stream) {
  const cudaError_t err = set_smem<T, I, O, kMode>(p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<kMode>(p, stream, attr);
  return cudaLaunchKernelEx(&cfg, gather_normalize<T, I, O, kMode>, static_cast<const T*>(src),
                            n_vol, vox, static_cast<const I*>(idx), batch, p.per_vol, p.rounds,
                            p.slice, p.smem, static_cast<float2*>(partial),
                            static_cast<O*>(out));
}

template <typename T, typename I, typename O>
cudaError_t launch(const void* src, long long n_vol, long long vox, const void* idx, int batch,
                   void* out, void* partial, int device, cudaStream_t stream,
                   int* blocks_per_volume, int* smem_bytes) {
  // the choice is made once per device, volume size and batch
  static int c_device = -1, c_batch = -1;
  static long long c_vox = -1;
  static Plan p;
  cudaError_t err;
  if (device != c_device || vox != c_vox || batch != c_batch) {
    int n_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    p = choose<T, I, O>(vox, batch, n_sm, stream);
    c_device = device;
    c_vox = vox;
    c_batch = batch;
  }
  switch (p.mode) {
    case kCluster: err = launch_mode<T, I, O, kCluster>(p, src, n_vol, vox, idx, batch, out, partial, stream); break;
    case kGrid: err = launch_mode<T, I, O, kGrid>(p, src, n_vol, vox, idx, batch, out, partial, stream); break;
    default: err = launch_mode<T, I, O, kGridRounds>(p, src, n_vol, vox, idx, batch, out, partial, stream);
  }
  if (err != cudaSuccess) return err;
  *blocks_per_volume = p.mode == kCluster ? -p.per_vol : p.per_vol;
  *smem_bytes = p.smem;
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t dispatch_out(int out_dtype, const void* src, long long n_vol, long long vox,
                         const void* idx, int batch, void* out, void* partial, int device,
                         cudaStream_t stream, int* per_vol, int* smem) {
  switch (out_dtype) {
    case 0: return launch<T, I, float>(src, n_vol, vox, idx, batch, out, partial, device, stream, per_vol, smem);
    case 1: return launch<T, I, __nv_bfloat16>(src, n_vol, vox, idx, batch, out, partial, device, stream, per_vol, smem);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_idx(int idx_dtype, int out_dtype, const void* src, long long n_vol,
                         long long vox, const void* idx, int batch, void* out, void* partial,
                         int device, cudaStream_t stream, int* per_vol, int* smem) {
  switch (idx_dtype) {
    case 0: return dispatch_out<T, int32_t>(out_dtype, src, n_vol, vox, idx, batch, out, partial, device, stream, per_vol, smem);
    case 1: return dispatch_out<T, int64_t>(out_dtype, src, n_vol, vox, idx, batch, out, partial, device, stream, per_vol, smem);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// src_dtype: 0 uint8, 1 int16, 2 float32. idx_dtype: 0 int32, 1 int64.
// out_dtype: 0 float32, 1 bfloat16; out is contiguous (batch, vox) and
// 16-byte aligned; vox < 2**31. partial: a scratch of 8 float2 per SM of the device
// (2 per block of grid mode), which launches on one stream may share.
// Launches one kernel on `stream` of `device`, does not synchronise,
// writes the blocks per volume to *blocks_per_volume (negative in cluster
// mode: minus the cluster size) and each block's dynamic shared memory to
// *smem_bytes, and returns cudaGetLastError() of the launch (0 on success).
extern "C" int mad_gather_normalize(const void* src, int src_dtype, long long n_vol,
                                    long long vox, const void* idx, int idx_dtype, int batch,
                                    void* out, int out_dtype, void* partial, int device,
                                    void* stream, int* blocks_per_volume, int* smem_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || vox <= 0 || vox > 0x7fffffffLL || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      static_cast<long long>(batch) * kClusterSize > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (src_dtype) {
    case 0: err = dispatch_idx<uint8_t>(idx_dtype, out_dtype, src, n_vol, vox, idx, batch, out, partial, device, st, blocks_per_volume, smem_bytes); break;
    case 1: err = dispatch_idx<int16_t>(idx_dtype, out_dtype, src, n_vol, vox, idx, batch, out, partial, device, st, blocks_per_volume, smem_bytes); break;
    case 2: err = dispatch_idx<float>(idx_dtype, out_dtype, src, n_vol, vox, idx, batch, out, partial, device, st, blocks_per_volume, smem_bytes); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* mad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
