// K3: int8 x int8 -> int32 3-D convolution with a fused epilogue,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU package's models/resnet3d_int8.py::_conv_i8 (line 131,
// an XLA conv_general_dilated with preferred_element_type=int32, no Pallas
// kernel) and the elementwise work that wraps it in _forward: the dequant
// o * (s_act * s_w[c]) + b[c] (lines 210-218), the ReLU, the next quant
// point clip(round(h / s_next), -127, 127) (_quantize, lines 150-152) and,
// for a block's last conv, the residual add, ReLU and bf16 cast of the
// block output (lines 245-252) with the next block's input quant point.
// Stock PyTorch has no CUDA int8 convolution, so this path runs nowhere on
// the card without it.
//
// Layouts. Activations are NDHWC int8, contiguous (C_in innermost). Weights
// are [C_out][kd][kh][kw][C_in] int8, so each output channel's K = k^3 *
// C_in products are one contiguous run (the wrapper re-lays the DHWIO
// export once). Outputs are NDHWC: row m = (b, d, h, w) of the output
// grid, column n = output channel. Zero padding d * (k - 1) / 2 on each
// side, kernel 1 or 3, any stride and dilation, C_in % 32 == 0, C_out % 8
// == 0.
//
// As a GEMM: M = B * D_out * H_out * W_out, N = C_out, K = k^3 * C_in, with
// A (M x K) never written out (an implicit GEMM). K is walked in 32-byte
// chunks, chunk (tap, c) holding channels 32c .. 32c + 31 of one tap, so a
// chunk's weights sit at tap * C_in + 32c in the weights' layout.
//
// Design. One block of two warpgroups (256 threads) computes a 128 x BN
// output tile, BN in {64, 128, 256} chosen by the wrapper from C_out
// (ops/int8_conv.py::tile_plan); each warpgroup owns 64 of the rows and all
// BN channels. The five limits of the first (mma.sync) design, and what
// this one does about each:
//   1. mma.sync m16n8k32 does not reach Hopper's int8 rate: the product is
//      wgmma.mma_async m64nBNk32 s32.s8.s8, both operands read by the tensor
//      core straight from shared memory (K-major, 128-byte swizzle, or
//      64-byte when C_in = 64), int32 sums in registers (BN / 2 a thread).
//   2. A barrier every 32 bytes of K: a stage is 128 bytes of K (four
//      k32 steps, four wgmma a warpgroup), one barrier a stage; a 4-stage
//      ring loads two stages ahead while one wgmma group stays in flight. Nothing else touches the accumulators inside
//      the loop: ptxas would wait for the group there (C7517) or serialise
//      the wgmma (C7515), which the build log shows.
//   3. Fragments through 32-bit shared loads: none. Where a stage's K lies
//      in whole taps (C_in % 128 == 0, or C_in = 64: two taps of 64 bytes a
//      stage), TMA brings the weights (a 2-D box of BN rows) and, for a box
//      tile at stride 1, the activations: a 5-D box of the tile's output
//      voxels shifted by the tap, whose out-of-bounds zero fill is the
//      convolution's padding;
//      both land on the stage's mbarrier. Otherwise 16-byte cp.async copies
//      gather them, neighbouring threads on the two halves of a 32-byte
//      chunk so that a warp reads whole sectors, made visible to wgmma by
//      fence.proxy.async.
//   4. 128 x 64 tiles re-gathering A for every 64 channels: BN up to 256
//      (stage 4's 512 channels read A twice, not eight times); each thread
//      decodes its row's voxel once and walks the K chunks with a carry.
//   5. Taps in the padding multiplied anyway: a tile's rows are a box of
//      output voxels (TD x TH x TW <= 128, chosen by the wrapper so that
//      whole taps fall away at the volume's faces, and the grid fills the
//      card; 1^3 convs take flat 128-row tiles), and the block ORs its rows'
//      masks of in-volume taps and walks only the taps some row needs: no
//      copy, no product for the others. The int32 sums are exact, so
//      skipping zero products changes no bit.
//
// Epilogues (the accumulators go through an int32 tile in the freed ring,
// then each thread takes 4 neighbouring channels of a row, so a warp reads
// and writes whole 16-byte runs):
//   mode 0: int32 out (tests);
//   mode 1: int8 out, q = clip(rint(relu(o * k[c] + b[c]) / s_next));
//   mode 2: float32 out, o * k[c] + b[c];
//   mode 3: the block output: h = bf16(relu(o * k[c] + b[c] + r)) with r
//           the bf16 identity or the float32 shortcut, written as bf16,
//           and, when out_q is given, q = clip(rint(float(h) / s_next)) as
//           int8, the next block's input quant point.
// k[c] = s_act * s_w[c] is computed once per export in float32. The float
// operations are the TPU package's, in its order and rounding: a multiply
// and adds that nvcc must not contract into an FMA (__fmul_rn, __fadd_rn),
// a true division (__fdiv_rn, never a reciprocal; skipped where the ReLU
// gave 0), rintf (half to even, as round there), round-to-nearest-even
// bf16. So the kernel is bit-equal to the plain version (ops/int8_conv.py),
// whose sums are exact (|sum| <= 127^2 * 27 * 2048 < 2^31), in every
// epilogue.
//
// What bounds it on this card: tensor-core operations on the 3^3 convs
// (the in-volume taps at the H100's 1,979 TOP/s int8 dense rate), bytes on
// the 1^3 shortcuts. What holds this design back from the bound: the
// epilogue runs after the main loop with nothing to overlap it (one block
// of 256 channels fills a multiprocessor's shared memory, and the grid is
// not persistent); the main loop still waits on its copies (no producer
// warp, no cluster multicast of the weights); the box tiles execute taps
// that only some rows need (stage 4's d4 convs keep about 70 % of the
// dense taps against 49 % inside the volume); the 1^3 shortcuts, the C_in =
// 64 stride-2 and the C_in % 64 != 0 shapes gather A with cp.async.
//
// The TMA tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// which lives in libcuda; it is fetched through the runtime's entry-point
// query (cudaGetDriverEntryPoint), so the library links no -lcuda.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (ops/_build.py);
// bound with ctypes through the extern "C" entry points at the end.

#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // output rows (voxels) of a block's tile
constexpr int kRowBytes = 128;  // K bytes of a stage: one 128-byte swizzle row
// ring depth (loads run kStages - 2 ahead): 192 KB of stages at BN = 256, 128
// KB at BN = 128, 96 KB at BN = 64 (two blocks a multiprocessor)
constexpr int kStages = 4;
constexpr int kThreads = 256;   // two warpgroups, 64 rows each
constexpr int kMaxTaps = 27;

struct Params {
  CUtensorMap w_map;    // the weights as a 2-D [N][K] int8 tensor, 128 x BN boxes (b_tma)
  CUtensorMap x_map;    // the activations as a 5-D (C, W, H, D, B) tensor (a_tma)
  const int8_t* x;      // (B, D, H, W, C) int8
  const int8_t* w;      // (N, k, k, k, C) int8
  void* out;            // (M, N) int32 / int8 / float32 / bf16
  int8_t* out_q;        // (M, N) int8 (mode 3, optional)
  const float* kscale;  // (N,) s_act * s_w[c]      (modes 1-3)
  const float* bias;    // (N,) folded BN bias     (modes 1-3)
  const void* res;      // (M, N) bf16 or float32 residual (mode 3)
  int res_f32;          // the residual is float32 (else bf16)
  float s_next;         // next quant point's scale (modes 1, 3)
  int D, H, W, C;
  int Do, Ho, Wo, N;
  int ksize, stride, dil, pad, K;
  long long M;
  int td, th, tw;                 // box tile of output voxels; td == 0: flat rows
  int tiles_d, tiles_h, tiles_w;  // boxes along each axis
  int n_tiles;                    // ceil(N / BN)
  int b_tma;                      // weights by TMA (C % 128 == 0), else by cp.async
  int a_tma;                      // activations by TMA: a box tile at stride 1 (b_tma), else cp.async
  int a_box_bytes;                // bytes of A one TMA stage writes
  int sw64;  // C == 64: a stage is two taps, each a 64-byte K sub-tile in the 64-byte swizzle
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's generic-proxy writes to shared memory (the cp.async
// copies it waited for) visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads above the last wgmma wait
template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// TMA: the (128-byte, rows) box of `map` at (k, n) into shared memory, in
// the 128-byte swizzle; its bytes complete on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int k, int n,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k),
      "r"(n), "r"(bar) : "memory");
}

// TMA: the (128-byte, TW, TH, TD, 1) box of the NDHWC activations at (c, w, h,
// d, b); coordinates outside the volume read zeros, the conv's padding
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, int c, int w,
                                            int h, int d, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(d), "r"(b), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile: in the 128-byte swizzle
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), layout type 1; in
// the 64-byte swizzle rows of 64 bytes, groups 512 bytes apart, type 2.
// `hi` holds the layout and SBO bits (desc_hi), the start address is in
// 16-byte units; the tiles are aligned to their 8-row group, so the base
// offset is 0.
__host__ __device__ constexpr uint64_t desc_hi(bool sw64) {
  return (static_cast<uint64_t>(sw64 ? 512 >> 4 : 1024 >> 4) << 32) |
         (static_cast<uint64_t>(sw64 ? 2 : 1) << 62) | (static_cast<uint64_t>(1) << 16);
}

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint64_t hi) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | hi;
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


template <int BN>
__device__ __forceinline__ void wgmma(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) {
    wgmma_n64(d, da, db);
  } else if constexpr (BN == 128) {
    wgmma_n128(d, da, db);
  } else {
    wgmma_n256(d, da, db);
  }
}

__device__ __forceinline__ float dequant(int v, float k, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(v), k), b);
}

// clip(rint(relu(h) / s), -127, 127) as int8 with a true division. ReLU
// outputs that are 0 (or negative, or NaN) give 0 without dividing.
__device__ __forceinline__ int8_t requant(float h, float s_next) {
  if (!(h > 0.0f)) return 0;
  return static_cast<int8_t>(static_cast<int>(fminf(rintf(__fdiv_rn(h, s_next)), 127.0f)));
}

// Output voxel of row `row` of tile `tile`: false for a row past M or
// outside the grid (a box at the grid's edge, or past the box's volume).
__device__ __forceinline__ bool locate(const Params& p, int tile, int row, long long& m, int& b,
                                       int& od, int& oh, int& ow) {
  b = od = oh = ow = 0;
  m = 0;
  if (p.td == 0) {
    m = static_cast<long long>(tile) * kBM + row;
    if (m >= p.M) return false;
    long long t = m;
    ow = static_cast<int>(t % p.Wo);
    t /= p.Wo;
    oh = static_cast<int>(t % p.Ho);
    t /= p.Ho;
    od = static_cast<int>(t % p.Do);
    b = static_cast<int>(t / p.Do);
    return true;
  }
  if (row >= p.td * p.th * p.tw) return false;
  int t = tile;
  const int bw = t % p.tiles_w;
  t /= p.tiles_w;
  const int bh = t % p.tiles_h;
  t /= p.tiles_h;
  const int bd = t % p.tiles_d;
  const int bb = t / p.tiles_d;
  const int w = bw * p.tw + row % p.tw;
  const int h = bh * p.th + (row / p.tw) % p.th;
  const int d = bd * p.td + row / (p.tw * p.th);
  if (w >= p.Wo || h >= p.Ho || d >= p.Do) return false;
  b = bb;
  od = d;
  oh = h;
  ow = w;
  m = ((static_cast<long long>(b) * p.Do + od) * p.Ho + oh) * p.Wo + ow;
  return true;
}

template <int BN, int MODE, bool SW64>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
    conv_i8_kernel(const __grid_constant__ Params p) {
  constexpr int kStageBytes = (kBM + BN) * kRowBytes;
  constexpr int kCRow = BN + 8;  // int32 stride of the epilogue's staged tile (bank spread)
  static_assert(kBM * kCRow * 4 <= kStages * kStageBytes, "the staged tile fits the ring");
  extern __shared__ uint8_t smem_raw[];
  __shared__ long long s_delta[kMaxTaps];  // input offset of each live tap
  __shared__ int s_tap[kMaxTaps];          // its index in the weights' k^3 taps
  __shared__ unsigned s_mask;
  __shared__ int s_nact;
  __shared__ __align__(16) float s_k[BN];  // the tile's dequant factors
  __shared__ __align__(16) float s_b[BN];  // and folded biases
  __shared__ long long s_m[kBM];           // output row of each tile row, -1 if none
  __shared__ __align__(8) uint64_t s_bar[kStages];  // B of a stage landed (TMA)
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int tile = blockIdx.x / p.n_tiles;
  const int n0 = (blockIdx.x % p.n_tiles) * BN;
  if (tid == 0) {
    s_mask = 0;
    if (p.b_tma) {
      for (int i = 0; i < kStages; ++i) mbar_init(smem_u32(&s_bar[i]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  if (MODE != 0 && tid < BN) {
    s_k[tid] = n0 + tid < p.N ? p.kscale[n0 + tid] : 0.0f;
    s_b[tid] = n0 + tid < p.N ? p.bias[n0 + tid] : 0.0f;
  }

  // this thread's A row (threads 2r and 2r + 1 share row r): its voxel,
  // decoded once, and the mask of its taps that land inside the volume
  const int row = tid >> 1;
  long long m;
  int b, od, oh, ow;
  const bool row_ok = locate(p, tile, row, m, b, od, oh, ow);
  if ((tid & 1) == 0) s_m[row] = row_ok ? m : -1;
  const int id0 = od * p.stride - p.pad;
  const int ih0 = oh * p.stride - p.pad;
  const int iw0 = ow * p.stride - p.pad;
  unsigned rmask = 0;
  if (row_ok) {
    int bit = 0;
    for (int kd = 0; kd < p.ksize; ++kd)
      for (int kh = 0; kh < p.ksize; ++kh)
        for (int kw = 0; kw < p.ksize; ++kw, ++bit) {
          const int id = id0 + kd * p.dil, ih = ih0 + kh * p.dil, iw = iw0 + kw * p.dil;
          if (static_cast<unsigned>(id) < static_cast<unsigned>(p.D) &&
              static_cast<unsigned>(ih) < static_cast<unsigned>(p.H) &&
              static_cast<unsigned>(iw) < static_cast<unsigned>(p.W))
            rmask |= 1u << bit;
        }
  }
  const long long rbase =
      (((static_cast<long long>(b) * p.D + id0) * p.H + ih0) * p.W + iw0) * p.C;
  __syncthreads();  // s_mask = 0 and the barriers' init are visible
  const unsigned wmask = __reduce_or_sync(0xffffffffu, rmask);
  if ((tid & 31) == 0 && wmask) atomicOr(&s_mask, wmask);
  __syncthreads();
  if (tid == 0) {  // the taps some row of the tile needs, in the weights' order
    const unsigned mask = s_mask;
    int n = 0, bit = 0;
    for (int kd = 0; kd < p.ksize; ++kd)
      for (int kh = 0; kh < p.ksize; ++kh)
        for (int kw = 0; kw < p.ksize; ++kw, ++bit)
          if (mask >> bit & 1u) {
            s_tap[n] = bit;
            s_delta[n] = ((static_cast<long long>(kd) * p.dil * p.H + kh * p.dil) * p.W +
                          kw * p.dil) * p.C;
            ++n;
          }
    s_nact = n;
  }
  __syncthreads();

  const int nact = s_nact;
  const int cpt = p.C >> 5;  // 32-byte chunks per tap
  const int steps = (nact * cpt + 3) >> 2;
  // Copies: neighbouring threads take the two 16-byte halves of one 32-byte
  // chunk, so a warp's cp.async covers whole 32-byte sectors. A: this
  // thread's row (t / 2), half t % 2 of each of the stage's 4 chunks. B
  // (when not by TMA): BN / 32 (row, chunk) pairs, pair (t / 2) + 128 i =
  // (row % BN, chunk / BN).
  const int half = tid & 1;
  const uint32_t a_dst = row * kRowBytes;
  constexpr int kPb = BN / 32;
  const int bsel = BN == 64 ? row >> 6 : 0;  // pair (t / 2) + 128 i has chunk 128 i / BN + bsel
  const int8_t* wsrc[kPb];
  uint32_t b_dst[kPb];
#pragma unroll
  for (int i = 0; i < kPb; ++i) {
    const int n = (row + 128 * i) % BN;
    wsrc[i] = n0 + n < p.N ? p.w + static_cast<long long>(n0 + n) * p.K + 16 * half : nullptr;
    b_dst[i] = kBM * kRowBytes + n * kRowBytes +
               (((2 * (128 * i / BN + bsel) + half) ^ (n & 7)) << 4);
  }
  const long long abase = rbase + 16 * half;
  int box_w = 0, box_h = 0, box_d = 0, box_b = 0;  // the tile's first output voxel (a_tma)
  if (p.a_tma) {
    int t = tile;
    box_w = t % p.tiles_w * p.tw;
    t /= p.tiles_w;
    box_h = t % p.tiles_h * p.th;
    t /= p.tiles_h;
    box_d = t % p.tiles_d * p.td;
    box_b = t / p.tiles_d;
  }

  int ld_tap = 0, ld_c = 0;  // the next stage's first chunk: live tap, chunk within it
  auto load = [&](int slot) {
    const uint32_t stage = smem_u32(smem + slot * kStageBytes);
    int tap[4], c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = ld_c + j;
      tap[j] = ld_tap;
      while (c[j] >= cpt) {
        c[j] -= cpt;
        ++tap[j];
      }
    }
    if (!p.a_tma) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = tap[j] < nact;
        const int t = live ? tap[j] : 0;
        const bool ok = live && (rmask >> s_tap[t] & 1u);
        const int8_t* src = ok ? p.x + abase + s_delta[t] + 32 * c[j] : p.x;
        const uint32_t dst =
            SW64 ? stage + (j >> 1) * (kBM * 64) + row * 64 +
                       ((((j & 1) * 2 + half) ^ (row >> 1 & 3)) << 4)
                 : stage + a_dst + (((2 * j + half) ^ (row & 7)) << 4);
        cp_async16(dst, src, ok ? 16 : 0);
      }
    }
    if (p.b_tma) {  // a box a tap: the stage's 128 bytes of K, or two taps' 64
      if (tid == 0) {
        const uint32_t bar = smem_u32(&s_bar[slot]);
        mbar_expect_tx(bar, BN * kRowBytes + (p.a_tma ? p.a_box_bytes : 0));
#pragma unroll
        for (int u = 0; u < (SW64 ? 2 : 1); ++u) {
          const int tl = tap[2 * u];   // a live tap, or past the last: zeros
          const bool live = tl < nact;
          const int t = live ? s_tap[tl] : 0;
          const int c0 = live ? 32 * c[2 * u] : p.C;  // past the channels: zero-filled
          const uint32_t a_dst_u = stage + u * (kBM * 64);
          tma_load_2d(stage + kBM * kRowBytes + u * (BN * 64), &p.w_map,
                      live ? t * p.C + c0 : p.K, n0, bar);
          if (p.a_tma) {
            const int kk = p.ksize * p.ksize;
            tma_load_5d(a_dst_u, &p.x_map, c0, box_w + t % p.ksize * p.dil - p.pad,
                        box_h + t / p.ksize % p.ksize * p.dil - p.pad,
                        box_d + t / kk * p.dil - p.pad, box_b, bar);
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPb; ++i) {
        const int j0 = 128 * i / BN;  // this pair's chunk, + bsel
        const int tj = bsel ? tap[(j0 + 1) & 3] : tap[j0];
        const int cj = bsel ? c[(j0 + 1) & 3] : c[j0];
        const bool ok = wsrc[i] != nullptr && tj < nact;
        const int8_t* src = ok ? wsrc[i] + s_tap[tj] * p.C + 32 * cj : p.w;
        cp_async16(stage + b_dst[i], src, ok ? 16 : 0);
      }
    }
    ld_c += 4;
    while (ld_c >= cpt) {
      ld_c -= cpt;
      ++ld_tap;
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  const int wg = tid >> 7;
  // k32 step kk of a stage: 128-byte rows, byte 32 kk of each row; 64-byte
  // rows, byte 32 (kk % 2) of sub-tile kk / 2 (A 128 rows, B BN rows)
  constexpr uint64_t hi = desc_hi(SW64);
  constexpr uint32_t a_sub = SW64 ? kBM * 64 : 64, b_sub = SW64 ? BN * 64 : 64;
  const uint32_t wg_rows = wg * 64 * (SW64 ? 64 : kRowBytes);
  for (int s = 0; s < steps; ++s) {
    const int slot = s % kStages;
    cp_async_wait<kStages - 3>();  // this thread's copies of stage s landed
    fence_proxy_async();
    __syncthreads();  // everyone's copies of stage s landed; stage s - 2's wgmma is done
    if (s + kStages - 2 < steps) load((s + kStages - 2) % kStages);
    cp_async_commit();
    if (p.b_tma) mbar_wait(smem_u32(&s_bar[slot]), (s / kStages) & 1);
    const uint32_t base = smem_u32(smem + slot * kStageBytes);
    const uint32_t a_addr = base + wg_rows;
    const uint32_t b_addr = base + kBM * kRowBytes;
    // no other instruction touches acc until the last wait: one that did
    // while a group is in flight would make ptxas wait for the group there
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowBytes / 32; ++kk)
      wgmma<BN>(acc, smem_desc(a_addr + (kk >> 1) * a_sub + 32 * (kk & 1), hi),
                smem_desc(b_addr + (kk >> 1) * b_sub + 32 * (kk & 1), hi));
    wgmma_commit();
    wgmma_wait<1>();  // stage s - 1's group is done: its slot may be refilled
  }
  wgmma_wait<0>();
  fence_operands(acc);
  cp_async_wait<0>();
  __syncthreads();  // every wgmma has read its stages: the ring is free

  // Epilogue, in two passes through the ring. 1: each thread puts its sums
  // in an int32 tile (lane l of warp w of warpgroup g holds rows 64 g + 16 w
  // + l / 4 (+ 8 hr), channels 8 j + 2 (l % 4) (+ 1) in acc[4 j + 2 hr (+
  // 1)]). 2: each thread takes 4 neighbouring channels of a row, so a warp
  // reads the residual and writes the outputs as whole 16-byte runs.
  int* c_s = reinterpret_cast<int*>(smem);
  {
    const int lane = tid & 31;
    const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<int2*>(c_s + (r0 + 8 * hr) * kCRow + j * 8 + (lane & 3) * 2) =
            make_int2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
  }
  __syncthreads();
  constexpr int kTpr = BN / 4;          // threads a row
  constexpr int kRpp = kThreads / kTpr;  // rows a pass
  const int c = (tid % kTpr) * 4;
  const int col = n0 + c;
  if (col >= p.N) return;  // N % 8 == 0: the 4 channels are all in or all out
  float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), bv = kv;
  if (MODE != 0) {
    kv = *reinterpret_cast<const float4*>(s_k + c);
    bv = *reinterpret_cast<const float4*>(s_b + c);
  }
  for (int i = 0; i < kBM / kRpp; ++i) {
    const int r = tid / kTpr + i * kRpp;
    const long long mo = s_m[r];
    if (mo < 0) continue;
    const int4 v = *reinterpret_cast<const int4*>(c_s + r * kCRow + c);
    const long long o = mo * p.N + col;
    if (MODE == 0) {
      *reinterpret_cast<int4*>(static_cast<int*>(p.out) + o) = v;
      continue;
    }
    const float o0 = dequant(v.x, kv.x, bv.x), o1 = dequant(v.y, kv.y, bv.y);
    const float o2 = dequant(v.z, kv.z, bv.z), o3 = dequant(v.w, kv.w, bv.w);
    if (MODE == 1) {
      char4 q;
      q.x = requant(o0, p.s_next);
      q.y = requant(o1, p.s_next);
      q.z = requant(o2, p.s_next);
      q.w = requant(o3, p.s_next);
      *reinterpret_cast<char4*>(static_cast<int8_t*>(p.out) + o) = q;
    } else if (MODE == 2) {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + o) = make_float4(o0, o1, o2, o3);
    } else {
      float4 rv;
      if (p.res_f32) {
        rv = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p.res) + o));
      } else {
        const uint2 raw =
            __ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p.res) + o));
        const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
        rv = make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
      }
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(fmaxf(__fadd_rn(o0, rv.x), 0.0f),
                                                       fmaxf(__fadd_rn(o1, rv.y), 0.0f));
      const __nv_bfloat162 h23 = __floats2bfloat162_rn(fmaxf(__fadd_rn(o2, rv.z), 0.0f),
                                                       fmaxf(__fadd_rn(o3, rv.w), 0.0f));
      uint2 hv;
      hv.x = *reinterpret_cast<const uint32_t*>(&h01);
      hv.y = *reinterpret_cast<const uint32_t*>(&h23);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + o) = hv;
      if (p.out_q != nullptr) {
        char4 q;
        q.x = requant(__low2float(h01), p.s_next);
        q.y = requant(__high2float(h01), p.s_next);
        q.z = requant(__low2float(h23), p.s_next);
        q.w = requant(__high2float(h23), p.s_next);
        *reinterpret_cast<char4*>(p.out_q + o) = q;
      }
    }
  }
}

template <int BN, int MODE, bool SW64>
int launch(const Params& p, long long blocks, cudaStream_t stream) {
  constexpr int smem = kStages * (kBM + BN) * kRowBytes + 1024;  // + 1024: alignment slack
  static unsigned long long attr_set = 0;  // devices this instance was opened on
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !(attr_set >> dev & 1ull)) {
    e = cudaFuncSetAttribute(conv_i8_kernel<BN, MODE, SW64>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) attr_set |= 1ull << dev;
  }
  conv_i8_kernel<BN, MODE, SW64><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool SW64>
int launch_mode(const Params& p, long long blocks, int mode, cudaStream_t stream) {
  switch (mode) {
    case 0: return launch<BN, 0, SW64>(p, blocks, stream);
    case 1: return launch<BN, 1, SW64>(p, blocks, stream);
    case 2: return launch<BN, 2, SW64>(p, blocks, stream);
    case 3: return launch<BN, 3, SW64>(p, blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int BN>
int launch_bn(const Params& p, long long blocks, int mode, cudaStream_t stream) {
  return p.sw64 ? launch_mode<BN, true>(p, blocks, mode, stream)
                : launch_mode<BN, false>(p, blocks, mode, stream);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; it is fetched once through the
// runtime's entry-point query (no -lcuda at build time). Every map here
// reads rows of uint8, 128 bytes in the 128-byte swizzle or 64 in the
// 64-byte one, zero-filling what lies outside the tensor.
int encode_tiled(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                 const cuuint64_t* strides, const cuuint32_t* box, bool sw64) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                  cudaEnableDefault, &found);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            sw64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch K3 on `stream` (a cudaStream_t as a pointer). x: (B, D, H, W, C)
// int8; w: (N, k, k, k, C) int8; out: (B, Do, Ho, Wo, N) of int32 (mode 0),
// int8 (mode 1), float32 (mode 2) or bf16 (mode 3); out_q: (B, Do, Ho, Wo,
// N) int8 or null (mode 3); kscale, bias: (N,) float32 (modes 1-3);
// residual: (B, Do, Ho, Wo, N) float32 (res_f32) or bf16 (mode 3). bn: 64,
// 128 or 256 output channels a tile; (td, th, tw): the box of output voxels
// a tile covers (td * th * tw <= 128), or td = 0 for flat 128-row tiles.
// The caller checks C % 32 == 0, N % 8 == 0, contiguity, 16-byte alignment
// and the output sizes. Does not synchronise; returns cudaGetLastError() of
// the launch (0 on success).
extern "C" int mad_conv_i8(const void* x, const void* w, void* out, void* out_q,
                           const void* kscale, const void* bias, const void* residual,
                           int res_f32, float s_next, int batch, int D, int H, int W, int C,
                           int N, int ksize, int stride, int dil, int Do, int Ho, int Wo, int bn,
                           int td, int th, int tw, int mode, void* stream) {
  Params p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.out = out;
  p.out_q = static_cast<int8_t*>(out_q);
  p.kscale = static_cast<const float*>(kscale);
  p.bias = static_cast<const float*>(bias);
  p.res = residual;
  p.res_f32 = res_f32;
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
  p.K = ksize * ksize * ksize * C;
  p.M = static_cast<long long>(batch) * Do * Ho * Wo;
  if (td < 0 || (td > 0 && (th < 1 || tw < 1 || td * th * tw > kBM)))
    return static_cast<int>(cudaErrorInvalidValue);
  p.td = td;
  p.th = th;
  p.tw = tw;
  long long tiles;
  if (td == 0) {
    p.tiles_d = p.tiles_h = p.tiles_w = 0;
    tiles = (p.M + kBM - 1) / kBM;
  } else {
    p.tiles_d = (Do + td - 1) / td;
    p.tiles_h = (Ho + th - 1) / th;
    p.tiles_w = (Wo + tw - 1) / tw;
    tiles = static_cast<long long>(batch) * p.tiles_d * p.tiles_h * p.tiles_w;
  }
  p.n_tiles = (N + bn - 1) / bn;
  // A stage's 128 bytes of K lie in one tap (C % 128 == 0) or in two whole
  // taps (C == 64): each part is one TMA box. A by TMA also needs stride 1
  // and a box tile (flat 1^3 tiles gather A with cp.async).
  p.sw64 = C == 64;
  p.b_tma = C % kRowBytes == 0 || p.sw64;
  p.a_tma = p.b_tma && stride == 1 && td > 0;
  const cuuint32_t row = p.sw64 ? 64 : kRowBytes;  // bytes of K a box row holds
  if (p.b_tma) {  // the weights: a 2-D [N][K] tensor in (row, bn) boxes
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.K), static_cast<cuuint64_t>(N)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.K)};
    const cuuint32_t box[2] = {row, static_cast<cuuint32_t>(bn)};
    const int e = encode_tiled(&p.w_map, w, 2, dims, strides, box, p.sw64);
    if (e != 0) return e;
  }
  if (p.a_tma) {  // the activations as (C, W, H, D, B) in boxes of a tile's voxels
    const cuuint64_t c = C, vox_w = static_cast<cuuint64_t>(W) * C;
    const cuuint64_t dims[5] = {c, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[4] = {c, vox_w, vox_w * H, vox_w * H * D};
    const cuuint32_t box[5] = {row, static_cast<cuuint32_t>(tw), static_cast<cuuint32_t>(th),
                               static_cast<cuuint32_t>(td), 1};
    const int e = encode_tiled(&p.x_map, x, 5, dims, strides, box, p.sw64);
    if (e != 0) return e;
    p.a_box_bytes = (p.sw64 ? 2 : 1) * td * th * tw * static_cast<int>(row);
  }
  const long long blocks = tiles * p.n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64: return launch_bn<64>(p, blocks, mode, s);
    case 128: return launch_bn<128>(p, blocks, mode, s);
    case 256: return launch_bn<256>(p, blocks, mode, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* mad_conv_i8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
