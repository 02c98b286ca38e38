// Native NIfTI-1 batch decoder for the host input pipeline (from the TPU
// package's native/nifti_reader.cpp; the port builds and loads its own).
//
// Decodes NIfTI volumes (.nii / .nii.gz via zlib) outside the interpreter
// lock, one volume per call or a batch on a pthread pool, optionally fusing
// min-max intensity normalization (MONAI ScaleIntensityd semantics) into
// the decode pass, and writes straight into caller-provided float32
// buffers in C order [x][y][z], as utils/nifti.py's Python reader returns
// volumes. What differs from the TPU package's copy, all for the time a
// volume takes (that copy decoded slower than the Python reader on the
// H100's host; PERF.md):
// - an uncompressed file is read with one fread into a buffer of its size
//   (zlib's transparent mode copies it through a small buffer), a gzip one
//   into a buffer sized from its ISIZE trailer, neither zero-filled;
// - the file's Fortran order (x fastest) is transposed to C order during
//   the conversion, 16 x at a time, so the caller does no transposing copy
//   of its own;
// - the values are bit-equal to the Python reader's: scl_slope / scl_inter
//   is a float32 multiply then add, applied only when it is not the
//   identity (x * 1 + 0 would turn -0.0 into +0.0), and the build passes
//   -ffp-contract=off so the compiler never fuses the two into one
//   rounding.
//
// C ABI (ctypes): see utils/native_loader.py. Return codes: -1 open/read,
// -2 bad header, -3 ndim != 3, -4 too many voxels for the buffer, -5
// truncated data, -6 unsupported datatype.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>
#include <atomic>
#include <zlib.h>

namespace {

constexpr int kHdrSize = 348;

struct Header {
  int ndim;
  int64_t shape[7];
  int datatype;
  float scl_slope, scl_inter;
  int64_t vox_offset;
  bool swap;  // byte-swapped file
};

uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }
uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }
uint64_t bswap64(uint64_t v) { return __builtin_bswap64(v); }

int16_t rd_i16(const unsigned char* p, bool swap) {
  uint16_t v; memcpy(&v, p, 2); if (swap) v = bswap16(v);
  int16_t out; memcpy(&out, &v, 2); return out;
}
int32_t rd_i32(const unsigned char* p, bool swap) {
  uint32_t v; memcpy(&v, p, 4); if (swap) v = bswap32(v);
  int32_t out; memcpy(&out, &v, 4); return out;
}
float rd_f32(const unsigned char* p, bool swap) {
  uint32_t v; memcpy(&v, p, 4); if (swap) v = bswap32(v);
  float out; memcpy(&out, &v, 4); return out;
}

// A malloc'd byte buffer: grown without zero-filling what will be
// overwritten, and kept by its thread from one volume to the next, so its
// pages are faulted in once per thread rather than once per volume.
struct Bytes {
  unsigned char* data = nullptr;
  size_t size = 0;
  size_t cap = 0;
  ~Bytes() { free(data); }
  bool reserve(size_t n) {
    if (n <= cap) return true;
    void* p = realloc(data, n);
    if (!p) return false;
    data = static_cast<unsigned char*>(p);
    cap = n;
    return true;
  }
};

// Read the whole file: one fread for an uncompressed file, gzread into a
// buffer sized from the gzip ISIZE trailer (the uncompressed size mod 2^32)
// for a compressed one.
bool read_all(const char* path, Bytes& out) {
  out.size = 0;
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[2] = {0, 0};
  size_t got = fread(magic, 1, 2, f);
  if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return false; }
  long file_size = ftell(f);
  if (file_size < 0) { fclose(f); return false; }
  const bool gz = got == 2 && magic[0] == 0x1f && magic[1] == 0x8b;
  if (!gz) {
    rewind(f);
    if (!out.reserve(file_size > 0 ? file_size : 1)) { fclose(f); return false; }
    out.size = fread(out.data, 1, file_size, f);
    fclose(f);
    return out.size == static_cast<size_t>(file_size);
  }
  size_t want = 1 << 20;
  if (file_size >= 4 && fseek(f, -4, SEEK_END) == 0) {
    unsigned char t[4];
    if (fread(t, 1, 4, f) == 4)
      want = (size_t)t[0] | ((size_t)t[1] << 8) | ((size_t)t[2] << 16) | ((size_t)t[3] << 24);
  }
  fclose(f);
  gzFile g = gzopen(path, "rb");
  // one byte more than the trailer says, to see the end without growing
  if (!g || !out.reserve(want + 1)) { if (g) gzclose(g); return false; }
  for (;;) {
    if (out.size == out.cap && !out.reserve(2 * out.cap)) { gzclose(g); return false; }
    size_t room = out.cap - out.size;
    int n = gzread(g, out.data + out.size, room > (1u << 30) ? (1u << 30) : (unsigned)room);
    if (n < 0) { gzclose(g); return false; }
    if (n == 0) break;
    out.size += static_cast<size_t>(n);
  }
  gzclose(g);
  return true;
}

bool parse_header(const Bytes& buf, Header* h) {
  if (buf.size < kHdrSize) return false;
  int32_t sizeof_hdr = rd_i32(buf.data, false);
  h->swap = false;
  if (sizeof_hdr != 348) {
    sizeof_hdr = rd_i32(buf.data, true);
    if (sizeof_hdr != 348) return false;
    h->swap = true;
  }
  const unsigned char* magic = buf.data + 344;
  if (memcmp(magic, "n+1", 3) != 0 && memcmp(magic, "ni1", 3) != 0)
    return false;
  h->ndim = rd_i16(buf.data + 40, h->swap);
  if (h->ndim < 1 || h->ndim > 7) return false;
  for (int i = 0; i < h->ndim; ++i)
    h->shape[i] = rd_i16(buf.data + 42 + 2 * i, h->swap);
  h->datatype = rd_i16(buf.data + 70, h->swap);
  for (int i = 0; i < h->ndim; ++i)
    if (h->shape[i] <= 0) return false;  // corrupt dims -> huge/negative n
  h->vox_offset = static_cast<int64_t>(rd_f32(buf.data + 108, h->swap));
  // a corrupt/negative vox_offset would point `data` before the buffer and
  // make `avail` huge -> out-of-bounds read in convert()
  if (h->vox_offset < kHdrSize) return false;
  h->scl_slope = rd_f32(buf.data + 112, h->swap);
  h->scl_inter = rd_f32(buf.data + 116, h->swap);
  if (h->scl_slope == 0.0f || std::isnan(h->scl_slope)) h->scl_slope = 1.0f;
  if (std::isnan(h->scl_inter)) h->scl_inter = 0.0f;
  return true;
}

template <typename T>
inline float load(const unsigned char* p, bool swap) {
  T v;
  memcpy(&v, p, sizeof(T));
  if (swap) {
    if (sizeof(T) == 2) { uint16_t u; memcpy(&u, &v, 2); u = bswap16(u); memcpy(&v, &u, 2); }
    else if (sizeof(T) == 4) { uint32_t u; memcpy(&u, &v, 4); u = bswap32(u); memcpy(&v, &u, 4); }
    else if (sizeof(T) == 8) { uint64_t u; memcpy(&u, &v, 8); u = bswap64(u); memcpy(&v, &u, 8); }
  }
  return static_cast<float>(v);
}

// Convert the (Z, Y, X) file block (x fastest) to float32 [x][y][z] in C
// order, 16 x at a time: each step reads the 16 adjacent x of one (z, y)
// row of the file and appends one value to each of 16 output rows (one per
// x), so the output is written as 16 sequential streams (a fresh buffer's
// pages fault in order) and each input line is used whole.
template <typename T>
void convert_transpose(const unsigned char* src, float* dst, int64_t X, int64_t Y,
                       int64_t Z, bool swap, float slope, float inter) {
  constexpr int64_t kXTile = 16;
  const bool scale = !(slope == 1.0f && inter == 0.0f);
  const int64_t plane = Y * Z;  // output stride between consecutive x
  for (int64_t x0 = 0; x0 < X; x0 += kXTile) {
    const int64_t xw = x0 + kXTile < X ? kXTile : X - x0;
    for (int64_t y = 0; y < Y; ++y) {
      for (int64_t z = 0; z < Z; ++z) {
        const unsigned char* row = src + ((z * Y + y) * X + x0) * sizeof(T);
        float* d = dst + x0 * plane + y * Z + z;
        for (int64_t i = 0; i < xw; ++i) {
          float v = load<T>(row + i * sizeof(T), swap);
          d[i * plane] = scale ? v * slope + inter : v;
        }
      }
    }
  }
}

int decode_one(const char* path, float* out, int64_t cap, int32_t* shape_out,
               int normalize) {
  thread_local Bytes buf;
  if (!read_all(path, buf)) return -1;
  Header h;
  if (!parse_header(buf, &h)) return -2;
  if (h.ndim != 3) return -3;
  const int64_t X = h.shape[0], Y = h.shape[1], Z = h.shape[2];
  const int64_t n = X * Y * Z;
  if (n > cap) return -4;
  if ((int64_t)buf.size < h.vox_offset) return -5;
  const unsigned char* data = buf.data + h.vox_offset;
  const int64_t avail = buf.size - h.vox_offset;
  auto need = [&](size_t e) { return avail >= (int64_t)(n * e); };
  const float sl = h.scl_slope, in = h.scl_inter;
  switch (h.datatype) {
    case 2:   if (!need(1)) return -5; convert_transpose<uint8_t>(data, out, X, Y, Z, false, sl, in); break;
    case 256: if (!need(1)) return -5; convert_transpose<int8_t>(data, out, X, Y, Z, false, sl, in); break;
    case 4:   if (!need(2)) return -5; convert_transpose<int16_t>(data, out, X, Y, Z, h.swap, sl, in); break;
    case 512: if (!need(2)) return -5; convert_transpose<uint16_t>(data, out, X, Y, Z, h.swap, sl, in); break;
    case 8:   if (!need(4)) return -5; convert_transpose<int32_t>(data, out, X, Y, Z, h.swap, sl, in); break;
    case 768: if (!need(4)) return -5; convert_transpose<uint32_t>(data, out, X, Y, Z, h.swap, sl, in); break;
    case 16:  if (!need(4)) return -5; convert_transpose<float>(data, out, X, Y, Z, h.swap, sl, in); break;
    case 64:  if (!need(8)) return -5; convert_transpose<double>(data, out, X, Y, Z, h.swap, sl, in); break;
    default: return -6;
  }

  if (normalize) {  // fused min-max to [0, 1]
    float mn = out[0], mx = out[0];
    for (int64_t i = 1; i < n; ++i) {
      mn = out[i] < mn ? out[i] : mn;
      mx = out[i] > mx ? out[i] : mx;
    }
    float range = mx - mn;
    if (range < 1e-12f) {
      for (int64_t i = 0; i < n; ++i) out[i] = 0.0f;
    } else {
      float inv = 1.0f / range;
      for (int64_t i = 0; i < n; ++i) out[i] = (out[i] - mn) * inv;
    }
  }

  shape_out[0] = (int32_t)X;
  shape_out[1] = (int32_t)Y;
  shape_out[2] = (int32_t)Z;
  return 0;
}

}  // namespace

extern "C" {

// Decode one volume into `out` (float32 [x][y][z], capacity `cap` elements).
// Returns 0 on success; negative error codes otherwise.
int mad_read_nifti(const char* path, float* out, int64_t cap,
                   int32_t* shape_out, int normalize) {
  return decode_one(path, out, cap, shape_out, normalize);
}

// Decode `n` volumes in parallel on `n_threads` worker threads. All
// volumes must share `vol_elems` elements; outputs are packed
// consecutively in `out`. Per-volume status lands in `status`.
int mad_read_batch(const char** paths, int n, float* out, int64_t vol_elems,
                   int32_t* shapes, int* status, int normalize,
                   int n_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      status[i] = decode_one(paths[i], out + (int64_t)i * vol_elems,
                             vol_elems, shapes + 3 * i, normalize);
      if (status[i] != 0) failures.fetch_add(1);
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  if (nt > n) nt = n;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
