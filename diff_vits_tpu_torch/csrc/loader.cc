// Native batch loader: .npy mel loading + random prompt-slice + collate.
//
// Role parity with the reference's data pipeline (dataset.py:145-287 +
// DataLoader(num_workers=32), model3.py:1304-1309): the reference reaches
// native code through torch's C++ DataLoader workers; here the whole
// per-step feature path (file read, crop, prompt split, zero-pad collate)
// runs in C++ with OpenMP batch parallelism, called from the Python
// TrainLoader through ctypes. Text id arrays are parsed once in Python at
// init (cheap, cached) — only the per-step mel work is hot.
//
// Build: g++ -O3 -fopenmp -shared -fPIC -o libloader.so loader.cc
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

// splitmix64 — deterministic per (seed, epoch, index) stream
static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

// uniform int in [lo, hi] inclusive
static inline int64_t rand_range(uint64_t& s, int64_t lo, int64_t hi) {
  if (hi <= lo) return lo;
  return lo + (int64_t)(splitmix64(s) % (uint64_t)(hi - lo + 1));
}

// Minimal .npy v1.x reader for C-order arrays. Returns number of rows
// (frames) or -1 on failure. Data is written to `out` (up to max_rows rows
// of `cols` float32), after an optional random crop chosen with `rng`.
// `total_rows_out` receives the uncropped length.
struct NpyInfo {
  int64_t rows, cols;
  bool f8;  // '<f8' vs '<f4'
  long data_off;
};

static bool npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    hlen = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
  }
  std::string hdr(hlen, '\0');
  if (fread(&hdr[0], 1, hlen, f) != hlen) return false;
  if (hdr.find("'fortran_order': True") != std::string::npos) return false;
  bool f8;
  if (hdr.find("'<f4'") != std::string::npos) f8 = false;
  else if (hdr.find("'<f8'") != std::string::npos) f8 = true;
  else return false;
  size_t sp = hdr.find("'shape':");
  if (sp == std::string::npos) return false;
  sp = hdr.find('(', sp);
  long long r = 0, c = 0;
  if (sscanf(hdr.c_str() + sp, "(%lld, %lld", &r, &c) != 2) return false;
  info->rows = r;
  info->cols = c;
  info->f8 = f8;
  info->data_off = ftell(f);
  return true;
}

// read rows [start, start+n) into out (float32)
static bool npy_read_rows(FILE* f, const NpyInfo& in, int64_t start,
                          int64_t n, float* out) {
  size_t esz = in.f8 ? 8 : 4;
  if (fseek(f, in.data_off + (long)(start * in.cols * esz), SEEK_SET) != 0)
    return false;
  if (!in.f8)
    return fread(out, 4, (size_t)(n * in.cols), f) == (size_t)(n * in.cols);
  std::string buf((size_t)(n * in.cols) * 8, '\0');
  if (fread(&buf[0], 8, (size_t)(n * in.cols), f) != (size_t)(n * in.cols))
    return false;
  const double* d = (const double*)buf.data();
  for (int64_t i = 0; i < n * in.cols; ++i) out[i] = (float)d[i];
  return true;
}

}  // namespace

extern "C" {

// Load a batch of mel .npy files, apply the reference's random crop +
// prompt-span split (dataset.py:196-214), and zero-pad-collate into static
// [n, T, C] / [n, S, C] buffers.
//
// paths:      n NUL-terminated file paths
// seed:       stream seed; item i uses (seed, i)
// spec:       [n, T, C] out (pre-zeroed NOT required — fully overwritten)
// refer1/2:   [n, S, C] out
// *_len:      [n] out int32 (0 => item failed / too short; caller skips)
// Returns number of successfully loaded items.
int dvt_load_batch(const char** paths, int64_t n,
                   int64_t min_frames, int64_t max_frames, uint64_t seed,
                   float* spec, int32_t* spec_len,
                   float* refer1, int32_t* refer1_len,
                   float* refer2, int32_t* refer2_len,
                   int64_t T, int64_t S, int64_t C) {
  int ok_count = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : ok_count)
  for (int64_t i = 0; i < n; ++i) {
    float* sp = spec + i * T * C;
    float* r1 = refer1 + i * S * C;
    float* r2 = refer2 + i * S * C;
    memset(sp, 0, sizeof(float) * T * C);
    memset(r1, 0, sizeof(float) * S * C);
    memset(r2, 0, sizeof(float) * S * C);
    spec_len[i] = refer1_len[i] = refer2_len[i] = 0;

    FILE* f = fopen(paths[i], "rb");
    if (!f) continue;
    NpyInfo info;
    if (!npy_header(f, &info) || info.cols != C ||
        info.rows < min_frames) {
      fclose(f);
      continue;
    }
    uint64_t rs = seed * 0x9e3779b97f4a7c15ull + (uint64_t)i * 0x632be59bd9b4e019ull;
    (void)splitmix64(rs);

    int64_t rows = info.rows;
    int64_t start = 0;
    int64_t len = rows;
    if (rows > max_frames) {
      start = rand_range(rs, 0, rows - max_frames);
      len = max_frames;
    }
    if (len > T) len = T;
    if (!npy_read_rows(f, info, start, len, sp)) {
      fclose(f);
      continue;
    }
    fclose(f);

    // prompt span l ~ U[len/3, 2*len/3] at offset u ~ U[0, len-l]
    int64_t l = rand_range(rs, len / 3, len / 3 * 2);
    int64_t u = rand_range(rs, 0, len - l);
    int64_t v = u + l;
    int64_t n1 = std::min(l, S);
    memcpy(r1, sp + u * C, sizeof(float) * n1 * C);
    int64_t n2a = std::min(u, S);
    memcpy(r2, sp, sizeof(float) * n2a * C);
    int64_t n2b = std::min(len - v, S - n2a);
    if (n2b > 0) memcpy(r2 + n2a * C, sp + v * C, sizeof(float) * n2b * C);

    spec_len[i] = (int32_t)len;
    refer1_len[i] = (int32_t)n1;
    refer2_len[i] = (int32_t)(n2a + (n2b > 0 ? n2b : 0));
    ok_count += 1;
  }
  return ok_count;
}

}  // extern "C"
