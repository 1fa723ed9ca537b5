// K6: monotonic alignment search (MAS), the Viterbi forward DP and the
// backtrack, in one launch.
//
// Replaces the Pallas kernel maximum_path_pallas of
// diff_vits_tpu/ops/mas_pallas.py:89 (_mas_kernel :38, pallas_call :117),
// the drop-in for the lax.scan MAS of diff_vits_tpu/ops/mas.py:28-103, whose
// edge rules it keeps (ops/mas.py:10-16):
//   value[y, x] = raw[y, x] + max(v_cur, v_prev) inside the band
//                 [max(0, t_x + y - t_y), min(t_x, y + 1)), raw outside it;
//   v_cur  = value[y-1, x],   -1e9 when x == y;
//   v_prev = value[y-1, x-1], at x == 0: 0 when y == 0, else -1e9;
//   backtrack from x = t_x - 1, moving left at row y when
//   x != 0 and (x == y or value[y-1, x] < value[y-1, x-1]).
// The lengths come from the mask as the reference derives them:
// t_y = sum_y mask[y, 0], t_x = sum_x mask[0, x].
//
// Design: one block per batch element, one thread per text column (Tx up
// to 4096: up to four columns a thread). The Pallas kernel keeps the whole
// [Ty, Tx] value matrix in VMEM; at the training shape it is 961 KB of
// float32, more than the 227 KB of shared memory a Hopper block has. The
// backtrack needs only one bit of it per cell: whether the path moves left
// when it reaches that cell, which is the rule above evaluated on the stored
// row y-1 (out-of-band cells hold their raw score, as in the reference).
// So the block keeps two value rows and a [Ty, ceil(Tx/32)] bit matrix
// (30 KB at 400 x 601) in shared memory, set by one warp ballot per 32
// columns. The forward stops at the item's own t_y; the next row's scores
// are loaded before the current row is combined, so their latency overlaps
// the row's work. One thread then walks the bits back, and the block
// writes the whole path (mask value on the path, 0 elsewhere) in
// neg_cent's dtype.
//
// Bound on the H100: what the function must move is the scores of the
// rows it runs and the path it writes (at most 61.5 MB at 32 x 400 x 601
// float32, ~18 us at 3.35 TB/s), but the real limit is the serial depth: t_y
// dependent row steps, each a block barrier, then t_y dependent bit reads.
// Rows of different batch items run on different SMs in parallel.
#include "common.cuh"

namespace dvt {

constexpr float kNeg = -1e9f;
constexpr int kMasMaxThreads = 1024;
constexpr int kMasMaxCols = 4;
constexpr size_t kMasMaxSmem = 232448 - 1024;  // dynamic; leaves room for scratch

__global__ void __launch_bounds__(kMasMaxThreads)
mas_kernel(const void* __restrict__ neg_cent, int nc_dt,
           const float* __restrict__ mask, void* __restrict__ path,
           int path_dt, int Ty, int Tx, int words) {
  extern __shared__ float smem[];
  __shared__ float scratch[kMasMaxThreads / 32];
  float* prev = smem;                                      // [Tx]
  float* cur = smem + Tx;                                  // [Tx]
  int* idx = reinterpret_cast<int*>(smem + 2 * Tx);        // [Ty]
  unsigned int* bits = reinterpret_cast<unsigned int*>(idx + Ty);  // [Ty][words]

  const long base = (long)blockIdx.x * Ty * Tx;
  const float* m = mask + base;
  const int ncols = (Tx + blockDim.x - 1) / blockDim.x;

  float sy = 0.f, sx = 0.f;
  for (int i = threadIdx.x; i < Ty; i += blockDim.x) sy += m[(long)i * Tx];
  for (int i = threadIdx.x; i < Tx; i += blockDim.x) sx += m[i];
  const int t_y = min(Ty, (int)block_sum(sy, scratch));
  const int t_x = min(Tx, (int)block_sum(sx, scratch));

  float raw[kMasMaxCols];
#pragma unroll
  for (int c = 0; c < kMasMaxCols; ++c) {
    const int x = threadIdx.x + c * blockDim.x;
    raw[c] = 0.f;
    if (c < ncols && x < Tx) {
      prev[x] = 0.f;
      if (t_y > 0) raw[c] = ld(neg_cent, base + x, nc_dt);
    }
  }
  __syncthreads();

  for (int y = 0; y < t_y; ++y) {
    float next[kMasMaxCols];
#pragma unroll
    for (int c = 0; c < kMasMaxCols; ++c) {
      const int x = threadIdx.x + c * blockDim.x;
      next[c] = (c < ncols && x < Tx && y + 1 < t_y)
                    ? ld(neg_cent, base + (long)(y + 1) * Tx + x, nc_dt)
                    : 0.f;
    }
    const int lower = max(0, t_x + y - t_y), upper = min(t_x, y + 1);
#pragma unroll
    for (int c = 0; c < kMasMaxCols; ++c) {
      if (c >= ncols) break;  // uniform across the block
      const int x = threadIdx.x + c * blockDim.x;
      bool move = false;
      if (x < Tx) {
        const float pc = prev[x];
        const float pl = x > 0 ? prev[x - 1] : 0.f;
        const float v_cur = x == y ? kNeg : pc;
        const float v_prev = x == 0 ? (y == 0 ? 0.f : kNeg) : pl;
        const float acc = raw[c] + fmaxf(v_cur, v_prev);
        cur[x] = (x >= lower && x < upper) ? acc : raw[c];
        move = x != 0 && (x == y || pc < pl);
      }
      // blockDim.x is a multiple of 32: lane 0 holds the word's first column
      const unsigned int word = __ballot_sync(0xffffffffu, move);
      if ((threadIdx.x & 31) == 0 && x < Tx) bits[(long)y * words + (x >> 5)] = word;
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
#pragma unroll
    for (int c = 0; c < kMasMaxCols; ++c) raw[c] = next[c];
  }

  if (threadIdx.x == 0) {
    int index = t_x - 1;
    for (int y = t_y - 1; y >= 0; --y) {
      idx[y] = index;
      if (index > 0 && ((bits[(long)y * words + (index >> 5)] >> (index & 31)) & 1u))
        --index;
    }
  }
  __syncthreads();

  const long cells = (long)Ty * Tx;
  for (long i = threadIdx.x; i < cells; i += blockDim.x) {
    const int y = (int)(i / Tx), x = (int)(i - (long)y * Tx);
    const float v = (y < t_y && x == idx[y]) ? m[i] : 0.f;
    st(path, base + i, v, path_dt);
  }
}

}  // namespace dvt

// neg_cent [B, Ty, Tx] float32 or bfloat16, mask [B, Ty, Tx] float32, path
// [B, Ty, Tx] in path_dt; all contiguous. Refuses (-1) Tx > 4096 and shapes
// whose shared memory, 4 * (2 Tx + Ty + Ty * ceil(Tx / 32)) bytes, exceeds
// the block's limit; ops/mas.py raises on the refusal.
extern "C" int dvt_mas(const void* neg_cent, int nc_dt, const float* mask,
                       void* path, int path_dt, int B, int Ty, int Tx,
                       void* stream) {
  if (B <= 0 || Ty <= 0 || Tx <= 0) return -1;
  const int words = (Tx + 31) / 32;
  const int threads = words * 32 < dvt::kMasMaxThreads ? words * 32
                                                       : dvt::kMasMaxThreads;
  if ((Tx + threads - 1) / threads > dvt::kMasMaxCols) return -1;
  const long smem = 4L * (2L * Tx + Ty + (long)Ty * words);
  if (smem > (long)dvt::kMasMaxSmem) return -1;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dvt::mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dvt::mas_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      neg_cent, nc_dt, mask, path, path_dt, Ty, Tx, words);
  return (int)cudaGetLastError();
}
