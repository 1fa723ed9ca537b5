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
// The Pallas kernel keeps the whole [Ty, Tx] value matrix in VMEM; at the
// training shape it is 961 KB of float32, more than the 227 KB of shared
// memory a Hopper block has. The backtrack needs one bit of it per cell:
// whether the path moves left when it reaches that cell, which is the rule
// above on row y-1 (out-of-band cells hold their raw score, as in the
// reference). So a block keeps a [Ty, ceil(Tx/32)] bit matrix (30 KB at
// 400 x 601), one word for each 32 consecutive columns.
//
// What bounds it on the H100: what it must move is the scores of the rows
// it runs and the path it writes (53.8 MB at 32 x 400 x 601 float32, ~16 us
// at 3.35 TB/s), but its floor is its serial depth: t_y dependent row steps,
// then t_y dependent reads of the bits. The design keeps each row step off
// memory latency and off block-wide barriers:
//   * one block per item (a cluster of two blocks: the second zeroes the
//     item's path meanwhile, on another SM, so its stores do not compete
//     with the DP's instructions); its DP warps hold the value row in
//     registers, column x = 32 (CPL w + c) + lane in register c of lane
//     `lane` of DP warp w (CPL = 8 columns a lane). value[y-1, x-1] is one shuffle from the lane below (lane 0:
//     register c-1 of lane 31), taken for the next row before the row's
//     barrier so the barrier hides it; the warp's first column takes row
//     y-1's last value of the warp before it through shared memory; a row
//     ends in a named barrier of the DP warps alone (none when one warp
//     holds the row);
//   * the move bits of column group c are one ballot: exactly the word of
//     32 consecutive columns the backtrack reads;
//   * the block's kLoadWarps other warps stage the scores in a ring of
//     kSlots chunks of kChunk rows (16-byte cp.async of the chunk's bytes
//     as they lie in memory), up to kSlots chunks ahead of the DP, handing
//     each chunk over by a named barrier pair (full / empty) per slot: a
//     row step reads shared memory that is already there and issues no
//     load (a ring that the DP warps fill themselves, 4-byte cp.async a
//     column, measured within 4%: tools/torch_mas_probe.py). Shapes whose
//     ring does not fit beside the bits load the next row into the DP
//     warps' registers one row ahead instead (twice as slow a row);
//   * after the backtrack and a cluster barrier, one pass writes the t_y
//     path cells (the mask's value there). Rows past t_y stay zero.
// What holds it above the byte bound (PERF.md): each row step is a serial
// chain (the ring's read, the neighbour warp's value, the compares, the
// ballots, the bits' store, the barrier) of ~0.35 us at the training
// shape, each link a few tens of ns (tools/torch_mas_probe.py compiles
// each out); the backtrack adds a dependent shared-memory read a row.
// Skipping the column groups outside a row's band, or one DP warp of 24
// columns a lane (no barrier), measured slower.
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace dvt {

namespace cg = cooperative_groups;

constexpr float kNeg = -1e9f;
// the limits of the first version (one thread a column, up to 1024
// threads and 4 columns each; two value rows, the lengths' path indices
// and the bits in dynamic shared memory), kept so that the kernel takes
// and refuses exactly the shapes it took and refused
constexpr int kMasMaxThreads = 1024;
constexpr int kMasMaxCols = 4;
constexpr size_t kMasMaxSmem = 232448 - 1024;  // dynamic; leaves room for scratch
constexpr int kMaxDpWarps = 16;
constexpr int kLoadWarps = 4;  // warps staging the scores for the DP
constexpr int kChunk = 8;      // rows a ring slot
constexpr int kSlots = 4;      // ring slots; named barriers 2.. full, 6.. empty

// Zero nbytes (a multiple of 2) at p: 16-byte stores between 2-byte
// edges, thread `t` of `n`.
__device__ __forceinline__ void zero_bytes(char* p, long nbytes, int t,
                                           int n) {
  const long lead = (16 - (long)(reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  const long head = lead < nbytes ? lead : nbytes;
  const long body = (nbytes - head) / 16;
  for (long i = t; i < head / 2; i += n)
    reinterpret_cast<unsigned short*>(p)[i] = 0;
  uint4* pb = reinterpret_cast<uint4*>(p + head);
  for (long i = t; i < body; i += n) pb[i] = make_uint4(0u, 0u, 0u, 0u);
  unsigned short* pt = reinterpret_cast<unsigned short*>(p + head + body * 16);
  for (long i = t; i < (nbytes - head - body * 16) / 2; i += n) pt[i] = 0;
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int CPL, bool kRing>
__global__ void __launch_bounds__((kMaxDpWarps + kLoadWarps) * 32)
mas_kernel(const void* __restrict__ neg_cent, int nc_dt,
           const float* __restrict__ mask, void* __restrict__ path,
           int path_dt, int Ty, int Tx, int words, int dp_warps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float scratch[32];
  __shared__ float edge[2][kMaxDpWarps];  // a DP warp's last value, by row
  unsigned* bits = reinterpret_cast<unsigned*>(smem);           // [Ty][words]
  int* idx = reinterpret_cast<int*>(bits + (long)Ty * words);    // [Ty]
  // [kSlots][slot]: chunk k's kChunk rows as they lie in memory, from the
  // 16-byte boundary at or before their first score
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      smem + ((4L * ((long)Ty * words + Ty) + 15) & ~15L));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a cluster per item: block 0 runs the DP, block 1 zeroes the path
  cg::cluster_group cluster = cg::this_cluster();
  const long base = (long)(blockIdx.x / 2) * Ty * Tx;
  if (cluster.block_rank() == 1) {
    const int esz = path_dt == kBF16 ? 2 : 4;
    zero_bytes(static_cast<char*>(path) + base * esz, (long)Ty * Tx * esz,
               tid, blockDim.x);
    cluster.sync();  // the path is zero (release)
    return;
  }
  const float* m = mask + base;
  if (tid < 2 * kMaxDpWarps) edge[tid / kMaxDpWarps][tid % kMaxDpWarps] = 0.f;
  float sy = 0.f, sx = 0.f;
  for (int i = tid; i < Ty; i += blockDim.x) sy += m[(long)i * Tx];
  for (int i = tid; i < Tx; i += blockDim.x) sx += m[i];
  const int t_y = min(Ty, (int)block_sum(sy, scratch));
  const int t_x = min(Tx, (int)block_sum(sx, scratch));
  const int chunks = (t_y + kChunk - 1) / kChunk;
  const int handover = blockDim.x;  // the DP and load warps, every barrier
  const int nsz = nc_dt == kBF16 ? 2 : 4;
  const long slot_bytes = ((long)kChunk * Tx * nsz + 16 + 15) & ~15L;
  const char* nc = static_cast<const char*>(neg_cent);
  // where chunk k's first score lies in its slot
  auto lead = [&](int k) {
    return (int)(reinterpret_cast<uintptr_t>(
                     nc + (base + (long)k * kChunk * Tx) * nsz) &
                 15);
  };

  if (warp < dp_warps) {
    constexpr int W = 32 * CPL;  // columns a DP warp
    const int x0 = warp * W + lane;
    auto load = [&](float (&r)[CPL], int y) {  // row y into registers
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int x = x0 + 32 * c;
        r[c] = (y < t_y && x < Tx) ? ld(neg_cent, base + (long)y * Tx + x,
                                        nc_dt)
                                   : 0.f;
      }
    };

    // below[c]: lane - 1's prev[c] (lane 0: lane 31's), shuffled for the
    // next row before the row's barrier, so the barrier hides its latency
    float prev[CPL], below[CPL], raw[CPL], next[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) prev[c] = below[c] = 0.f;
    if constexpr (!kRing) load(next, 0);
    for (int y = 0; y < t_y; ++y) {
      if constexpr (kRing) {
        const int k = y / kChunk, slot = k % kSlots;
        if (y % kChunk == 0) bar_sync(2 + slot, handover);  // chunk k is in
        const unsigned char* row = ring + slot * slot_bytes + lead(k) +
                                   (long)(y % kChunk) * Tx * nsz;
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          raw[c] = x0 + 32 * c < Tx ? ld(row, x0 + 32 * c, nc_dt) : 0.f;
        // the loaders refill the slot with chunk k + kSlots, if there is one
        if ((y % kChunk == kChunk - 1 || y == t_y - 1) && k + kSlots < chunks)
          bar_arrive(2 + kSlots + slot, handover);
      } else {
#pragma unroll
        for (int c = 0; c < CPL; ++c) raw[c] = next[c];
        load(next, y + 1);
      }
      // value[y-1, x-1]: lane - 1's register c; for lane 0, lane 31's
      // register c - 1, or the warp before's last column (0 before row 0)
      const float left = warp > 0 ? edge[(y + 1) & 1][warp - 1] : 0.f;
      const int lower = max(0, t_x + y - t_y), upper = min(t_x, y + 1);
      unsigned mine = 0u;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int x = x0 + 32 * c;
        const float pc = prev[c];
        const float pl = lane == 0 ? (c == 0 ? left : below[c - 1]) : below[c];
        const float v_cur = x == y ? kNeg : pc;
        const float v_prev = x == 0 ? (y == 0 ? 0.f : kNeg) : pl;
        const float acc = raw[c] + fmaxf(v_cur, v_prev);
        prev[c] = (x >= lower && x < upper) ? acc : raw[c];
        const unsigned word =
            __ballot_sync(kFull, x != 0 && (x == y || pc < pl));
        if (lane == c) mine = word;
      }
      // word w CPL + c holds columns 32 (w CPL + c) .. + 31: x >> 5
      if (lane < CPL && warp * CPL + lane < words)
        bits[(long)y * words + warp * CPL + lane] = mine;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        below[c] = __shfl_sync(kFull, prev[c], (lane + 31) & 31);
      if (dp_warps > 1) {
        if (lane == 31) edge[y & 1][warp] = prev[CPL - 1];
        bar_sync(1, 32 * dp_warps);  // the row's bits and edges are written
      }
    }
    __syncwarp();
    if (tid == 0) {  // one dependent shared-memory read a row
      int index = t_x - 1;
      const unsigned* row = bits + (long)(t_y - 1) * words;
      for (int y = t_y - 1; y >= 0; --y, row -= words) {
        idx[y] = index;
        const unsigned w = row[max(index, 0) >> 5];  // t_x = 0: index -1
        index -= (int)((w >> (index & 31)) & 1u) & (index > 0);
      }
    }
  } else if (kRing) {
    // the load warps: chunk k of rows into slot k % kSlots by 16-byte
    // cp.async, once the DP warps are done with chunk k - kSlots there;
    // kSlots - 1 chunks in flight: chunk j is handed over once chunk
    // j + kSlots - 2's copies are issued
    constexpr int kInFlight = kSlots - 1;
    const int lt = tid - 32 * dp_warps, nl = blockDim.x - 32 * dp_warps;
    const char* nc_end = nc + (long)gridDim.x / 2 * Ty * Tx * nsz;
    for (int k = 0; k < chunks + kInFlight - 1; ++k) {
      if (k < chunks) {
        const int slot = k % kSlots;
        if (k >= kSlots) bar_sync(2 + kSlots + slot, handover);
        const char* first = nc + (base + (long)k * kChunk * Tx) * nsz;
        const char* a0 = first - lead(k);
        const long n =
            lead(k) + (long)min(kChunk, t_y - k * kChunk) * Tx * nsz;
        unsigned char* dst = ring + slot * slot_bytes;
        for (long i = lt; i < (n + 15) / 16; i += nl) {
          const char* src = a0 + 16 * i;
          const long left = nc_end - src;  // bytes left in the tensor
          const int bytes = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
          cp_async16(dst + 16 * i, bytes > 0 ? src : nc, bytes);
        }
      }
      cp_async_commit();
      const int j = k - (kInFlight - 1);
      if (j >= 0) {
        cp_async_wait<kInFlight - 1>();  // chunk j's copies, this thread's
        bar_arrive(2 + j % kSlots, handover);  // ... and every one's
      }
    }
  }
  __syncthreads();  // the path indices are known
  cluster.sync();   // the path is zero (acquire)
  for (int y = tid; y < t_y; y += blockDim.x) {
    const int x = idx[y];
    if (x >= 0) st(path, base + (long)y * Tx + x, m[(long)y * Tx + x], path_dt);
  }
}

template <int CPL, bool kRing>
int launch(const void* neg_cent, int nc_dt, const float* mask, void* path,
           int path_dt, int B, int Ty, int Tx, int words, int dp_warps,
           size_t smem, cudaStream_t stream) {
  auto kernel = mas_kernel<CPL, kRing>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * B);
  cfg.blockDim = dim3(32 * (dp_warps + kLoadWarps));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;  // an item's DP block and its fill block
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, neg_cent, nc_dt, mask, path, path_dt,
                         Ty, Tx, words, dp_warps);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int CPL>
int launch_cols(const void* neg_cent, int nc_dt, const float* mask,
                void* path, int path_dt, int B, int Ty, int Tx, int words,
                cudaStream_t stream) {
  const int dp_warps = (Tx + 32 * CPL - 1) / (32 * CPL);
  if (dp_warps > kMaxDpWarps) return -1;
  const size_t fixed = (4 * ((size_t)Ty * words + Ty) + 15) & ~(size_t)15;
  const size_t ring =
      kSlots * (((size_t)kChunk * Tx * (nc_dt == kBF16 ? 2 : 4) + 31) & ~(size_t)15);
  if (fixed + ring <= kMasMaxSmem)
    return launch<CPL, true>(neg_cent, nc_dt, mask, path, path_dt, B, Ty, Tx,
                             words, dp_warps, fixed + ring, stream);
  return launch<CPL, false>(neg_cent, nc_dt, mask, path, path_dt, B, Ty, Tx,
                            words, dp_warps, fixed, stream);
}

}  // namespace dvt

// neg_cent [B, Ty, Tx] float32 or bfloat16, mask [B, Ty, Tx] float32, path
// [B, Ty, Tx] in path_dt; all contiguous. Refuses (-1) what the first
// version refused: Tx > 4096 and shapes whose shared memory under its
// layout, 4 * (2 Tx + Ty + Ty * ceil(Tx / 32)) bytes, exceeds the block's
// limit (this kernel needs at most that much); ops/mas.py raises on the
// refusal.
extern "C" int dvt_mas(const void* neg_cent, int nc_dt, const float* mask,
                       void* path, int path_dt, int B, int Ty, int Tx,
                       void* stream) {
  if (B <= 0 || Ty <= 0 || Tx <= 0 || B > 0x3fffffff) return -1;
  const int words = (Tx + 31) / 32;
  const int threads = words * 32 < dvt::kMasMaxThreads ? words * 32
                                                       : dvt::kMasMaxThreads;
  if ((Tx + threads - 1) / threads > dvt::kMasMaxCols) return -1;
  const long smem = 4L * (2L * Tx + Ty + (long)Ty * words);
  if (smem > (long)dvt::kMasMaxSmem) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 8 columns a DP lane, 256 a warp, up to 16 warps: one layout for
  // every Tx (4 a lane at Tx = 601 measured within 6% of it, faster in one
  // run and slower in another: tools/torch_mas_probe.py, PERF.md)
  return dvt::launch_cols<8>(neg_cent, nc_dt, mask, path, path_dt, B, Ty, Tx,
                             words, s);
}
