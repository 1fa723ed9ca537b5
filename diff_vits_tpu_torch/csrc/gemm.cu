// Tiled GEMM with fused prologues and epilogues: the matrix products of the
// four fused UNet kernels (K1-K4 of the JAX package) and of K5's
// projections.
//
//   out[m, n] = epilogue( sum_k prologue(A)[m, k] * Bm[k, n] )
//
// Bm is read through two strides, so a weight is taken in the layout its
// module stores it (nn.Linear [N, K], nn.Conv1d [N, Ci, taps]: k fastest)
// or in the JAX package's (Dense [K, N], Conv [taps, Ci, N]: n fastest)
// without a copy: element (k, n) lies at k * sb_k + n * sb_n. For a k=3
// conv the reduction index k runs over (tap, ci) in the order the weight is
// stored, so that one stride spans it: tap-major k = tap * Ci + ci for the
// JAX layout, tap-minor k = ci * 3 + tap for nn.Conv1d's. Norm weights and
// biases are read in their own dtype (norm_dtype, bias_dtype).
//
// A is a channel-last activation [rows, Ci]; its logical row m is
// (b, t) = (m / T, m % T). Prologue, applied while the A tile is loaded:
//   taps == 3: K = 3 * Ci and k = (tap, ci) reads row t + tap - 1 of the
//              same batch element; rows outside [0, T) load 0 AFTER the
//              activation (a SAME k=3 conv as three shifted products,
//              diff_vits_tpu/ops/fused_resnet.py:53-65);
//   norm LN:   (a - mean[row]) * rstd[row] * w[ci] + beta[ci];
//   norm GN:   (a - mean[b, g]) * rstd[b, g] * w[ci] + beta[ci], g = ci / (Ci / G);
//   film:      h * (1 + film[b, ci]) + film[b, Ci + ci];
//   silu:      h * sigmoid(h);
//   then the value is rounded to Bm's dtype, the reference's cast of the
//   operand to its compute dtype before each product.
// Epilogue: + bias[n], + res[m, n], stored in the output dtype; or, for
// GEGLU, one tile computes value column n and gate column n + N of a
// weight with 2N columns and stores (val + b[n]) * gelu_erf(gate + b[N + n]).
// gridDim.z indexes up to three problems that share A (the q/k/v
// projections of one input).
//
// What bounds it on the H100: at the UNet's shapes (M = B*T <= 6400,
// K <= 3072, N <= 2048) the products are small. A grid of one block per
// 64-row output tile leaves most of the 132 SMs idle while each block walks
// the whole K, and a block's K step waits on its A loads and the prologue
// before its few products: the time is per-step latency and prologue
// instructions, not tensor-core work (tools/torch_gemm_probe.py measures
// each part). The design:
//   * bfloat16 (the serving path's dtype): tensor cores. Four warps, each a
//     32 x BN/2 tile of mma.sync m16n8k16 (bf16 in, float32 accumulate; the
//     products of two bf16 values are exact, so only the order of the sum
//     differs from the reference), fed by ldmatrix from padded,
//     conflict-free shared tiles. The A tile for step k+1 is loaded into
//     registers before the products of step k and transformed after them,
//     by prologue code specialised per norm / FiLM / SiLU so that a
//     thread's 16 elements run without a branch, with a warp's GroupNorm
//     and FiLM terms loaded once a step where its rows lie in one batch
//     element; the weight tile comes in by cp.async (16-byte copies,
//     zero-filled past K or N), double-buffered, k-fastest weights stored
//     [BN][BK] for ldmatrix, n-fastest [BK][BN] for ldmatrix.trans. A
//     weight whose rows are not 16-byte aligned is copied element by
//     element into the same tiles.
//   * float32 (the parity route): exact float32 FMA products, the same
//     tiles, prologue and split-K, no tensor cores (TF32 would round the
//     operands).
//   * split-K over a thread-block cluster: a host-side plan
//     (ops/_cuda.py gemm_plan) picks BN (64 or 32) and S in {1, 2, 4, 8}
//     K-splits so that the grid fills the card with three blocks an SM,
//     which hide each other's step latency; the S blocks of one output
//     tile form one cluster. Each leaves its float32 partial tile in its
//     own shared memory; after a cluster barrier, rank r reduces rows
//     [r * 64 / S, (r + 1) * 64 / S) of the tile by reading the S partials
//     over distributed shared memory in rank order, and applies the
//     epilogue to the full sum. One launch, no workspace, no atomics, the
//     same bits on every launch; GEGLU's non-linear epilogue sees only whole
//     sums.
// The normalised / activated / shifted A operand and the GEGLU [M, 8C]
// intermediate never touch device memory.
//
// Bounds-checked debug build: compiled with -DDVT_BOUNDS_CHECK
// (tools/torch_gemm_probe.py --bounds-check builds it under build/), every
// shared-memory index, cp.async address and global index below is asserted
// in range on the device, and a failed check ends the launch with a
// device-side assert naming its line. The normal build leaves the macro
// undefined: the checks compile to nothing.
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

#ifdef DVT_BOUNDS_CHECK
#include <cassert>
#define DVT_CHECK(cond) assert(cond)
#else
#define DVT_CHECK(cond) ((void)0)
#endif

namespace cg = cooperative_groups;

namespace dvt {

enum Norm { kNoNorm = 0, kLayerNorm = 1, kGroupNorm = 2 };

struct GemmArgs {
  const void* a;            // [rows, Ci], a_dtype
  const void* b[3];         // per problem, b_dtype, strides sb_*
  void* out[3];             // [M, N] per problem, out_dtype
  const void* bias[3];      // [N] (GEGLU: [2N]) per problem, or null
  const void* res;          // [M, N], res_dtype, or null
  const float* stat_mean;   // LN: [rows]; GN: [B, G]
  const float* stat_rstd;
  const void* norm_w;       // [Ci], norm_dtype
  const void* norm_b;       // [Ci], norm_dtype
  const float* film;        // [B, 2 * Ci] or null
  int M, N, K;
  int sb_k, sb_n;           // element strides of Bm
  int T, Ci, G, taps, tap_minor;
  int norm, silu, geglu, problems;
  int a_dtype, b_dtype, out_dtype, res_dtype, norm_dtype, bias_dtype;
  int bn, splits;           // the plan: tile width, K-splits (cluster size)
};

constexpr int BM = 64, BK = 32, kThreads = 128;
// A is loaded one column a thread: column tid % BK, rows tid / BK + kRowStep * i
constexpr int kRowStep = kThreads / BK, kARows = BM / kRowStep;

// Batch elements of A (rows of the GroupNorm statistics and FiLM terms);
// used by the bounds checks only.
__device__ __forceinline__ int n_items(const GemmArgs& p) {
  return (p.M + p.T - 1) / p.T;
}

// The conv tap (1, the centre, without taps) and input channel of k.
__device__ __forceinline__ void split_k(const GemmArgs& p, int k, int& tap,
                                        int& ci) {
  if (p.taps != 3) {
    tap = 1;
    ci = k;
  } else if (p.tap_minor) {
    ci = k / 3;
    tap = k - 3 * ci;
  } else {
    tap = k / p.Ci;
    ci = k - tap * p.Ci;
  }
}

// This thread's rows of the A tile, m = m_first + kRowStep * i: batch
// element and time packed in one register, (b << 16) | t (T <= 65535), or
// -1 past M.
struct ARows {
  int bt[kARows];
  __device__ __forceinline__ ARows(const GemmArgs& p, int m_first) {
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int m = m_first + kRowStep * i;
      bt[i] = m < p.M ? (m / p.T) << 16 | (m % p.T) : -1;
    }
  }
  __device__ __forceinline__ int b(int i) const { return bt[i] >> 16; }
  __device__ __forceinline__ int t(int i) const { return bt[i] & 0xffff; }
};

// This thread's column k of the A tile at one K step, and what the
// prologue needs of it.
struct ACol {
  int ci, d, g;     // input channel, tap shift (tap - 1), GroupNorm group
  int src;          // offset in A of (row m_first + d, channel ci)
  float w, beta;    // norm affine (1, 0 without a norm)
  bool ok;          // k < K
};

__device__ __forceinline__ ACol a_col(const GemmArgs& p, int m_first, int k) {
  ACol c;
  c.ok = k < p.K;
  int tap;
  split_k(p, c.ok ? k : 0, tap, c.ci);
  c.d = tap - 1;
  c.g = p.norm == kGroupNorm ? c.ci / (p.Ci / p.G) : 0;
  DVT_CHECK(!c.ok || ((unsigned)c.ci < (unsigned)p.Ci &&
                      (unsigned)tap < (unsigned)p.taps + (p.taps == 1)));
  c.src = (m_first + c.d) * p.Ci + c.ci;
  c.w = 1.f;
  c.beta = 0.f;
  if (c.ok && p.norm != kNoNorm) {
    c.w = ld(p.norm_w, c.ci, p.norm_dtype);
    c.beta = ld(p.norm_b, c.ci, p.norm_dtype);
  }
  return c;
}

// Load this thread's raw A values of column c (0 where the element is a
// zero of the padding: past M or K, a tap outside [0, T)); returns the mask
// of the elements that are not. Branch-free, so the 16 loads are in flight
// together.
template <bool ABF16>
__device__ __forceinline__ unsigned a_fetch(const GemmArgs& p, const ARows& r,
                                            const ACol& c,
                                            float (&raw)[kARows]) {
  unsigned mask = 0;
  const int step = kRowStep * p.Ci;
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const bool ok = c.ok && r.bt[i] >= 0 &&
                    (unsigned)(r.t(i) + c.d) < (unsigned)p.T;
    const int idx = ok ? c.src + i * step : 0;
    DVT_CHECK(!ok || (unsigned)idx < (unsigned)(p.M * p.Ci));
    raw[i] = ok ? (ABF16 ? __bfloat162float(
                               static_cast<const __nv_bfloat16*>(p.a)[idx])
                         : static_cast<const float*>(p.a)[idx])
                : 0.f;
    mask |= (unsigned)ok << i;
  }
  return mask;
}

// SiLU. The tensor-core route takes the hardware exp and reciprocal: a few
// ulp of float32, far inside the rounding to bf16 that follows.
template <bool FAST>
__device__ __forceinline__ float silu(float x) {
  return FAST ? __fdividef(x, 1.f + __expf(-x)) : x / (1.f + expf(-x));
}

// The prologue on the 16 elements, without a branch; masked elements read
// index 0 of the small arrays and give 0. HOIST: the rows lie in one batch
// element b0, whose GroupNorm statistics and FiLM terms of this column
// were loaded once (mu0, rs0, f10 = 1 + film, f20).
template <int NORM, bool FILM, bool SILU, bool FAST, bool HOIST>
__device__ __forceinline__ void a_loop(const GemmArgs& p, const ARows& r,
                                       const ACol& c, int m_first,
                                       unsigned mask, float (&v)[kARows],
                                       float mu0, float rs0, float f10,
                                       float f20) {
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const bool ok = (mask >> i) & 1u;
    float x = v[i], mu = mu0, rs = rs0, f1 = f10, f2 = f20;
    if (NORM == kLayerNorm) {
      const int row = ok ? m_first + kRowStep * i + c.d : 0;
      DVT_CHECK((unsigned)row < (unsigned)p.M);
      mu = p.stat_mean[row];
      rs = p.stat_rstd[row];
    } else if (NORM == kGroupNorm && !HOIST) {
      const int bg = ok ? r.b(i) * p.G + c.g : 0;
      DVT_CHECK((unsigned)bg < (unsigned)(n_items(p) * p.G));
      mu = p.stat_mean[bg];
      rs = p.stat_rstd[bg];
    }
    if (FILM && !HOIST) {
      DVT_CHECK(!ok || (unsigned)r.b(i) < (unsigned)n_items(p));
      const float* f = p.film + (ok ? r.b(i) : 0) * 2 * p.Ci;
      f1 = 1.f + f[c.ci];
      f2 = f[p.Ci + c.ci];
    }
    if (NORM != kNoNorm) x = (x - mu) * rs * c.w + c.beta;
    if (FILM) x = x * f1 + f2;
    if (SILU) x = silu<FAST>(x);
    v[i] = ok ? x : 0.f;
  }
}

template <int NORM, bool FILM, bool SILU, bool FAST>
__device__ __forceinline__ void a_apply(const GemmArgs& p, const ARows& r,
                                        const ACol& c, int m_first,
                                        unsigned mask, float (&v)[kARows]) {
  // a warp's lanes are columns of the same rows, so this test is uniform
  const int b0 = r.b(0);
  if ((NORM == kGroupNorm || FILM) && b0 >= 0 && b0 == r.b(kARows - 1)) {
    float mu = 0.f, rs = 1.f, f1 = 1.f, f2 = 0.f;
    DVT_CHECK(b0 < n_items(p) && (unsigned)c.g < (unsigned)max(p.G, 1));
    if (NORM == kGroupNorm) {
      mu = p.stat_mean[b0 * p.G + c.g];
      rs = p.stat_rstd[b0 * p.G + c.g];
    }
    if (FILM) {
      const float* f = p.film + b0 * 2 * p.Ci;
      f1 = 1.f + f[c.ci];
      f2 = f[p.Ci + c.ci];
    }
    a_loop<NORM, FILM, SILU, FAST, true>(p, r, c, m_first, mask, v, mu, rs,
                                         f1, f2);
  } else {
    a_loop<NORM, FILM, SILU, FAST, false>(p, r, c, m_first, mask, v, 0.f,
                                          1.f, 1.f, 0.f);
  }
}

// Raw values of column c into `raw`; returns the mask of a_fetch.
__device__ __forceinline__ unsigned a_load(const GemmArgs& p, const ARows& r,
                                           const ACol& c,
                                           float (&raw)[kARows]) {
  return p.a_dtype == kBF16 ? a_fetch<true>(p, r, c, raw)
                            : a_fetch<false>(p, r, c, raw);
}

// One dispatch a K step to the prologue this launch needs.
template <bool FAST>
__device__ __forceinline__ void a_prologue(const GemmArgs& p, const ARows& r,
                                           const ACol& c, int m_first,
                                           unsigned mask, float (&v)[kARows]) {
  switch (p.norm * 4 + (p.film != nullptr) * 2 + (p.silu != 0)) {
#define DVT_PROLOGUE(N, F, S)                                    \
  case N * 4 + F * 2 + S:                                        \
    a_apply<N, F != 0, S != 0, FAST>(p, r, c, m_first, mask, v); \
    break;
    DVT_PROLOGUE(0, 0, 0) DVT_PROLOGUE(0, 0, 1)
    DVT_PROLOGUE(0, 1, 0) DVT_PROLOGUE(0, 1, 1)
    DVT_PROLOGUE(1, 0, 0) DVT_PROLOGUE(1, 0, 1)
    DVT_PROLOGUE(1, 1, 0) DVT_PROLOGUE(1, 1, 1)
    DVT_PROLOGUE(2, 0, 0) DVT_PROLOGUE(2, 0, 1)
    DVT_PROLOGUE(2, 1, 0) DVT_PROLOGUE(2, 1, 1)
#undef DVT_PROLOGUE
  }
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// Split-K reduction and epilogue, shared by both mainloops. Every block of
// the cluster has stored its partial [BM][BN] tile (and, for GEGLU, the
// gate's) at `cs` (row stride BN + 8 floats) in its shared memory.

template <int BN>
__host__ __device__ constexpr int c_ld() {
  return BN + 8;
}

template <int BN, bool GEGLU>
__device__ __forceinline__ void reduce_and_store(const GemmArgs& p,
                                                 float* cs, int m0, int n0) {
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int ld_c = c_ld<BN>();
  constexpr int tile = BM * ld_c;
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  cluster.sync();  // every partial tile is written and visible
  const int rows = BM / S;
  DVT_CHECK(rank < S && S <= p.splits && (int)blockIdx.z < p.problems);
  const void* __restrict__ bias = p.bias[blockIdx.z];
  void* __restrict__ out = p.out[blockIdx.z];
  // a thread's four columns are the same in every row it stores
  const int c = (threadIdx.x * 4) % BN, n = n0 + c;
  float bv[4], bg[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool ok = bias != nullptr && n + j < p.N;
    bv[j] = ok ? ld(bias, n + j, p.bias_dtype) : 0.f;
    bg[j] = ok && GEGLU ? ld(bias, p.N + n + j, p.bias_dtype) : 0.f;
  }
  for (int e = threadIdx.x; e < rows * BN / 4; e += kThreads) {
    const int r = rank * rows + (e * 4) / BN;
    DVT_CHECK(r < BM && c + 3 < BN && (c & 3) == 0);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f), g = v;
    for (int s = 0; s < S; ++s) {  // rank order: the same sum every launch
      const float* src = cluster.map_shared_rank(cs, s);
      const float4 x = *reinterpret_cast<const float4*>(src + r * ld_c + c);
      v.x += x.x; v.y += x.y; v.z += x.z; v.w += x.w;
      if (GEGLU) {
        const float4 y =
            *reinterpret_cast<const float4*>(src + tile + r * ld_c + c);
        g.x += y.x; g.y += y.y; g.z += y.z; g.w += y.w;
      }
    }
    const int m = m0 + r;
    if (m >= p.M) continue;
    const float vv[4] = {v.x, v.y, v.z, v.w}, gg[4] = {g.x, g.y, g.z, g.w};
    const long base = (long)m * p.N + n;
    // a column tile past N stores nothing (every store tests n + j < N)
    DVT_CHECK(n >= p.N || base + min(p.N - n, 4) <= (long)p.M * p.N);
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = GEGLU ? (vv[j] + bv[j]) * gelu_erf(gg[j] + bg[j]) : vv[j] + bv[j];
    if (!GEGLU && p.res != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < p.N) o[j] += ld(p.res, base + j, p.res_dtype);
    }
    if (p.out_dtype == kBF16) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < p.N)
          static_cast<__nv_bfloat16*>(out)[base + j] = __float2bfloat16(o[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < p.N) static_cast<float*>(out)[base + j] = o[j];
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// The K steps [s0, s1) of this block's split: a balanced share, at least
// one step each when S <= ceil(K / BK) (the plan keeps S <= K / BK).
__device__ __forceinline__ void split_steps(const GemmArgs& p, int split,
                                            int& s0, int& s1) {
  const int steps = (p.K + BK - 1) / BK;
  s0 = (int)((long)split * steps / p.splits);
  s1 = (int)((long)(split + 1) * steps / p.splits);
  DVT_CHECK(0 <= s0 && s0 <= s1 && s1 <= steps);
}

// ---------------------------------------------------------------------------
// Tensor-core mainloop (bfloat16 weights).

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy; bytes past `src_bytes` are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  DVT_CHECK((smem_u32(dst) & 15) == 0 &&
            (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
            src_bytes >= 0 && src_bytes <= 16);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

constexpr int kALd = BK + 8;  // bf16 row stride of the A tile: 80 bytes

// Shared-memory layout of the tensor-core kernel: a weight tile is
// [BN][BK + 8] (k fastest) or [BK][BN + 8] (n fastest); both strides are
// odd multiples of 16 bytes modulo 128, so the 8 rows an ldmatrix reads hit
// distinct banks.
template <int BN, bool NFAST>
struct MmaTiles {
  static constexpr int b_rows = NFAST ? BK : BN;
  static constexpr int b_ld = NFAST ? BN + 8 : BK + 8;
  static constexpr int a_elems = BM * kALd;
  static constexpr int b_elems = b_rows * b_ld;
};

template <int BN, bool GEGLU, bool NFAST>
__host__ __device__ constexpr int mma_smem_bytes() {
  using L = MmaTiles<BN, NFAST>;
  constexpr int nb = GEGLU ? 2 : 1;
  constexpr int loop = 2 * (L::a_elems + nb * L::b_elems) * 2;
  constexpr int part = nb * BM * c_ld<BN>() * 4;
  return loop > part ? loop : part;
}

// Start the copies of weight tile k0 (both halves for GEGLU) into `bs`.
template <int BN, bool GEGLU, bool NFAST>
__device__ __forceinline__ void b_fetch(const GemmArgs& p,
                                        const __nv_bfloat16* bmat, bool vec,
                                        int k0, int n0, __nv_bfloat16* bs) {
  using L = MmaTiles<BN, NFAST>;
  constexpr int nb = GEGLU ? 2 : 1;
  const long gate = (long)p.N * p.sb_n;  // offset of the gate columns
  if (vec) {
    // 8 elements a copy along the unit-stride index
    constexpr int per_row = (NFAST ? BN : BK) / 8;
    constexpr int chunks = L::b_rows * per_row;
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      const int row = c / per_row, col = (c % per_row) * 8;
      int k, n, rem;
      if (NFAST) {
        k = k0 + row;
        n = n0 + col;
        rem = k < p.K ? min(max(p.N - n, 0), 8) : 0;
      } else {
        n = n0 + row;
        k = k0 + col;
        rem = n < p.N ? min(max(p.K - k, 0), 8) : 0;
      }
      DVT_CHECK(rem <= 0 || (NFAST ? k < p.K && n + rem <= p.N
                                   : n < p.N && k + rem <= p.K));
      DVT_CHECK((nb - 1) * L::b_elems + row * L::b_ld + col + 8 <=
                nb * L::b_elems);
      const __nv_bfloat16* src =
          rem > 0 ? bmat + (long)k * p.sb_k + (long)n * p.sb_n : bmat;
#pragma unroll
      for (int h = 0; h < nb; ++h)
        cp_async16(bs + h * L::b_elems + row * L::b_ld + col,
                   rem > 0 ? src + h * gate : bmat, 2 * rem);
    }
  } else {
    // element by element: strides or a base that no 16-byte copy fits
    for (int e = threadIdx.x; e < BN * BK; e += kThreads) {
      int row, col, k, n;
      if (NFAST) {
        row = e / BN;
        col = e % BN;
        k = k0 + row;
        n = n0 + col;
      } else {
        row = e / BK;
        col = e % BK;
        n = n0 + row;
        k = k0 + col;
      }
      const bool ok = k < p.K && n < p.N;
      const long off = (long)k * p.sb_k + (long)n * p.sb_n;
      DVT_CHECK(row * L::b_ld + col < L::b_elems);
#pragma unroll
      for (int h = 0; h < nb; ++h)
        bs[h * L::b_elems + row * L::b_ld + col] =
            ok ? bmat[off + h * gate] : __float2bfloat16(0.f);
    }
  }
}

template <int BN, bool GEGLU, bool NFAST>
__global__ void __launch_bounds__(kThreads) gemm_mma_kernel(const GemmArgs p) {
  using L = MmaTiles<BN, NFAST>;
  constexpr int nb = GEGLU ? 2 : 1;
  constexpr int WN = BN / 2, NT = WN / 8, MT = 2;  // warp tile 32 x WN
  __shared__ __align__(128) unsigned char smem[mma_smem_bytes<BN, GEGLU, NFAST>()];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bs = as + 2 * L::a_elems;
  const int split = blockIdx.x % p.splits;
  const int n0 = (blockIdx.x / p.splits) * BN, m0 = blockIdx.y * BM;
  const __nv_bfloat16* bmat =
      static_cast<const __nv_bfloat16*>(p.b[blockIdx.z]);
  const bool vec =
      (reinterpret_cast<uintptr_t>(bmat) & 15) == 0 &&
      (NFAST ? p.sb_k % 8 == 0 && (!GEGLU || p.N % 8 == 0)
             : p.sb_k == 1 && p.sb_n % 8 == 0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * WN;
  const int a_k = tid % BK, m_first = m0 + tid / BK;
  const ARows rows(p, m_first);

  float acc[MT][NT][4], acc2[GEGLU ? MT : 1][GEGLU ? NT : 1][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][j][q] = 0.f;
        if (GEGLU) acc2[GEGLU ? i : 0][GEGLU ? j : 0][q] = 0.f;
      }

  int s0, s1;
  split_steps(p, split, s0, s1);
  // A's raw values of step kt + 1 are loaded before the products of step
  // kt and go through the prologue into their A tile after them
  float raw[kARows];
  auto store_a = [&](const ACol& c, unsigned mask, int buf) {
    a_prologue<true>(p, rows, c, m_first, mask, raw);
    __nv_bfloat16* dst = as + buf * L::a_elems + (tid / BK) * kALd + a_k;
    DVT_CHECK((buf == 0 || buf == 1) &&
              (tid / BK + kRowStep * (kARows - 1)) * kALd + a_k <
                  L::a_elems);
#pragma unroll
    for (int i = 0; i < kARows; ++i)
      dst[kRowStep * i * kALd] = __float2bfloat16(raw[i]);
  };
  auto mma_tile = [&](int buf) {
    const __nv_bfloat16* at = as + buf * L::a_elems;
    const __nv_bfloat16* bt = bs + buf * nb * L::b_elems;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        DVT_CHECK((wm + i * 16 + (lane & 15)) * kALd + ks + (lane >> 4) * 8 +
                      8 <= L::a_elems);
        ldmatrix_x4(af[i], at + (wm + i * 16 + (lane & 15)) * kALd + ks +
                               (lane >> 4) * 8);
      }
#pragma unroll
      for (int h = 0; h < nb; ++h) {
        const __nv_bfloat16* bh = bt + h * L::b_elems;
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t r[4];
          DVT_CHECK(NFAST
              ? (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * L::b_ld + wn +
                        jp * 16 + (lane >> 4) * 8 + 8 <= L::b_elems
              : (wn + jp * 16 + (lane & 7) + (lane >> 4) * 8) * L::b_ld +
                        ks + ((lane >> 3) & 1) * 8 + 8 <= L::b_elems);
          if (NFAST) {
            ldmatrix_x4_trans(
                r, bh + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * L::b_ld +
                       wn + jp * 16 + (lane >> 4) * 8);
          } else {
            ldmatrix_x4(
                r, bh + (wn + jp * 16 + (lane & 7) + (lane >> 4) * 8) *
                            L::b_ld + ks + ((lane >> 3) & 1) * 8);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            if (h == 0) {
              mma_bf16(acc[i][2 * jp], af[i], r[0], r[1]);
              mma_bf16(acc[i][2 * jp + 1], af[i], r[2], r[3]);
            } else if (GEGLU) {
              mma_bf16(acc2[GEGLU ? i : 0][GEGLU ? 2 * jp : 0], af[i], r[0],
                       r[1]);
              mma_bf16(acc2[GEGLU ? i : 0][GEGLU ? 2 * jp + 1 : 0], af[i],
                       r[2], r[3]);
            }
          }
        }
      }
    }
  };
  if (s0 < s1) {
    b_fetch<BN, GEGLU, NFAST>(p, bmat, vec, s0 * BK, n0, bs);
    cp_async_commit();
    const ACol c = a_col(p, m_first, s0 * BK + a_k);
    store_a(c, a_load(p, rows, c, raw), 0);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int kt = s0; kt < s1; ++kt) {
    const int buf = (kt - s0) & 1;
    const bool next = kt + 1 < s1;
    ACol col;
    unsigned mask = 0;
    if (next) {
      b_fetch<BN, GEGLU, NFAST>(p, bmat, vec, (kt + 1) * BK, n0,
                                bs + (buf ^ 1) * nb * L::b_elems);
      cp_async_commit();
      col = a_col(p, m_first, (kt + 1) * BK + a_k);
      mask = a_load(p, rows, col, raw);
    }
    mma_tile(buf);
    if (next) store_a(col, mask, buf ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }

  // the partial tile(s), float32, over the mainloop's buffers
  float* cs = reinterpret_cast<float*>(smem);
  constexpr int ld_c = c_ld<BN>();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = wm + i * 16 + (lane >> 2);
      const int c = wn + j * 8 + (lane & 3) * 2;
      DVT_CHECK(((nb - 1) * BM + r + 8) * ld_c + c + 2 <=
                (int)sizeof(smem) / 4);
#pragma unroll
      for (int h = 0; h < nb; ++h) {
        const float* f = h == 0 ? acc[i][j] : acc2[GEGLU ? i : 0][GEGLU ? j : 0];
        float* dst = cs + h * BM * ld_c;
        *reinterpret_cast<float2*>(dst + r * ld_c + c) = make_float2(f[0], f[1]);
        *reinterpret_cast<float2*>(dst + (r + 8) * ld_c + c) =
            make_float2(f[2], f[3]);
      }
    }
  reduce_and_store<BN, GEGLU>(p, cs, m0, n0);
}

// ---------------------------------------------------------------------------
// FMA mainloop (float32 weights): exact float32 products, 64 x 64 tile, a
// thread 4 rows x 8 columns (columns tx + 8 j).

constexpr int kFmaBN = 64;

template <bool GEGLU>
__host__ __device__ constexpr int fma_smem_bytes() {
  constexpr int nb = GEGLU ? 2 : 1;
  constexpr int loop = (BK * (BM + 4) + nb * BK * (kFmaBN + 4)) * 4;
  constexpr int part = nb * BM * c_ld<kFmaBN>() * 4;
  return loop > part ? loop : part;
}

template <bool GEGLU>
__global__ void __launch_bounds__(kThreads) gemm_fma_kernel(const GemmArgs p) {
  constexpr int BN = kFmaBN, nb = GEGLU ? 2 : 1;
  constexpr int a_ld = BM + 4, b_ld = BN + 4;
  __shared__ __align__(16) unsigned char smem[fma_smem_bytes<GEGLU>()];
  float* As = reinterpret_cast<float*>(smem);   // [BK][BM + 4]
  float* Bs = As + BK * a_ld;                    // [nb][BK][BN + 4]
  const int split = blockIdx.x % p.splits;
  const int n0 = (blockIdx.x / p.splits) * BN, m0 = blockIdx.y * BM;
  const void* __restrict__ bmat = p.b[blockIdx.z];
  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;
  const int a_k = tid % BK, m_first = m0 + tid / BK;
  const ARows rows(p, m_first);
  const bool n_fast = p.sb_n == 1;
  const long gate = (long)p.N * p.sb_n;

  float acc[4][8], acc2[GEGLU ? 4 : 1][GEGLU ? 8 : 1];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = 0.f;
      if (GEGLU) acc2[GEGLU ? i : 0][GEGLU ? j : 0] = 0.f;
    }

  int s0, s1;
  split_steps(p, split, s0, s1);
  float raw[kARows];
  for (int kt = s0; kt < s1; ++kt) {
    const int k0 = kt * BK;
    const ACol c = a_col(p, m_first, k0 + a_k);
    a_prologue<false>(p, rows, c, m_first, a_load(p, rows, c, raw), raw);
    DVT_CHECK(a_k * a_ld + tid / BK + kRowStep * (kARows - 1) < BK * a_ld);
#pragma unroll
    for (int i = 0; i < kARows; ++i)
      As[a_k * a_ld + tid / BK + kRowStep * i] = raw[i];
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = n_fast ? e / BN : e % BK;
      const int cc = n_fast ? e % BN : e / BK;
      const int k = k0 + kk, n = n0 + cc;
      const bool ok = k < p.K && n < p.N;
      const long off = (long)k * p.sb_k + (long)n * p.sb_n;
      DVT_CHECK(kk < BK && cc < BN &&
                ((nb - 1) * BK + kk) * b_ld + cc < nb * BK * b_ld);
#pragma unroll
      for (int h = 0; h < nb; ++h)
        Bs[(h * BK + kk) * b_ld + cc] =
            ok ? ld(bmat, off + h * gate, p.b_dtype) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * a_ld + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float bv = Bs[kk * b_ld + tx + 8 * j];
        const float bg = GEGLU ? Bs[(BK + kk) * b_ld + tx + 8 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = fmaf(a[i], bv, acc[i][j]);
          if (GEGLU)
            acc2[GEGLU ? i : 0][GEGLU ? j : 0] =
                fmaf(a[i], bg, acc2[GEGLU ? i : 0][GEGLU ? j : 0]);
        }
      }
    }
    __syncthreads();
  }

  float* cs = reinterpret_cast<float*>(smem);
  constexpr int ld_c = c_ld<BN>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int off = (ty * 4 + i) * ld_c + tx + 8 * j;
      DVT_CHECK(((nb - 1) * BM) * ld_c + off < (int)sizeof(smem) / 4);
      cs[off] = acc[i][j];
      if (GEGLU) cs[BM * ld_c + off] = acc2[GEGLU ? i : 0][GEGLU ? j : 0];
    }
  reduce_and_store<BN, GEGLU>(p, cs, m0, n0);
}

template <typename Kernel>
int launch(Kernel kernel, const GemmArgs& p, int bn, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((p.N + bn - 1) / bn) * p.splits, (p.M + BM - 1) / BM,
                     p.problems);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;  // the K-splits of one output tile
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace dvt

extern "C" int dvt_gemm_args_size() { return (int)sizeof(dvt::GemmArgs); }

extern "C" int dvt_gemm(const dvt::GemmArgs* args, void* stream) {
  using namespace dvt;
  const GemmArgs& p = *args;
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.Ci <= 0) return -1;
  // ARows packs (b, t) in one int
  if (p.T <= 0 || p.T > 65535 || p.M / p.T >= 32768) return -1;
  if (p.problems < 1 || p.problems > 3) return -1;
  if (p.geglu && p.problems != 1) return -1;
  if (p.taps != 1 && p.taps != 3) return -1;
  if (p.K != p.taps * p.Ci) return -1;
  if (p.norm == kGroupNorm && (p.G <= 0 || p.Ci % p.G != 0)) return -1;
  if ((p.M + BM - 1) / BM > 65535) return -1;
  if ((long)(p.M + BM) * p.K >= (1L << 31)) return -1;  // int offsets in A
  const int steps = (p.K + BK - 1) / BK;
  const int s = p.splits;
  if ((s != 1 && s != 2 && s != 4 && s != 8) || s > steps) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.b_dtype == kF32) {
    if (p.bn != kFmaBN) return -1;
    return p.geglu ? launch(gemm_fma_kernel<true>, p, kFmaBN, st)
                   : launch(gemm_fma_kernel<false>, p, kFmaBN, st);
  }
  if (p.b_dtype != kBF16) return -1;
  // n-fastest weights (the JAX layout) take the ldmatrix.trans tiles
  const bool nfast = p.sb_n == 1 && p.sb_k != 1;
  if (p.bn == 64) {
    if (p.geglu)
      return nfast ? launch(gemm_mma_kernel<64, true, true>, p, 64, st)
                   : launch(gemm_mma_kernel<64, true, false>, p, 64, st);
    return nfast ? launch(gemm_mma_kernel<64, false, true>, p, 64, st)
                 : launch(gemm_mma_kernel<64, false, false>, p, 64, st);
  }
  if (p.bn == 32) {
    if (p.geglu)
      return nfast ? launch(gemm_mma_kernel<32, true, true>, p, 32, st)
                   : launch(gemm_mma_kernel<32, true, false>, p, 32, st);
    return nfast ? launch(gemm_mma_kernel<32, false, true>, p, 32, st)
                 : launch(gemm_mma_kernel<32, false, false>, p, 32, st);
  }
  return -1;
}
