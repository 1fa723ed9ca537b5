// Relative-position multi-head self-attention core (VITS, head-shared
// window of relative keys and values): the score / softmax / PV part of
// kernel K5, replacing the Pallas kernel fused_rel_self_attention of
// diff_vits_tpu/ops/rel_attention.py:90 (_kernel :40). The q/k/v and output
// projections of K5 run through csrc/gemm.cu around this kernel.
//
//   q_t   = round(scale * q[t]), k_s = round(k[s]), v_s = round(v[s])
//           (round: to the compute dtype, the reference's casts :63-65)
//   x[s]  = q_t . k_s + (|s - t| <= W ? q_t . round(ek[s - t + W]) : 0)
//   x[s]  = -1e4 where t >= len or s >= len (replaces the score, :76)
//   p     = softmax_s(x)
//   o[t]  = sum_s round(p[s]) v_s + sum_m p[t + m - W] ev[m]  (ev float32,
//           :79-82; p rounded to the compute dtype for PV only)
//
// lengths int32 [B] or null (no mask); ek, ev [2W+1, D] in e_dt. A masked
// row (t >= len) has every score -1e4 and so attends uniformly, as in the
// reference. The [T, T] scores never reach memory (at T = 601 a head's
// would be 1.4 MB against a block's 227 KB).
//
// What bounds it on the H100: not its work. At the TextEncoder's headline
// launch (B=8, T=601, 2 heads of 128) QK^T and PV are 3 GFLOP and q, k, v
// and o ~10 MB: 3 us of bf16 tensor cores, 3 us of HBM. What costs time is
// each block's chain of key tiles (the softmax's instructions and its exp2
// on the special-function unit) and how many blocks there are to hide it.
//
//   * bfloat16 (the serving path): rel_attention_mma_kernel<D, warps>, the
//     attention core's design (csrc/attention.cu) with the band. A warp
//     owns 16 query rows and keeps round(scale q) as mma.sync A fragments;
//     k and v arrive in bf16, rounded once by round_kv_kernel after the
//     one float32 projection launch of q, k and v (timed against a second
//     projection launch writing bf16 k and v: tools/
//     torch_rel_attention_probe.py), 64-key tiles by a cp.async double
//     buffer; QK^T and PV on
//     mma.sync (csrc/mma.cuh mma_rows / mma_cols), the online softmax in
//     base 2 in the accumulators, p as bf16 A fragments of PV (the
//     reference's cast). The band is never a [T, T] term:
//       - the 2W+1 relative-key logits q_t . round(ek[m]) are one more small
//         product per warp, against round(ek) staged as 32 key rows
//         (zero past 2W+1), kept in shared memory [rows][32];
//       - only a key tile that meets a warp's band (|s - t| <= W), holds a
//         masked or missing key, or meets a masked row takes the
//         per-element path: add the band logit, replace masked scores by
//         -1e4, score slots past the split's keys -inf, and keep each
//         band score x[t, t + m - W] in shared memory; every other tile
//         runs the plain core loop;
//       - the relative-value band is added once the row's max and sum are
//         final: o += sum_m exp2(x_band f - max) / sum * ev[m] in float32,
//         no band probability rescaled per tile.
//     A query tile whose rows are all kept stops after the item's last
//     kept key: for a kept row the keys past len score -1e4 and weigh
//     exactly 0 in float32. A tile with a masked row runs all T keys.
//     Keys split over a thread-block cluster as ops/_cuda.py
//     rel_attention_plan says (the attention core's rule), merged in rank
//     order over distributed shared memory (csrc/split_merge.cuh); the band
//     scores of a row come from the split that holds each band key.
//   * float32 (the parity route): rel_attention_kernel<D>, one block per
//     (b, head, 16 queries), four warps of four queries each; keys stream
//     through shared memory in tiles of 32, one key per lane, FMA products
//     in float32, an online softmax per query; lane m < 2W+1 keeps the
//     running probability of key t + m - W for the value band.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "split_merge.cuh"

namespace dvt {

constexpr int kWarps = 4, kQW = 4, kQB = kWarps * kQW, kKT = 32;
constexpr unsigned kAll = 0xffffffffu;

struct RelArgs {
  const float* q;
  const float* k;
  const float* v;
  const int* lengths;  // [B] or null
  const void* ek;      // [2W+1, D], e_dt
  const void* ev;
  float* o;
  int T, H, W, e_dt, cdt;
  float scale;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
rel_attention_kernel(const RelArgs a) {
  constexpr int KP = D + 4;             // padded key rows: a lane reads its
                                        // own row, float4 at a time, with
                                        // no bank conflict
  constexpr int NPL = (D + 31) / 32;    // output dims a lane owns
  __shared__ __align__(16) float Qs[kQB][D];
  __shared__ __align__(16) float Ks[kKT][KP];
  __shared__ float Vs[kKT][D];
  __shared__ float Ls[kQB][32];         // band logits q_t . ek[m]
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kQB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = a.T, C = a.H * D, W = a.W, nb = 2 * a.W + 1;
  const int len = a.lengths != nullptr ? a.lengths[b] : T;
  const long base = (long)b * T * C + (long)h * D;

  for (int e = threadIdx.x; e < kQB * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D, t = t0 + r;
    Qs[r][d] = t < T ? round_to(a.q[base + (long)t * C + d] * a.scale, a.cdt)
                     : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kQB * nb; e += blockDim.x) {
    const int r = e / nb, m = e - r * nb;
    float s = 0.f;
    for (int d = 0; d < D; ++d)
      s = fmaf(Qs[r][d], round_to(ld(a.ek, (long)m * D + d, a.e_dt), a.cdt),
               s);
    Ls[r][m] = s;
  }
  // Ls is first read after the barrier that follows the first key tile

  float mx[kQW], lsum[kQW], pb[kQW], acc[kQW][NPL];
#pragma unroll
  for (int i = 0; i < kQW; ++i) {
    mx[i] = -INFINITY;
    lsum[i] = pb[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NPL; ++n) acc[i][n] = 0.f;
  }

  for (int s0 = 0; s0 < T; s0 += kKT) {
    const int ns = min(kKT, T - s0);
    __syncthreads();  // every warp is done with the previous tile
    for (int e = threadIdx.x; e < kKT * D; e += blockDim.x) {
      const int r = e / D, d = e - r * D;
      float kv = 0.f, vv = 0.f;
      if (r < ns) {
        const long off = base + (long)(s0 + r) * C + d;
        kv = round_to(a.k[off], a.cdt);
        vv = round_to(a.v[off], a.cdt);
      }
      Ks[r][d] = kv;
      Vs[r][d] = vv;
    }
    __syncthreads();

    // scores of this lane's key for the warp's four queries
    const int s = s0 + lane;
    float sc[kQW];
#pragma unroll
    for (int i = 0; i < kQW; ++i) sc[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&Ks[lane][d]);
#pragma unroll
      for (int i = 0; i < kQW; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(&Qs[warp * kQW + i][d]);
        sc[i] = fmaf(qq.x, kk.x, sc[i]);
        sc[i] = fmaf(qq.y, kk.y, sc[i]);
        sc[i] = fmaf(qq.z, kk.z, sc[i]);
        sc[i] = fmaf(qq.w, kk.w, sc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kQW; ++i) {
      const int r = warp * kQW + i, t = t0 + r;
      float x = sc[i];
      const int rel = s - t;
      if (rel >= -W && rel <= W) x += Ls[r][rel + W];
      if (t >= len || s >= len) x = -1e4f;
      if (lane >= ns) x = -INFINITY;
      const float m_new = fmaxf(mx[i], warp_max(x));
      const float corr = expf(mx[i] - m_new);  // 0 on the first tile
      const float p = expf(x - m_new);
      lsum[i] = lsum[i] * corr + p;
      pb[i] *= corr;
#pragma unroll
      for (int n = 0; n < NPL; ++n) acc[i][n] *= corr;
      // lane m < 2W+1 keeps key t + m - W when it lies in this tile
      const int src = t + lane - W - s0;
      const float got = __shfl_sync(kAll, p, src & 31);
      if (lane < nb && src >= 0 && src < ns) pb[i] += got;
      mx[i] = m_new;
      sc[i] = p;
    }
    for (int j = 0; j < ns; ++j) {
      float vj[NPL];
#pragma unroll
      for (int n = 0; n < NPL; ++n) {
        const int d = lane + 32 * n;
        vj[n] = d < D ? Vs[j][d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kQW; ++i) {
        const float pj = __shfl_sync(kAll, sc[i], j);
#pragma unroll
        for (int n = 0; n < NPL; ++n) acc[i][n] = fmaf(pj, vj[n], acc[i][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kQW; ++i) {
    const int t = t0 + warp * kQW + i;
    if (t >= T) continue;  // the same for the whole warp
    const float inv = 1.f / warp_sum(lsum[i]);
    float o[NPL];
#pragma unroll
    for (int n = 0; n < NPL; ++n) o[n] = acc[i][n] * inv;
    for (int m = 0; m < nb; ++m) {
      const float pm = __shfl_sync(kAll, pb[i], m) * inv;
#pragma unroll
      for (int n = 0; n < NPL; ++n) {
        const int d = lane + 32 * n;
        if (d < D) o[n] = fmaf(pm, ld(a.ev, (long)m * D + d, a.e_dt), o[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < NPL; ++n) {
      const int d = lane + 32 * n;
      if (d < D) a.o[base + (long)t * C + d] = o[n];
    }
  }
}

template <int D>
int launch(const RelArgs& a, int B, cudaStream_t s) {
  const dim3 grid((a.T + kQB - 1) / kQB, a.H, B);
  rel_attention_kernel<D><<<grid, kWarps * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Bfloat16 route: tensor cores, cluster key splits.

constexpr int kKV = 64;         // keys a shared-memory tile
constexpr int kStages = 2;      // key tiles in flight: the cp.async ring
constexpr int kSplitKeys = 16;  // a split's key range: whole PV k-steps
constexpr int kBand = 32;       // band slots a row: 2W+1 <= 31, padded

struct RelMmaArgs {
  const float* q;            // [B, T, H*D] float32, unscaled
  const __nv_bfloat16* k;    // [B, T, H*D]
  const __nv_bfloat16* v;
  const int* lengths;        // [B] or null
  const void* ek;            // [2W+1, D], e_dt
  const void* ev;
  __nv_bfloat16* o;          // [B, T, H*D]
  int T, H, W, e_dt;
  float scale;
};

// Dynamic shared memory of rel_attention_mma_kernel<D, NW>. The main loop
// holds a ring of kStages buffers, each a K and a V tile [kKV][ld] (bf16;
// ld an odd multiple of 16 bytes, so the 8 rows one ldmatrix reads fall in
// distinct banks); after it, the same bytes hold the block's partial for
// the cluster merge ([rows][pld] unnormalised outputs, the rows' max and
// sum, the merge weights) and ev as float32 [kBand][D]. Behind them: the
// band logits q . ek [rows][kBand], the band scores [rows][kBand] and
// round(ek) as a [kBand][ld] bf16 tile.
template <int D, int NW>
struct RelTiles {
  static constexpr int rows = 16 * NW;
  static constexpr int ld = (D / 8) % 2 ? D : D + 8;
  static constexpr int tile = kKV * ld;
  static constexpr int ring_bytes = kStages * 2 * tile * 2;
  static constexpr int pld = D + 4;
  static constexpr int ev_off = (rows * pld + 2 * rows + rows * kMaxSplits) * 4;
  static constexpr int front = ring_bytes > ev_off + kBand * D * 4
                                   ? ring_bytes
                                   : ev_off + kBand * D * 4;
  static constexpr int lb_off = front;
  static constexpr int xb_off = lb_off + rows * kBand * 4;
  static constexpr int e_off = xb_off + rows * kBand * 4;
  static constexpr int bytes = e_off + kBand * ld * 2;
};

template <int D, int NW>
__global__ void __launch_bounds__(32 * NW)
rel_attention_mma_kernel(const RelMmaArgs a) {
  using L = RelTiles<D, NW>;
  constexpr int NO = D / 8;  // 8-wide output tiles
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem);
  float* lb = reinterpret_cast<float*>(smem + L::lb_off);
  float* xb = reinterpret_cast<float*>(smem + L::xb_off);
  __nv_bfloat16* et = reinterpret_cast<__nv_bfloat16*>(smem + L::e_off);
  float* evs = reinterpret_cast<float*>(smem + L::ev_off);

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int qt = blockIdx.x / splits, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T, C = a.H * D, W = a.W, nb = 2 * a.W + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cq = (lane & 3) * 2;  // a thread's column pair in a C fragment
  const int t0 = qt * L::rows, w0 = t0 + warp * 16;
  const int lr0 = warp * 16 + (lane >> 2), lr1 = lr0 + 8;  // block rows
  const int r0 = t0 + lr0, r1 = r0 + 8;
  const int len =
      a.lengths != nullptr ? min(max(a.lengths[b], 0), T) : T;
  // the keys this query tile needs: to the item's last kept key when all
  // its rows are kept, else all T; this split's share [kb, ke) of them in
  // whole 16-key steps
  const int s_eff = min(t0 + L::rows, T) <= len ? len : T;
  const int chunks = (s_eff + kSplitKeys - 1) / kSplitKeys;
  const int kb = (int)((long)split * chunks / splits) * kSplitKeys;
  const int ke =
      min((int)((long)(split + 1) * chunks / splits) * kSplitKeys, s_eff);
  const long base = (long)b * T * C + (long)h * D;

  auto fetch = [&](int k0, int buf) {
    __nv_bfloat16* ks = kv + 2 * buf * L::tile;
    __nv_bfloat16* vs = ks + L::tile;
    constexpr int per_row = D / 8;
    for (int c = tid; c < kKV * per_row; c += blockDim.x) {
      const int r = c / per_row, col = (c - r * per_row) * 8;
      const bool ok = k0 + r < ke;
      const long off = ok ? base + (long)(k0 + r) * C + col : 0;
      cp_async16(ks + r * L::ld + col, a.k + off, ok ? 16 : 0);
      cp_async16(vs + r * L::ld + col, a.v + off, ok ? 16 : 0);
    }
  };

  // round(ek) as kBand key rows, zero past 2W+1; no band score yet
  for (int e = tid; e < kBand * D; e += blockDim.x) {
    const int m = e / D, d = e - m * D;
    et[m * L::ld + d] =
        __float2bfloat16(m < nb ? ld(a.ek, (long)m * D + d, a.e_dt) : 0.f);
  }
  for (int e = tid; e < L::rows * kBand; e += blockDim.x) xb[e] = -INFINITY;

  // this warp's rows g and g + 8 as A fragments of round(scale q): columns
  // cq, cq + 1 and 8 past them; zero past T
  uint32_t qa[kSteps<D>][4];
#pragma unroll
  for (int kk = 0; kk < kSteps<D>; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = kk * 16 + cq + (i >> 1) * 8, row = (i & 1) ? r1 : r0;
      float2 x = make_float2(0.f, 0.f);
      if (row < T && col < D)
        x = *reinterpret_cast<const float2*>(a.q + base + (long)row * C +
                                             col);
      qa[kk][i] = pack_bf16(x.x * a.scale, x.y * a.scale);
    }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int ntiles = ke > kb ? (ke - kb + kKV - 1) / kKV : 0;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles) fetch(kb + st * kKV, st);
    cp_async_commit();
  }
  __syncthreads();  // round(ek) and the band scores' -inf are in place
  {  // the band logits q_t . round(ek[m]), once per warp
    float bl[kBand / 8][4];
#pragma unroll
    for (int j = 0; j < kBand / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) bl[j][e] = 0.f;
    mma_rows<D, kBand / 8>(bl, qa, et, L::ld, lane);
#pragma unroll
    for (int j = 0; j < kBand / 8; ++j) {
      *reinterpret_cast<float2*>(lb + lr0 * kBand + j * 8 + cq) =
          make_float2(bl[j][0], bl[j][1]);
      *reinterpret_cast<float2*>(lb + lr1 * kBand + j * 8 + cq) =
          make_float2(bl[j][2], bl[j][3]);
    }
    __syncwarp();  // a warp reads only its own rows' logits
  }
  // rows of this warp that are masked (or past T) score -1e4 on every key
  const bool warp_masked = w0 + 16 > len;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it % kStages, k0 = kb + it * kKV;
    cp_async_wait<kStages - 2>();
    // tile `it` is in shared memory for every warp, and every warp is done
    // with tile it - 1, whose buffer the next fetch refills
    __syncthreads();
    if (it + kStages - 1 < ntiles)
      fetch(k0 + (kStages - 1) * kKV, (it + kStages - 1) % kStages);
    cp_async_commit();
    const __nv_bfloat16* ks = kv + 2 * buf * L::tile;
    const __nv_bfloat16* vs = ks + L::tile;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mma_rows<D, 8>(s, qa, ks, L::ld, lane);

    // the per-element path, only where a tile needs it (uniform over the
    // warp): the band, masked rows and keys, the split's last keys
    if (warp_masked || k0 + kKV > min(len, ke) ||
        (k0 <= w0 + 15 + W && k0 + kKV - 1 >= w0 - W)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + cq + (e & 1);
          const int lr = (e >> 1) ? lr1 : lr0, t = t0 + lr;
          const int rel = key - t;
          const bool band = rel >= -W && rel <= W;
          float x = s[j][e];
          if (band) x += lb[lr * kBand + rel + W];
          if (t >= len || key >= len) x = -1e4f;
          if (key >= ke) {
            x = -INFINITY;
          } else if (band) {
            xb[lr * kBand + rel + W] = x;
          }
          s[j][e] = x;
        }
    }

    // online softmax in base 2: a score x enters as exp2(x log2(e) - m),
    // m the running max of x log2(e) (q carries the scale)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0 * kLog2e), n1 = fmaxf(m1, mx1 * kLog2e);
    // a row without a key so far keeps the max -inf; exponentiate against
    // 0 there (every term is exp2(-inf) = 0), never exp2(-inf - -inf)
    const float u0 = n0 == -INFINITY ? 0.f : n0;
    const float u1 = n1 == -INFINITY ? 0.f : n1;
    const float c0 = fast_exp2(m0 - u0), c1 = fast_exp2(m1 - u1);
    m0 = n0;
    m1 = n1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = fast_exp2(fmaf(s[j][0], kLog2e, -u0));
      s[j][1] = fast_exp2(fmaf(s[j][1], kLog2e, -u0));
      s[j][2] = fast_exp2(fmaf(s[j][2], kLog2e, -u1));
      s[j][3] = fast_exp2(fmaf(s[j][3], kLog2e, -u1));
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    // O += round(P) V: the probabilities of keys 16kk.. as one bf16 A
    // fragment (the C layout of two m16n8 tiles is the A layout of one
    // m16n8k16)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[1][4];
      pa[0][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[0][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[0][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[0][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      mma_cols<D>(acc, pa, vs + kk * 16 * L::ld, L::ld, lane);
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }

  // the ring is free once every warp is done with it (the groups left are
  // empty): ev as float32 there, behind the merge's partials
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < nb * D; e += blockDim.x) evs[e] = ld(a.ev, e, a.e_dt);
  __syncthreads();

  if (splits == 1) {
    // o = (acc + sum_m exp2(x_band log2(e) - m) ev[m]) / l: every row has a
    // finite max (a key, if only at -1e4)
#pragma unroll 1
    for (int m = 0; m < nb; ++m) {
      const float p0 = fast_exp2(fmaf(xb[lr0 * kBand + m], kLog2e, -m0));
      const float p1 = fast_exp2(fmaf(xb[lr1 * kBand + m], kLog2e, -m1));
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float2 e = *reinterpret_cast<const float2*>(evs + m * D +
                                                          n * 8 + cq);
        acc[n][0] = fmaf(p0, e.x, acc[n][0]);
        acc[n][1] = fmaf(p0, e.y, acc[n][1]);
        acc[n][2] = fmaf(p1, e.x, acc[n][2]);
        acc[n][3] = fmaf(p1, e.y, acc[n][3]);
      }
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + cq;
      if (r0 < T)
        *reinterpret_cast<uint32_t*>(a.o + base + (long)r0 * C + col) =
            pack_bf16(acc[n][0] * i0, acc[n][1] * i0);
      if (r1 < T)
        *reinterpret_cast<uint32_t*>(a.o + base + (long)r1 * C + col) =
            pack_bf16(acc[n][2] * i1, acc[n][3] * i1);
    }
    return;
  }

  // cluster merge: this block's partial over the ring's bytes
  float* part = reinterpret_cast<float*>(smem);
  float* pm = part + L::rows * L::pld;
  float* pl = pm + L::rows;
  float* wts = pl + L::rows;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + cq;
    *reinterpret_cast<float2*>(part + lr0 * L::pld + col) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(part + lr1 * L::pld + col) =
        make_float2(acc[n][2], acc[n][3]);
  }
  if ((lane & 3) == 0) {
    pm[lr0] = m0;
    pm[lr1] = m1;
    pl[lr0] = l0;
    pl[lr1] = l1;
  }
  cluster.sync();  // every partial and band score is written and visible
  const int n = L::rows / splits, lo = split * n;
  // the band logits are spent: their bytes take the merged rows' band
  // probabilities [n][kBand], max and 1 / sum
  float* pbn = lb;
  float* rmax = lb + L::rows * kBand / 2;
  float* rinv = rmax + L::rows;
  merge_weights(cluster, pm, pl, wts, rmax, rinv, lo, n, splits);
  __syncthreads();
  for (int e = tid; e < n * nb; e += blockDim.x) {
    const int r = e / nb, m = e - r * nb;
    float x = -INFINITY;  // set by the one split that holds the key
    for (int sp = 0; sp < splits; ++sp)
      x = fmaxf(x, cluster.map_shared_rank(xb, sp)[(lo + r) * kBand + m]);
    pbn[r * kBand + m] =
        x == -INFINITY ? 0.f
                       : rinv[r] * fast_exp2(fmaf(x, kLog2e, -rmax[r]));
  }
  __syncthreads();
  merge_rows<D>(cluster, part, L::pld, wts, lo, n, splits,
                [&](int r, int c, float4 o4) {
                  const int t = t0 + lo + r;
                  if (t >= T) return;
                  for (int m = 0; m < nb; ++m) {
                    const float p = pbn[r * kBand + m];
                    const float4 e =
                        *reinterpret_cast<const float4*>(evs + m * D + c);
                    o4.x = fmaf(p, e.x, o4.x);
                    o4.y = fmaf(p, e.y, o4.y);
                    o4.z = fmaf(p, e.z, o4.z);
                    o4.w = fmaf(p, e.w, o4.w);
                  }
                  *reinterpret_cast<uint2*>(a.o + base + (long)t * C + c) =
                      make_uint2(pack_bf16(o4.x, o4.y),
                                 pack_bf16(o4.z, o4.w));
                });
  cluster.sync();  // no block leaves while another reads its shared memory
}

// k and v [n] float32 -> bf16, four values a thread and step: the
// reference's rounding of k and v to the compute dtype, once, for the
// tensor-core core's cp.async tiles.
__global__ void __launch_bounds__(256)
round_kv_kernel(const float4* __restrict__ k, const float4* __restrict__ v,
                uint2* __restrict__ k16, uint2* __restrict__ v16, long n4) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    const float4 x = k[i], y = v[i];
    k16[i] = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
    v16[i] = make_uint2(pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
  }
}

template <int D, int NW>
int launch_mma(const RelMmaArgs& a, int B, int splits, cudaStream_t stream) {
  using L = RelTiles<D, NW>;
  auto kernel = rel_attention_mma_kernel<D, NW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.T + L::rows - 1) / L::rows) * splits, a.H, B);
  cfg.blockDim = dim3(32 * NW);
  cfg.dynamicSmemBytes = L::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;  // the key splits of one query tile
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int D>
int launch_mma_rows(const RelMmaArgs& a, int B, int rows, int splits,
                    cudaStream_t s) {
  switch (rows) {
    case 16: return launch_mma<D, 1>(a, B, splits, s);
    case 32: return launch_mma<D, 2>(a, B, splits, s);
    case 64: return launch_mma<D, 4>(a, B, splits, s);
    default: return -1;
  }
}

}  // namespace dvt

extern "C" int dvt_rel_attention(const float* q, const float* k,
                                 const float* v, const int* lengths,
                                 const void* ek, const void* ev, int e_dt,
                                 float* o, int B, int T, int H, int D, int W,
                                 int cdt, float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535) return -1;
  if (W < 0 || 2 * W + 1 > 32) return -1;
  const dvt::RelArgs a{q, k, v, lengths, ek, ev, o, T, H, W, e_dt, cdt, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return dvt::launch<8>(a, B, s);
    case 16: return dvt::launch<16>(a, B, s);
    case 32: return dvt::launch<32>(a, B, s);
    case 64: return dvt::launch<64>(a, B, s);
    case 128: return dvt::launch<128>(a, B, s);
    default: return -1;
  }
}

// The bf16 route. q float32 [B, T, H*D] (8-byte aligned), k and v bf16
// (16-byte aligned), o bf16 (8-byte aligned); `rows` and `splits` are the
// plan of ops/_cuda.py rel_attention_plan: 16, 32 or 64 query rows a block
// and 1, 2, 4 or 8 key splits, at most one per 16 keys. Refuses (-1) what
// the plan refuses and misaligned pointers.
extern "C" int dvt_rel_attention_mma(const float* q, const void* k,
                                     const void* v, const int* lengths,
                                     const void* ek, const void* ev, int e_dt,
                                     void* o, int B, int T, int H, int D,
                                     int W, float scale, int rows, int splits,
                                     void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535) return -1;
  if (W < 0 || 2 * W + 1 > dvt::kBand - 1) return -1;
  if (splits != 1 && splits != 2 && splits != 4 && splits != 8) return -1;
  if (splits > (T + dvt::kSplitKeys - 1) / dvt::kSplitKeys) return -1;
  if (((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) &
       15) ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(o)) & 7))
    return -1;
  const dvt::RelMmaArgs a{q,
                          static_cast<const __nv_bfloat16*>(k),
                          static_cast<const __nv_bfloat16*>(v),
                          lengths,
                          ek,
                          ev,
                          static_cast<__nv_bfloat16*>(o),
                          T,
                          H,
                          W,
                          e_dt,
                          scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return dvt::launch_mma_rows<8>(a, B, rows, splits, s);
    case 16: return dvt::launch_mma_rows<16>(a, B, rows, splits, s);
    case 32: return dvt::launch_mma_rows<32>(a, B, rows, splits, s);
    case 64: return dvt::launch_mma_rows<64>(a, B, rows, splits, s);
    case 128: return dvt::launch_mma_rows<128>(a, B, rows, splits, s);
    default: return -1;
  }
}

// k, v float32 [n] (16-byte aligned, n a multiple of 4) -> k16, v16 bf16
// (8-byte aligned); refuses (-1) anything else.
extern "C" int dvt_round_kv(const float* k, const float* v, void* k16,
                            void* v16, long n, void* stream) {
  if (n <= 0 || n % 4 ||
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) &
       15) ||
      ((reinterpret_cast<uintptr_t>(k16) | reinterpret_cast<uintptr_t>(v16)) &
       7))
    return -1;
  const long n4 = n / 4;
  const long blocks = (n4 + 255) / 256 < 132 * 8 ? (n4 + 255) / 256 : 132 * 8;
  dvt::round_kv_kernel<<<(int)blocks, 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(k), reinterpret_cast<const float4*>(v),
      static_cast<uint2*>(k16), static_cast<uint2*>(v16), n4);
  return (int)cudaGetLastError();
}
