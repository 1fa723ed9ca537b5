// Multi-head scaled-dot-product attention with an optional additive key
// bias: the score/softmax/PV core of the fused UNet attention kernels K2
// (self, fused_self_attention) and K3 (cross, fused_cross_attention, with
// its [B, 1, S] 0/-10000 key bias) of the JAX package
// (diff_vits_tpu/ops/fused_transformer.py:41-67 _mha, the core of
// _attn_kernel_self :70 and _attn_kernel_cross :79).
//
//   o[b, t, h*D:(h+1)*D] = softmax_s(scale * q.k_s + bias[b, s]) . v_s
//
// q [B, T, H*D], k and v [B, S, H*D], o [B, T, H*D], all one dtype; bias
// [B, S] float32 or null. The scale multiplies the product and the bias is
// added after it in float32, as in the reference; the bias is data, not a
// mask. q, k and v are read in place through the row stride H*D: no
// head-major copy. Head dims 8, 16, 32, 48 and 64.
//
// What bounds it on the H100: not its work. At the UNet's shapes the
// largest launch (denoiser level 0, B=8, T=S=400, 8 heads of 16) is 655
// MFLOP of QK^T and PV and ~3.3 MB of q, k, v and o: 0.7 us of bf16 tensor
// cores, 1 us of HBM. What costs time is latency and issue: how long one
// block's chain of key tiles takes (the softmax's instructions, its exp2
// on the special-function unit), and how few blocks there are to hide it
// (at b=1 a grid of one block per 64 queries and head is 8-56 blocks for
// 132 SMs). The design:
//   * bfloat16 (the serving path): attention_mma_kernel. A warp owns 16
//     query rows and keeps their q as mma.sync A fragments in registers;
//     a block is 1, 2 or 4 warps of one (b, head). Key and value tiles of
//     64 rows come in by cp.async (16-byte chunks, zero-filled past the
//     block's keys), double-buffered, so tile i+1 loads while tile i
//     computes. QK^T runs on mma.sync m16n8k16 (m16n8k8 at D=8) fed by
//     ldmatrix from the K tile; the online softmax (running max and sum,
//     float32, in base 2: one FFMA and one ex2 an element where there is
//     no bias) stays in the accumulator registers, its row max reduced
//     over the four threads of a row with shuffles; key slots past the
//     block's range score -inf, masked on its last tile only. The probabilities become the bf16 A fragments of
//     PV directly (the C layout of two m16n8 tiles is the A layout of one
//     m16n8k16: the reference's cast of p to the compute dtype), and PV
//     runs on mma.sync with V through ldmatrix.trans. A warp covers 8 keys
//     x 16 queries per instruction, where one thread used to walk all S
//     keys alone.
//   * key splits over a thread-block cluster: a host-side plan
//     (ops/_cuda.py attention_plan) picks the rows a block (64, 32 or 16)
//     and 1-8 splits of S (in whole 16-key steps) so that every SM gets a
//     block where the shape allows; more splits cost more in the merge
//     than they save (tools/torch_attention_probe.py). The splits
//     of one query tile are one cluster: each keeps (max, sum, unnormalised
//     output) for its key range in its shared memory, and after a cluster
//     barrier rank r merges rows [r*R/S, (r+1)*R/S) over distributed shared
//     memory in rank order (csrc/split_merge.cuh, shared with the rel-pos
//     attention core), so every launch gives the same bits.
//   * float32 (the parity route): attention_fma_kernel, exact float32 FMA
//     products (no TF32), one thread per query holding its q row and
//     accumulator in registers, K and V tiles of 64 keys in shared memory
//     read as broadcasts, the same online softmax.
// The [T, S] scores never reach memory.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "split_merge.cuh"

namespace dvt {

constexpr int kKV = 64;          // keys a shared-memory tile
constexpr int kStages = 2;       // key tiles in flight: the cp.async ring
constexpr int kSplitKeys = 16;   // a split's key range: whole PV k-steps

// ---------------------------------------------------------------------------
// Float32 route: one thread per query, FMA.

constexpr int kQ = 64;

template <int D>
__global__ void __launch_bounds__(kQ)
attention_fma_kernel(const void* __restrict__ q, const void* __restrict__ k,
                     const void* __restrict__ v, const float* __restrict__ bias,
                     void* __restrict__ o, int T, int S, int C, int dt,
                     float scale) {
  __shared__ float Ks[kKV][D];
  __shared__ float Vs[kKV][D];
  __shared__ float Bs[kKV];
  const int b = blockIdx.z, h = blockIdx.y;
  const int t = blockIdx.x * kQ + threadIdx.x;
  const bool active = t < T;
  const long qbase = ((long)b * T + (active ? t : 0)) * C + (long)h * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? ld(q, qbase + d, dt) : 0.f;
    acc[d] = 0.f;
  }
  float mx = -INFINITY, l = 0.f;

  for (int s0 = 0; s0 < S; s0 += kKV) {
    const int ns = min(kKV, S - s0);
    for (int e = threadIdx.x; e < ns * D; e += kQ) {
      const int r = e / D, d = e - r * D;
      const long off = ((long)b * S + s0 + r) * C + (long)h * D + d;
      Ks[r][d] = ld(k, off, dt);
      Vs[r][d] = ld(v, off, dt);
    }
    for (int e = threadIdx.x; e < ns; e += kQ)
      Bs[e] = bias != nullptr ? bias[(long)b * S + s0 + e] : 0.f;
    __syncthreads();
    for (int r = 0; r < ns; ++r) {
      float sc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) sc = fmaf(qr[d], Ks[r][d], sc);
      sc = sc * scale + Bs[r];
      if (sc > mx) {  // new running max: rescale what was summed so far
        const float corr = expf(mx - sc);
        l *= corr;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] *= corr;
        mx = sc;
      }
      const float p = expf(sc - mx);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, Vs[r][d], acc[d]);
    }
    __syncthreads();
  }
  if (active) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d) st(o, qbase + d, acc[d] * inv, dt);
  }
}

// ---------------------------------------------------------------------------
// Bfloat16 route: tensor cores, cluster key splits.

// Shared-memory layout of attention_mma_kernel<D, NW>. The main
// loop holds a ring of kStages buffers, each a K and a V tile [kKV][ld]
// (bf16), then the tiles' biases (float32); after it, the same bytes hold
// the block's partial for the cluster merge: [rows][pld] unnormalised
// outputs, the rows' max and sum, and this block's merge weights. ld is an
// odd multiple of 16 bytes, so the 8 rows one ldmatrix reads fall in
// distinct banks.
template <int D, int NW>
struct MmaAttn {
  static constexpr int rows = 16 * NW, threads = 32 * NW;
  static constexpr int ld = (D / 8) % 2 ? D : D + 8;
  static constexpr int tile = kKV * ld;
  static constexpr int bias_off = kStages * 2 * tile * 2;  // bytes
  static constexpr int loop_bytes = bias_off + kStages * kKV * 4;
  static constexpr int pld = D + 4;
  static constexpr int merge_bytes =
      (rows * pld + 2 * rows + rows * kMaxSplits) * 4;
  static constexpr int bytes =
      loop_bytes > merge_bytes ? loop_bytes : merge_bytes;
};

template <int D, int NW>
__global__ void __launch_bounds__(32 * NW)
attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ o, int T, int S, int H,
                     float scale) {
  using L = MmaAttn<D, NW>;
  constexpr int KS = D >= 16 ? D / 16 : 1;  // 16-deep steps of QK^T
  constexpr int NO = D / 8;                 // 8-wide output tiles
  __shared__ __align__(128) unsigned char smem[L::bytes];
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem);
  float* bs = reinterpret_cast<float*>(smem + L::bias_off);

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int qt = blockIdx.x / splits, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cq = (lane & 3) * 2;  // a thread's column pair in a C fragment
  // this split's keys [kb, ke): whole 16-key steps, a balanced share
  const int chunks = (S + kSplitKeys - 1) / kSplitKeys;
  const int kb = (int)((long)split * chunks / splits) * kSplitKeys;
  const int ke =
      min((int)((long)(split + 1) * chunks / splits) * kSplitKeys, S);
  const long kv_base = (long)b * S * C + (long)h * D;
  const bool has_bias = bias != nullptr;
  const float f = has_bias ? kLog2e : scale * kLog2e;

  // Start the copies of the tile of keys k0.. into buffer `buf` (the
  // caller commits the group).
  auto fetch = [&](int k0, int buf) {
    __nv_bfloat16* ks = kv + 2 * buf * L::tile;
    __nv_bfloat16* vs = ks + L::tile;
    constexpr int per_row = D / 8;
    for (int c = tid; c < kKV * per_row; c += L::threads) {
      const int r = c / per_row, col = (c - r * per_row) * 8;
      const bool ok = k0 + r < ke;
      const long off = ok ? kv_base + (long)(k0 + r) * C + col : 0;
      cp_async16(ks + r * L::ld + col, k + off, ok ? 16 : 0);
      cp_async16(vs + r * L::ld + col, v + off, ok ? 16 : 0);
    }
    if (has_bias)
      for (int r = tid; r < kKV; r += L::threads)
        bs[buf * kKV + r] = k0 + r < ke ? bias[(long)b * S + k0 + r] : 0.f;
  };

  // this warp's 16 query rows as A fragments: rows g and g + 8 (g = lane /
  // 4), columns cq, cq + 1 and 8 past them; zero past T
  const int r0 = qt * L::rows + warp * 16 + (lane >> 2), r1 = r0 + 8;
  uint32_t qa[KS][4];
  {
    const uint32_t* q2 = reinterpret_cast<const uint32_t*>(q);
    const long q0 = ((long)b * T + r0) * C + (long)h * D, q1 = q0 + 8L * C;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kk * 16 + cq + (i >> 1) * 8;
        const bool ok = ((i & 1) ? r1 : r0) < T && col < D;
        qa[kk][i] = ok ? q2[(((i & 1) ? q1 : q0) + col) >> 1] : 0u;
      }
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // the ring: tiles it + 1 .. it + kStages - 1 load while tile it computes;
  // one group is committed per tile slot, empty past the last tile, so
  // that waiting for all but the newest kStages - 2 groups means tile it
  const int ntiles = ke > kb ? (ke - kb + kKV - 1) / kKV : 0;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles) fetch(kb + st * kKV, st);
    cp_async_commit();
  }
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
    const float* bt = bs + buf * kKV;

    // scores of 16 rows x 64 keys: 8 C fragments
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (D == 8) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t r[4];
        ldmatrix_x4(r, ks + (half * 32 + lane) * L::ld);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mma_m16n8k8(s[half * 4 + i], qa[0][0], qa[0][1], r[i]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t r[4];
          ldmatrix_x4(r, ks + (jp * 16 + (lane & 7) + (lane >> 4) * 8) *
                                  L::ld + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_m16n8k16(s[2 * jp], qa[kk], r[0], r[1]);
          mma_m16n8k16(s[2 * jp + 1], qa[kk], r[2], r[3]);
        }
    }

    // online softmax in base 2: a score x enters as exp2(x * f - m), m the
    // running max of x * f. Without a bias x is the raw product and f =
    // scale * log2(e), one FFMA an element; with one, x = scale * q.k +
    // bias, the product rounded before the sum as the reference rounds it
    // (no contraction into an FMA), and f = log2(e). Key slots past the
    // split score -inf.
    if (has_bias) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bv = *reinterpret_cast<const float2*>(bt + j * 8 + cq);
        s[j][0] = __fmul_rn(s[j][0], scale) + bv.x;
        s[j][1] = __fmul_rn(s[j][1], scale) + bv.y;
        s[j][2] = __fmul_rn(s[j][2], scale) + bv.x;
        s[j][3] = __fmul_rn(s[j][3], scale) + bv.y;
      }
    }
    if (k0 + kKV > ke) {  // the split's last tile
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + j * 8 + cq + e >= ke) s[j][e] = s[j][2 + e] = -INFINITY;
    }
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
    const float n0 = fmaxf(m0, mx0 * f), n1 = fmaxf(m1, mx1 * f);
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
      s[j][0] = fast_exp2(fmaf(s[j][0], f, -u0));
      s[j][1] = fast_exp2(fmaf(s[j][1], f, -u0));
      s[j][2] = fast_exp2(fmaf(s[j][2], f, -u1));
      s[j][3] = fast_exp2(fmaf(s[j][3], f, -u1));
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // PV: the probabilities of keys 16kk.. as one bf16 A fragment
    auto p_frag = [&](int kk, uint32_t (&pa)[4]) {
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    };
    if constexpr (D == 8) {
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {  // 32 keys a ldmatrix
        uint32_t r[4], pa[4];
        ldmatrix_x4_trans(r, vs + (kp * 32 + lane) * L::ld);
        p_frag(2 * kp, pa);
        mma_m16n8k16(acc[0], pa, r[0], r[1]);
        p_frag(2 * kp + 1, pa);
        mma_m16n8k16(acc[0], pa, r[2], r[3]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
        p_frag(kk, pa);
#pragma unroll
        for (int jp = 0; jp < D / 16; ++jp) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vs + (kk * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * L::ld +
                                   jp * 16 + (lane >> 4) * 8);
          mma_m16n8k16(acc[2 * jp], pa, r[0], r[1]);
          mma_m16n8k16(acc[2 * jp + 1], pa, r[2], r[3]);
        }
      }
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }

  const long o0 = ((long)b * T + r0) * C + (long)h * D, o1 = o0 + 8L * C;
  if (splits == 1) {
    const float i0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float i1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + cq;
      if (r0 < T)
        *reinterpret_cast<uint32_t*>(o + o0 + col) =
            pack_bf16(acc[n][0] * i0, acc[n][1] * i0);
      if (r1 < T)
        *reinterpret_cast<uint32_t*>(o + o1 + col) =
            pack_bf16(acc[n][2] * i1, acc[n][3] * i1);
    }
    return;
  }

  // cluster merge (each split's max in the same base-2 units): this
  // block's partial over the loop's buffers, once
  // every warp is done with them (the groups left are empty)
  cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  float* pm = part + L::rows * L::pld;
  float* pl = pm + L::rows;
  float* wts = pl + L::rows;
  const int lr0 = warp * 16 + (lane >> 2), lr1 = lr0 + 8;
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
  cluster.sync();  // every partial is written and visible
  const int rows = L::rows / splits, lo = split * rows;
  merge_weights(cluster, pm, pl, wts, nullptr, nullptr, lo, rows, splits);
  __syncthreads();
  merge_rows<D>(cluster, part, L::pld, wts, lo, rows, splits,
                [&](int r, int c, float4 a) {
                  const int t = qt * L::rows + lo + r;
                  if (t < T)
                    *reinterpret_cast<uint2*>(o + ((long)b * T + t) * C +
                                              (long)h * D + c) =
                        make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
                });
  cluster.sync();  // no block leaves while another reads its partial
}

template <int D, int NW>
int launch_mma(const void* q, const void* k, const void* v, const float* bias,
               void* o, int B, int T, int S, int H, float scale, int splits,
               cudaStream_t stream) {
  constexpr int rows = 16 * NW;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((T + rows - 1) / rows) * splits, H, B);
  cfg.blockDim = dim3(32 * NW);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;  // the key splits of one query tile
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, attention_mma_kernel<D, NW>,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias,
      static_cast<__nv_bfloat16*>(o), T, S, H, scale);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, int B, int T, int S, int H, int dt, float scale, int rows,
           int splits, cudaStream_t s) {
  if (dt == kF32) {
    if (rows != kQ || splits != 1) return -1;
    const dim3 grid((T + kQ - 1) / kQ, H, B);
    attention_fma_kernel<D><<<grid, kQ, 0, s>>>(q, k, v, bias, o, T, S, H * D,
                                                dt, scale);
    return (int)cudaGetLastError();
  }
  if (dt != kBF16) return -1;
  switch (rows) {
    case 16:
      return launch_mma<D, 1>(q, k, v, bias, o, B, T, S, H, scale, splits, s);
    case 32:
      return launch_mma<D, 2>(q, k, v, bias, o, B, T, S, H, scale, splits, s);
    case 64:
      return launch_mma<D, 4>(q, k, v, bias, o, B, T, S, H, scale, splits, s);
    default:
      return -1;
  }
}

}  // namespace dvt

// `rows` and `splits` are the plan of ops/_cuda.py attention_plan: float32
// takes 64 and 1; bfloat16 16, 32 or 64 query rows a block and 1, 2, 4 or
// 8 key splits, at most one per 16 keys.
extern "C" int dvt_attention(const void* q, const void* k, const void* v,
                             const float* bias, void* o, int B, int T, int S,
                             int H, int D, int dt, float scale, int rows,
                             int splits, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535)
    return -1;
  if (dt == dvt::kBF16) {
    if (splits != 1 && splits != 2 && splits != 4 && splits != 8) return -1;
    if (splits > (S + dvt::kSplitKeys - 1) / dvt::kSplitKeys) return -1;
    // k and v in 16-byte copies, q and o in bf16 pairs
    if (((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) &
         15) ||
        ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(o)) &
         7))
      return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8:
      return dvt::launch<8>(q, k, v, bias, o, B, T, S, H, dt, scale, rows,
                            splits, s);
    case 16:
      return dvt::launch<16>(q, k, v, bias, o, B, T, S, H, dt, scale, rows,
                             splits, s);
    case 32:
      return dvt::launch<32>(q, k, v, bias, o, B, T, S, H, dt, scale, rows,
                             splits, s);
    case 48:
      return dvt::launch<48>(q, k, v, bias, o, B, T, S, H, dt, scale, rows,
                             splits, s);
    case 64:
      return dvt::launch<64>(q, k, v, bias, o, B, T, S, H, dt, scale, rows,
                             splits, s);
    default:
      return -1;
  }
}
