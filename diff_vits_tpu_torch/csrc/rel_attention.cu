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
//   o[t]  = sum_s p[s] v_s + sum_m p[t + m - W] ev[m]   (ev float32, :79-82)
//
// q, k, v, o are float32 [B, T, H*D]; lengths int32 [B] or null (no mask);
// ek, ev [2W+1, D] in e_dt. A masked row (t >= len) has every score -1e4
// and so attends uniformly, as in the reference.
//
// Design: one block per (b, head, 16 queries), four warps of four queries
// each; keys stream through shared memory in tiles of 32, one key per lane,
// so the [T, T] scores never exist (at T = 601 a head's would be 1.4 MB
// against a block's 227 KB). The softmax is online: per query a running
// max, a per-lane partial sum and a float32 PV accumulator (lane-owned
// output dims d = lane + 32 n), all rescaled when the max rises. The band
// is not materialised either: the 2W+1 logits q_t . ek[m] are computed
// once per query into shared memory and added to the lane whose key lies in
// the band, and lane m < 2W+1 keeps the running (unnormalised) probability
// of key t + m - W, fetched with one shuffle per tile and rescaled like the
// accumulator. What bounds it on the H100: FMA and shuffle issue (no tensor
// cores at this first version); it moves q, k, v and o once per query
// block and reads k and v from L2 again for every block of queries.
#include "common.cuh"

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
