// Multi-head scaled-dot-product attention with an optional additive key
// bias: the score/softmax/PV core of the fused UNet attention kernels K2
// (self) and K3 (cross) of the JAX package
// (diff_vits_tpu/ops/fused_transformer.py:41-67).
//
//   o[b, t, h*D:(h+1)*D] = softmax_s(scale * q.k_s + bias[b, s]) . v_s
//
// q [B, T, H*D], k and v [B, S, H*D], o [B, T, H*D], all one dtype; bias
// [B, S] float32 or null. The scale multiplies the product, as in the
// reference (fused_transformer.py:57-59); the bias is added, not a -inf
// mask. One block per (b, head, 64 queries), one thread per query holding
// its q row and float32 accumulator in registers; K and V tiles of 64 keys
// are staged in shared memory and read by every thread as broadcasts. The
// softmax is online (running max and sum), so the [T, S] scores never
// exist in memory. What bounds it on the H100: FMA issue at head dims
// 8-64, which fill no tensor-core tile; it moves only q, k, v and o.
#include "common.cuh"

namespace dvt {

constexpr int kQ = 64, kKV = 64;

template <int D>
__global__ void __launch_bounds__(kQ)
attention_kernel(const void* __restrict__ q, const void* __restrict__ k,
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

template <int D>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, int B, int T, int S, int H, int dt, float scale,
           cudaStream_t s) {
  const dim3 grid((T + kQ - 1) / kQ, H, B);
  attention_kernel<D><<<grid, kQ, 0, s>>>(q, k, v, bias, o, T, S, H * D, dt,
                                          scale);
  return (int)cudaGetLastError();
}

}  // namespace dvt

extern "C" int dvt_attention(const void* q, const void* k, const void* v,
                             const float* bias, void* o, int B, int T, int S,
                             int H, int D, int dt, float scale, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return dvt::launch<8>(q, k, v, bias, o, B, T, S, H, dt, scale, s);
    case 16: return dvt::launch<16>(q, k, v, bias, o, B, T, S, H, dt, scale, s);
    case 32: return dvt::launch<32>(q, k, v, bias, o, B, T, S, H, dt, scale, s);
    case 48: return dvt::launch<48>(q, k, v, bias, o, B, T, S, H, dt, scale, s);
    case 64: return dvt::launch<64>(q, k, v, bias, o, B, T, S, H, dt, scale, s);
    default: return -1;
  }
}
