// Scaled-dot-product attention with a key-padding mask, forward and
// backward: kernel K8, the counterpart of the flash-attention route of the
// JAX package (diff_vits_tpu/ops/flash_attention.py:81 sdpa, which calls
// jax.experimental.pallas.ops.tpu.flash_attention: a forward kernel and its
// own dq and dkv backward kernels, float32 partials).
//
//   o[b,h,t]   = sum_s p[t,s] v[b,h,s],  p[t,.] = softmax(scale q.k + bias)
//   lse[b,h,t] = log sum_s exp(scale q.k_s + bias_s)             (float32)
//   bias_s     = 0 where keep[b,s], -10000 where not, added in float32 as
//                the port's plain version does (ops/flash_attention.py)
//
// q [B, H, T, D], k and v [B, H, S, D]; o, dout, dq like q, dk and dv like
// k. Each is read or written through its own batch, head and row strides
// with a unit last stride, so the heads split off the [B, T, H*D] output
// of a projection need no copy. One dtype (float32 or bfloat16) for all of
// them; the arithmetic is float32. D is any multiple of 8 up to 128.
//
// Forward: one thread per query row (its q row and float32 accumulator in
// registers), 128 rows a block; K and V tiles staged in shared memory and
// read by every thread as broadcasts; an online softmax, so the [T, S]
// scores never exist in memory. It writes o and the row log-sum-exp.
//
// Backward, FlashAttention-2 style and deterministic (no atomics): a dQ
// kernel, one thread per query row looping over key tiles, which first
// forms its row's delta = rowsum(dout * o) in float32 and stores it; then a
// dK/dV kernel, one thread per key row looping over query tiles (q, dout,
// lse and delta staged in shared memory), which reads those deltas. Both
// recompute p = exp(scale q.k + bias - lse) from the saved log-sum-exp and
// ds = p (dout.v - delta); dq = scale ds k, dk = scale ds^T q, dv = p^T dout.
//
// What bounds it on the H100: FMA and exp issue. At this model's head dims
// (8-32) one query row fills no tensor-core tile; each score costs 2D FMAs
// and one exp in the forward (about 4D FMAs and one exp in each backward
// kernel) against device-memory traffic of q, k, v, o (dout, dq, dk, dv)
// read or written once per block. One row a thread keeps every operand in
// registers up to D = 64 (the dK/dV kernel spills a little at 56 and 64);
// above 64 the per-row loops are not unrolled and the rows live in local
// memory, which keeps the build short for head dims no site of this model
// has. Tensor cores (mma.sync, wgmma) and TMA are later work.
#include "common.cuh"

namespace dvt {

// A [B, H, L, D] tensor with a unit last stride.
struct View {
  void* p;
  long sb, sh, sl;
};

struct FlashArgs {
  View q, k, v, o, dout, dq, dk, dv;
  float* lse;                  // [B, H, T]
  float* delta;                // [B, H, T], written by the dQ kernel
  const unsigned char* keep;   // [B, S], 1 keep / 0 masked; null: keep all
  int B, H, T, S, D, dt;
  float scale;
};

constexpr int kThreads = 128;       // rows (queries or keys) a block

// Unroll a loop over the head dim, so the row arrays stay in registers, up
// to D = 64; wider rows spill anyway, and unrolling them only slows nvcc.
#define DVT_UNROLL_D _Pragma("unroll (D <= 64 ? D : 1)")
constexpr float kMaskedBias = -10000.f;

__device__ __forceinline__ long row_of(const View& x, int b, int h, int r) {
  return (long)b * x.sb + (long)h * x.sh + (long)r * x.sl;
}

__device__ __forceinline__ float key_bias(const FlashArgs& a, int b, int s) {
  return (a.keep == nullptr || a.keep[(long)b * a.S + s]) ? 0.f
                                                          : kMaskedBias;
}

// Rows r0 .. r0 + n - 1 of x and y into X and Y as float32.
template <int D>
__device__ __forceinline__ void stage(float (*X)[D], float (*Y)[D],
                                      const View& x, const View& y, int b,
                                      int h, int r0, int n, int dt) {
  for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    X[r][d] = ld(x.p, row_of(x, b, h, r0 + r) + d, dt);
    Y[r][d] = ld(y.p, row_of(y, b, h, r0 + r) + d, dt);
  }
}

// Rows a shared-memory tile holds: 32 KB of float32 for the two tiles.
__host__ __device__ constexpr int tile_rows(int d) { return d <= 64 ? 64 : 32; }

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashArgs a) {
  constexpr int NK = tile_rows(D);
  __shared__ float Ks[NK][D];
  __shared__ float Vs[NK][D];
  __shared__ float Bs[NK];
  const int b = blockIdx.z, h = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const bool active = t < a.T;
  const long qo = row_of(a.q, b, h, active ? t : 0);

  float qr[D], acc[D];
DVT_UNROLL_D
  for (int d = 0; d < D; ++d) {
    qr[d] = ld(a.q.p, qo + d, a.dt);
    acc[d] = 0.f;
  }
  float mx = -INFINITY, l = 0.f;
  for (int s0 = 0; s0 < a.S; s0 += NK) {
    const int ns = min(NK, a.S - s0);
    stage<D>(Ks, Vs, a.k, a.v, b, h, s0, ns, a.dt);
    for (int e = threadIdx.x; e < ns; e += kThreads)
      Bs[e] = key_bias(a, b, s0 + e);
    __syncthreads();
    for (int r = 0; r < ns; ++r) {
      float sc = 0.f;
DVT_UNROLL_D
      for (int d = 0; d < D; ++d) sc = fmaf(qr[d], Ks[r][d], sc);
      sc = sc * a.scale + Bs[r];
      if (sc > mx) {  // new running max: rescale what was summed so far
        const float corr = expf(mx - sc);
        l *= corr;
DVT_UNROLL_D
        for (int d = 0; d < D; ++d) acc[d] *= corr;
        mx = sc;
      }
      const float p = expf(sc - mx);
      l += p;
DVT_UNROLL_D
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, Vs[r][d], acc[d]);
    }
    __syncthreads();
  }
  if (active) {
    const float inv = 1.f / l;
    const long oo = row_of(a.o, b, h, t);
DVT_UNROLL_D
    for (int d = 0; d < D; ++d) st(a.o.p, oo + d, acc[d] * inv, a.dt);
    a.lse[((long)b * a.H + h) * a.T + t] = mx + logf(l);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(FlashArgs a) {
  constexpr int NK = tile_rows(D);
  __shared__ float Ks[NK][D];
  __shared__ float Vs[NK][D];
  __shared__ float Bs[NK];
  const int b = blockIdx.z, h = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const bool active = t < a.T;
  const int tt = active ? t : 0;
  const long qo = row_of(a.q, b, h, tt), go = row_of(a.dout, b, h, tt),
             oo = row_of(a.o, b, h, tt);

  float qr[D], gr[D], dq[D];
  float delta = 0.f;
DVT_UNROLL_D
  for (int d = 0; d < D; ++d) {
    qr[d] = ld(a.q.p, qo + d, a.dt);
    gr[d] = ld(a.dout.p, go + d, a.dt);
    delta = fmaf(gr[d], ld(a.o.p, oo + d, a.dt), delta);
    dq[d] = 0.f;
  }
  const long ri = ((long)b * a.H + h) * a.T + tt;
  const float lse = a.lse[ri];
  if (active) a.delta[ri] = delta;
  for (int s0 = 0; s0 < a.S; s0 += NK) {
    const int ns = min(NK, a.S - s0);
    stage<D>(Ks, Vs, a.k, a.v, b, h, s0, ns, a.dt);
    for (int e = threadIdx.x; e < ns; e += kThreads)
      Bs[e] = key_bias(a, b, s0 + e);
    __syncthreads();
    for (int r = 0; r < ns; ++r) {
      float sc = 0.f, dp = 0.f;
DVT_UNROLL_D
      for (int d = 0; d < D; ++d) {
        sc = fmaf(qr[d], Ks[r][d], sc);
        dp = fmaf(gr[d], Vs[r][d], dp);
      }
      const float p = expf(sc * a.scale + Bs[r] - lse);
      const float ds = p * (dp - delta);
DVT_UNROLL_D
      for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, Ks[r][d], dq[d]);
    }
    __syncthreads();
  }
  if (active) {
    const long dqo = row_of(a.dq, b, h, t);
DVT_UNROLL_D
    for (int d = 0; d < D; ++d) st(a.dq.p, dqo + d, dq[d] * a.scale, a.dt);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(FlashArgs a) {
  constexpr int NQ = tile_rows(D);
  __shared__ float Qs[NQ][D];
  __shared__ float Gs[NQ][D];
  __shared__ float Ls[NQ];
  __shared__ float Ds[NQ];
  const int b = blockIdx.z, h = blockIdx.y;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const bool active = s < a.S;
  const int ss = active ? s : 0;
  const long ko = row_of(a.k, b, h, ss), vo = row_of(a.v, b, h, ss);

  float kr[D], vr[D], dk[D], dv[D];
DVT_UNROLL_D
  for (int d = 0; d < D; ++d) {
    kr[d] = ld(a.k.p, ko + d, a.dt);
    vr[d] = ld(a.v.p, vo + d, a.dt);
    dk[d] = 0.f;
    dv[d] = 0.f;
  }
  const float bias = key_bias(a, b, ss);
  const long rows = ((long)b * a.H + h) * a.T;
  for (int t0 = 0; t0 < a.T; t0 += NQ) {
    const int nt = min(NQ, a.T - t0);
    stage<D>(Qs, Gs, a.q, a.dout, b, h, t0, nt, a.dt);
    for (int e = threadIdx.x; e < nt; e += kThreads) {
      Ls[e] = a.lse[rows + t0 + e];
      Ds[e] = a.delta[rows + t0 + e];
    }
    __syncthreads();
    for (int i = 0; i < nt; ++i) {
      float sc = 0.f, dp = 0.f;
DVT_UNROLL_D
      for (int d = 0; d < D; ++d) {
        sc = fmaf(Qs[i][d], kr[d], sc);
        dp = fmaf(Gs[i][d], vr[d], dp);
      }
      const float p = expf(sc * a.scale + bias - Ls[i]);
      const float ds = p * (dp - Ds[i]);
DVT_UNROLL_D
      for (int d = 0; d < D; ++d) {
        dv[d] = fmaf(p, Gs[i][d], dv[d]);
        dk[d] = fmaf(ds, Qs[i][d], dk[d]);
      }
    }
    __syncthreads();
  }
  if (active) {
    const long dko = row_of(a.dk, b, h, s), dvo = row_of(a.dv, b, h, s);
DVT_UNROLL_D
    for (int d = 0; d < D; ++d) {
      st(a.dk.p, dko + d, dk[d] * a.scale, a.dt);
      st(a.dv.p, dvo + d, dv[d], a.dt);
    }
  }
}

template <int D>
int launch_forward(const FlashArgs& a, cudaStream_t s) {
  const dim3 grid((a.T + kThreads - 1) / kThreads, a.H, a.B);
  flash_fwd_kernel<D><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_backward(const FlashArgs& a, cudaStream_t s) {
  const dim3 gq((a.T + kThreads - 1) / kThreads, a.H, a.B);
  flash_bwd_dq_kernel<D><<<gq, kThreads, 0, s>>>(a);  // writes delta first
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const dim3 gk((a.S + kThreads - 1) / kThreads, a.H, a.B);
  flash_bwd_dkdv_kernel<D><<<gk, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool kForward>
int dispatch(const FlashArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0 || a->T <= 0 || a->S <= 0 || a->B > 65535 ||
      a->H > 65535 || (a->dt != kF32 && a->dt != kBF16))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->D) {
#define DVT_FLASH_CASE(d) \
  case d:                 \
    return kForward ? launch_forward<d>(*a, s) : launch_backward<d>(*a, s);
    DVT_FLASH_CASE(8) DVT_FLASH_CASE(16) DVT_FLASH_CASE(24)
    DVT_FLASH_CASE(32) DVT_FLASH_CASE(40) DVT_FLASH_CASE(48)
    DVT_FLASH_CASE(56) DVT_FLASH_CASE(64) DVT_FLASH_CASE(72)
    DVT_FLASH_CASE(80) DVT_FLASH_CASE(88) DVT_FLASH_CASE(96)
    DVT_FLASH_CASE(104) DVT_FLASH_CASE(112) DVT_FLASH_CASE(120)
    DVT_FLASH_CASE(128)
#undef DVT_FLASH_CASE
    default:
      return -1;
  }
}

}  // namespace dvt

extern "C" int dvt_flash_forward(const dvt::FlashArgs* a, void* stream) {
  return dvt::dispatch<true>(a, stream);
}

extern "C" int dvt_flash_backward(const dvt::FlashArgs* a, void* stream) {
  return dvt::dispatch<false>(a, stream);
}

extern "C" int dvt_flash_args_size() {
  return (int)sizeof(dvt::FlashArgs);
}
