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
// Two routes, chosen by the plan (ops/_cuda.py flash_plan: bfloat16 at a
// head dim up to 64 runs the tensor-core kernels, everything else the FMA
// ones):
//
// bfloat16, D <= 64: tensor cores (mma.sync m16n8k16, an m16n8k8 step for
// the last 8 of a D that is 8 past a multiple of 16). A warp owns 16 rows
// (queries, or keys in dK/dV), their operands held as A fragments in
// registers; a block is 1, 2 or 4 warps of one (b, head) (the plan's rows).
// Tiles of 64 rows of the other side come in by a cp.async double buffer
// (16-byte chunks, zero-filled past the end), so tile i+1 loads while tile
// i computes, and are read by ldmatrix (ldmatrix.trans where they are the
// right operand along their rows). A product's C fragments are the A
// fragment of the next product (c_to_a_split), so p and ds never leave
// registers; they go in as two bf16 parts (hi + lo), two mma.sync against
// the same exact bf16 operand, so P V, dS K, P^T dO and dS^T Q are float32
// accurate like the plain version's (one bf16 rounding of p moved a
// layer's weight gradients by percents through its ReLUs). Per score: one
// FFMA and one ex2 (scale folded into log2 e) without a mask; with one,
// the product is rounded, scaled and biased as the plain version does,
// then one FFMA and one ex2.
//   * flash_fwd_mma_kernel: S = Q K^T, the online softmax in base 2 in the
//     accumulators (running max and sum, float32), O += P V (V by
//     ldmatrix.trans); writes o and lse = (m + log2 l) ln 2.
//   * flash_bwd_dq_mma_kernel: first delta = rowsum(dO * O) in float32
//     for the warp's rows (stored for dK/dV); then over key tiles, 16 keys
//     at a time: S = Q K^T, P = exp2(S scale log2e + bias log2e - lse
//     log2e), dP = dO V^T (dO's A fragments in registers, V by ldmatrix),
//     dS = P (dP - delta), dQ += dS K (K by ldmatrix.trans).
//   * flash_bwd_dkdv_mma_kernel: the same chain transposed, keys as rows
//     (K and V as A fragments), over query tiles (Q and dO by cp.async,
//     lse and delta staged), 16 queries at a time: S^T = K Q^T, P^T, dV +=
//     P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q.
//     Query columns past T get p = 0 explicitly (a zero-filled q row
//     scores 0, and exp(0 - lse) is not 0).
// Keys past the last one an item keeps add exactly 0 where the item keeps
// one (their -10000 bias puts exp below float32's range), so every mma
// kernel stops its key loop there (each block scans its item's keep row),
// and dK/dV blocks wholly past it write zeros. An item that keeps no key
// runs all S keys: its softmax is uniform over the masked keys, as in the
// plain version. Keys past S score -inf, not the bias. The views must be
// 16-byte aligned with strides in multiples of 8 elements (the cp.async
// chunks and the bf16-pair loads); the dispatcher refuses others (-1),
// and the wrapper raises before that.
//
// What bounds the tensor-core route on the H100: not its work. At the DP
// UNet's level-0 self attention (B=32, 8 heads, T=S=601, d=8) the forward
// is 0.74 GFLOP and 2.5 MB; on tensor cores and HBM that is under 3 us.
// Its floor is the exponential: 92.5 M scores, one ex2 each on the
// special-function unit (16 a clock an SM), about 25 us, and the backward
// recomputes p in both of its kernels; then the issue of the softmax's
// FFMAs, the fragments' shuffles and the per-block chain of key tiles.
//
// float32 (the exact parity route) and bfloat16 above D = 64: the FMA
// kernels. One thread per query row (or key row in dK/dV), its row and
// float32 accumulator in registers, 128 rows a block; K and V (or Q and
// dO) tiles staged in shared memory as float32 and read by every thread as
// broadcasts; each score costs 2D FMAs (about 4D in each backward kernel)
// and one exp. Up to D = 64 the per-row loops are unrolled and the rows
// stay in registers (the dK/dV kernel spills a little at 56 and 64); above
// 64 they live in local memory, which keeps the build short. The
// tensor-core kernels stop at 64 because the dK/dV kernel keeps K, V, dK
// and dV of its 16 rows in registers: 192 a thread at D = 128 before the
// scores.
//
// Both routes are deterministic: no atomics; the dQ kernel runs before the
// dK/dV kernel on the stream, and two launches give the same bits.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

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
  int qrows;                   // query rows a block: forward and dQ
  int krows;                   // key rows a block: dK/dV
  int mma;                     // 1: the tensor-core kernels (bfloat16)
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

// ---------------------------------------------------------------------------
// Bfloat16 route: tensor cores. A warp's 16 rows are g = lane / 4 and g + 8;
// a thread holds columns c2 = 2 (lane % 4) and c2 + 1 of each 8-wide tile.

constexpr int kTile = 64;    // rows of the other side a shared-memory tile
constexpr int kStages = 2;   // tiles in flight: the cp.async ring
constexpr int kMmaMaxD = 64;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of the mma kernels: a ring of kStages buffers, each two
// bf16 tiles [kTile][ld] (K and V, or Q and dO) and two float vectors
// [kTile] (the keys' bias, or the queries' lse and delta). ld is an odd
// multiple of 16 bytes, so the 8 rows one ldmatrix reads fall in distinct
// banks.
template <int D>
struct MmaTiles {
  static constexpr int ld = (D / 8) % 2 ? D : D + 8;
  static constexpr int tile = kTile * ld;
  static constexpr int vec_off = kStages * 2 * tile * 2;  // bytes
  static constexpr int bytes = vec_off + kStages * 2 * kTile * 4;
};

__device__ __forceinline__ const __nv_bfloat16* head_of(const View& x, int b,
                                                         int h) {
  return static_cast<const __nv_bfloat16*>(x.p) + (long)b * x.sb +
         (long)h * x.sh;
}

// Rows r and r + 8 of x (rows >= n read as 0) as A fragments over D.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[kSteps<D>][4],
                                       const __nv_bfloat16* x, long sl, int r,
                                       int n, int lane) {
  const int c2 = (lane & 3) * 2;
  const bool ok0 = r < n, ok1 = r + 8 < n;
  const uint32_t* p0 =
      reinterpret_cast<const uint32_t*>(x + (ok0 ? (long)r * sl : 0));
  const uint32_t* p1 =
      reinterpret_cast<const uint32_t*>(x + (ok1 ? (long)(r + 8) * sl : 0));
#pragma unroll
  for (int kk = 0; kk < kSteps<D>; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = kk * 16 + (i >> 1) * 8;
      const bool ok = (i & 1) ? ok1 : ok0;
      f[kk][i] = (col < D && ok) ? ((i & 1) ? p1 : p0)[(col + c2) >> 1] : 0u;
    }
}

// Rows r and r + 8 of acc (a warp's C fragments over D, times s0 and s1)
// into x as bf16 pairs; rows >= n are not written.
template <int D>
__device__ __forceinline__ void store_c(__nv_bfloat16* x, long sl, int r,
                                        int n, const float (&acc)[D / 8][4],
                                        float s0, float s1, int lane) {
  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r < n)
      *reinterpret_cast<uint32_t*>(x + (long)r * sl + j * 8 + c2) =
          pack_bf16(acc[j][0] * s0, acc[j][1] * s0);
    if (r + 8 < n)
      *reinterpret_cast<uint32_t*>(x + (long)(r + 8) * sl + j * 8 + c2) =
          pack_bf16(acc[j][2] * s1, acc[j][3] * s1);
  }
}

// Start the copies of rows r0 .. r0 + kTile - 1 of x and y (one (b, head)
// each, row strides xs and ys) into tiles xt and yt; rows >= n are
// zero-filled. The caller commits the group.
template <int D>
__device__ __forceinline__ void fetch_tiles(__nv_bfloat16* xt,
                                            __nv_bfloat16* yt,
                                            const __nv_bfloat16* x, long xs,
                                            const __nv_bfloat16* y, long ys,
                                            int r0, int n) {
  constexpr int per_row = D / 8, ld = MmaTiles<D>::ld;
  for (int c = threadIdx.x; c < kTile * per_row; c += blockDim.x) {
    const int r = c / per_row, col = (c - r * per_row) * 8;
    const bool ok = r0 + r < n;
    const long row = ok ? r0 + r : 0;
    cp_async16(xt + r * ld + col, x + row * xs + col, ok ? 16 : 0);
    cp_async16(yt + r * ld + col, y + row * ys + col, ok ? 16 : 0);
  }
}

// One past the last key item b keeps: keys from there on add exactly 0
// (their p underflows) as long as one key is kept. S when the item keeps
// none, or there is no mask. Every thread of the block gets it.
__device__ __forceinline__ int kept_end(const FlashArgs& a, int b, int* red) {
  if (a.keep == nullptr) return a.S;
  if (threadIdx.x == 0) *red = -1;
  __syncthreads();
  int last = -1;
  for (int s = threadIdx.x; s < a.S; s += blockDim.x)
    if (a.keep[(long)b * a.S + s]) last = s;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    last = max(last, __shfl_xor_sync(kFull, last, off));
  if ((threadIdx.x & 31) == 0 && last >= 0) atomicMax(red, last);
  __syncthreads();
  return *red < 0 ? a.S : *red + 1;
}

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_mma_kernel(FlashArgs a) {
  using L = MmaTiles<D>;
  __shared__ __align__(128) unsigned char smem[L::bytes];
  __shared__ int red;
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  float* bs = reinterpret_cast<float*>(smem + L::vec_off);
  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c2 = (lane & 3) * 2;
  const int r0 = blockIdx.x * (blockDim.x / 2) + warp * 16 + (lane >> 2);
  const int ke = kept_end(a, b, &red);
  const bool masked = a.keep != nullptr;
  const float f = masked ? kLog2e : a.scale * kLog2e;
  const __nv_bfloat16* kp = head_of(a.k, b, h);
  const __nv_bfloat16* vp = head_of(a.v, b, h);

  auto fetch = [&](int k0, int buf) {
    __nv_bfloat16* kt = tiles + 2 * buf * L::tile;
    fetch_tiles<D>(kt, kt + L::tile, kp, a.k.sl, vp, a.v.sl, k0, ke);
    if (masked)
      for (int r = tid; r < kTile; r += blockDim.x)
        bs[buf * kTile + r] =
            k0 + r < ke && !a.keep[(long)b * a.S + k0 + r] ? kMaskedBias
                                                           : 0.f;
  };

  uint32_t qa[kSteps<D>][4];
  load_a<D>(qa, head_of(a.q, b, h), a.q.sl, r0, a.T, lane);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int ntiles = (ke + kTile - 1) / kTile;
  fetch(0, 0);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it % kStages, k0 = it * kTile;
    cp_async_wait<0>();
    // tile it is in shared memory for every warp, and every warp is done
    // with tile it - 1, whose buffer the next fetch refills
    __syncthreads();
    if (it + 1 < ntiles) fetch(k0 + kTile, (it + 1) % kStages);
    cp_async_commit();
    const __nv_bfloat16* kt = tiles + 2 * buf * L::tile;
    const __nv_bfloat16* vt = kt + L::tile;
    const float* bt = bs + buf * kTile;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mma_rows<D, 8>(s, qa, kt, L::ld, lane);

    // base 2: a score x enters as exp2(x f - m), m the running max of x f;
    // without a mask x is the raw product and f = scale log2(e), one FFMA
    // an element; with one, x = scale q.k + bias, the product rounded
    // before the sum as the plain version rounds it, and f = log2(e)
    if (masked) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bv = *reinterpret_cast<const float2*>(bt + j * 8 + c2);
        s[j][0] = __fmul_rn(s[j][0], a.scale) + bv.x;
        s[j][1] = __fmul_rn(s[j][1], a.scale) + bv.y;
        s[j][2] = __fmul_rn(s[j][2], a.scale) + bv.x;
        s[j][3] = __fmul_rn(s[j][3], a.scale) + bv.y;
      }
    }
    if (k0 + kTile > ke) {  // the last tile: keys past ke score -inf
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + j * 8 + c2 + e >= ke) s[j][e] = s[j][2 + e] = -INFINITY;
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
    // every row has a key with a finite score in the first tile (ke >= 1)
    const float n0 = fmaxf(m0, mx0 * f), n1 = fmaxf(m1, mx1 * f);
    const float c0 = fast_exp2(m0 - n0), c1 = fast_exp2(m1 - n1);
    m0 = n0;
    m1 = n1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c0;
      acc[j][2] *= c1;
      acc[j][3] *= c1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = fast_exp2(fmaf(s[j][0], f, -n0));
      s[j][1] = fast_exp2(fmaf(s[j][1], f, -n0));
      s[j][2] = fast_exp2(fmaf(s[j][2], f, -n1));
      s[j][3] = fast_exp2(fmaf(s[j][3], f, -n1));
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    // O += P V: the probabilities of keys 16kk.. as one bf16 A fragment
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[2][4];
      c_to_a_split(pa, s[2 * kk], s[2 * kk + 1]);
      mma_cols<D>(acc, pa, vt + kk * 16 * L::ld, L::ld, lane);
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o.p) + (long)b * a.o.sb +
                      (long)h * a.o.sh;
  store_c<D>(op, a.o.sl, r0, a.T, acc, 1.f / l0, 1.f / l1, lane);
  if ((lane & 3) == 0) {
    float* lse = a.lse + ((long)b * a.H + h) * a.T;
    if (r0 < a.T) lse[r0] = (m0 + log2f(l0)) * kLn2;
    if (r0 + 8 < a.T) lse[r0 + 8] = (m1 + log2f(l1)) * kLn2;
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_mma_kernel(FlashArgs a) {
  using L = MmaTiles<D>;
  __shared__ __align__(128) unsigned char smem[L::bytes];
  __shared__ int red;
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  float* bs = reinterpret_cast<float*>(smem + L::vec_off);
  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c2 = (lane & 3) * 2;
  const int r0 = blockIdx.x * (blockDim.x / 2) + warp * 16 + (lane >> 2);
  const int ke = kept_end(a, b, &red);
  const bool masked = a.keep != nullptr;
  const float f = masked ? kLog2e : a.scale * kLog2e;
  const __nv_bfloat16* kp = head_of(a.k, b, h);
  const __nv_bfloat16* vp = head_of(a.v, b, h);

  auto fetch = [&](int k0, int buf) {
    __nv_bfloat16* kt = tiles + 2 * buf * L::tile;
    fetch_tiles<D>(kt, kt + L::tile, kp, a.k.sl, vp, a.v.sl, k0, ke);
    if (masked)
      for (int r = tid; r < kTile; r += blockDim.x)
        bs[buf * kTile + r] =
            k0 + r < ke && !a.keep[(long)b * a.S + k0 + r] ? kMaskedBias
                                                           : 0.f;
  };
  fetch(0, 0);
  cp_async_commit();

  uint32_t qa[kSteps<D>][4], ga[kSteps<D>][4];
  load_a<D>(qa, head_of(a.q, b, h), a.q.sl, r0, a.T, lane);
  load_a<D>(ga, head_of(a.dout, b, h), a.dout.sl, r0, a.T, lane);
  // delta = rowsum(dout * o) in float32 over the rows' fragments, then
  // over the four threads of a row
  float d0 = 0.f, d1 = 0.f;
  {
    uint32_t oa[kSteps<D>][4];
    load_a<D>(oa, head_of(a.o, b, h), a.o.sl, r0, a.T, lane);
#pragma unroll
    for (int kk = 0; kk < kSteps<D>; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = unpack_bf16(ga[kk][i]), y = unpack_bf16(oa[kk][i]);
        const float v = fmaf(x.y, y.y, x.x * y.x);
        if (i & 1)
          d1 += v;
        else
          d0 += v;
      }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    d0 += __shfl_xor_sync(kFull, d0, off);
    d1 += __shfl_xor_sync(kFull, d1, off);
  }
  const long rows = ((long)b * a.H + h) * a.T;
  const float ls0 = r0 < a.T ? a.lse[rows + r0] * kLog2e : 0.f;
  const float ls1 = r0 + 8 < a.T ? a.lse[rows + r0 + 8] * kLog2e : 0.f;
  if ((lane & 3) == 0) {
    if (r0 < a.T) a.delta[rows + r0] = d0;
    if (r0 + 8 < a.T) a.delta[rows + r0 + 8] = d1;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int ntiles = (ke + kTile - 1) / kTile;
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it % kStages, k0 = it * kTile;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < ntiles) fetch(k0 + kTile, (it + 1) % kStages);
    cp_async_commit();
    const __nv_bfloat16* kt = tiles + 2 * buf * L::tile;
    const __nv_bfloat16* vt = kt + L::tile;
    const float* bt = bs + buf * kTile;
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {  // 16 keys at a time
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_rows<D, 2>(s, qa, kt + kc * 16 * L::ld, L::ld, lane);
      mma_rows<D, 2>(dp, ga, vt + kc * 16 * L::ld, L::ld, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kc * 16 + j * 8 + c2 + (e & 1);
          float x = s[j][e];
          if (masked) x = __fmul_rn(x, a.scale) + bt[key];
          const float p = k0 + key < ke
                              ? fast_exp2(fmaf(x, f, (e & 2) ? -ls1 : -ls0))
                              : 0.f;
          s[j][e] = p * (dp[j][e] - ((e & 2) ? d1 : d0));
        }
      uint32_t da[2][4];
      c_to_a_split(da, s[0], s[1]);
      mma_cols<D>(acc, da, kt + kc * 16 * L::ld, L::ld, lane);
    }
  }
  store_c<D>(static_cast<__nv_bfloat16*>(a.dq.p) + (long)b * a.dq.sb +
                 (long)h * a.dq.sh,
             a.dq.sl, r0, a.T, acc, a.scale, a.scale, lane);
}

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dkdv_mma_kernel(FlashArgs a) {
  using L = MmaTiles<D>;
  __shared__ __align__(128) unsigned char smem[L::bytes];
  __shared__ int red;
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  float* vecs = reinterpret_cast<float*>(smem + L::vec_off);
  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c2 = (lane & 3) * 2;
  const int rows = blockDim.x / 2;
  const int s0 = blockIdx.x * rows + warp * 16 + (lane >> 2);
  const int ke = kept_end(a, b, &red);
  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(a.dk.p) +
                       (long)b * a.dk.sb + (long)h * a.dk.sh;
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(a.dv.p) +
                       (long)b * a.dv.sb + (long)h * a.dv.sh;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  if ((int)blockIdx.x * rows >= ke) {  // every key of the block adds exactly 0
    store_c<D>(dkp, a.dk.sl, s0, a.S, dk, 1.f, 1.f, lane);
    store_c<D>(dvp, a.dv.sl, s0, a.S, dv, 1.f, 1.f, lane);
    return;
  }
  const bool masked = a.keep != nullptr;
  const float f = masked ? kLog2e : a.scale * kLog2e;
  const __nv_bfloat16* qp = head_of(a.q, b, h);
  const __nv_bfloat16* gp = head_of(a.dout, b, h);
  const long qrow = ((long)b * a.H + h) * a.T;

  auto fetch = [&](int t0, int buf) {
    __nv_bfloat16* qt = tiles + 2 * buf * L::tile;
    fetch_tiles<D>(qt, qt + L::tile, qp, a.q.sl, gp, a.dout.sl, t0, a.T);
    float* lt = vecs + 2 * buf * kTile;
    for (int r = tid; r < kTile; r += blockDim.x) {
      const bool ok = t0 + r < a.T;
      lt[r] = ok ? a.lse[qrow + t0 + r] * kLog2e : 0.f;
      lt[kTile + r] = ok ? a.delta[qrow + t0 + r] : 0.f;
    }
  };
  fetch(0, 0);
  cp_async_commit();

  uint32_t ka[kSteps<D>][4], va[kSteps<D>][4];
  load_a<D>(ka, head_of(a.k, b, h), a.k.sl, s0, a.S, lane);
  load_a<D>(va, head_of(a.v, b, h), a.v.sl, s0, a.S, lane);
  auto bias = [&](int s) {
    return masked && s < a.S && !a.keep[(long)b * a.S + s] ? kMaskedBias
                                                           : 0.f;
  };
  const float b0 = bias(s0), b1 = bias(s0 + 8);

  const int ntiles = (a.T + kTile - 1) / kTile;
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it % kStages, t0 = it * kTile;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < ntiles) fetch(t0 + kTile, (it + 1) % kStages);
    cp_async_commit();
    const __nv_bfloat16* qt = tiles + 2 * buf * L::tile;
    const __nv_bfloat16* gt = qt + L::tile;
    const float* lt = vecs + 2 * buf * kTile;  // lse log2(e), then delta
    const float* dl = lt + kTile;
#pragma unroll
    for (int qc = 0; qc < kTile / 16; ++qc) {  // 16 queries at a time
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      mma_rows<D, 2>(st, ka, qt + qc * 16 * L::ld, L::ld, lane);
      mma_rows<D, 2>(dpt, va, gt + qc * 16 * L::ld, L::ld, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = qc * 16 + j * 8 + c2 + (e & 1);
          float x = st[j][e];
          if (masked) x = __fmul_rn(x, a.scale) + ((e & 2) ? b1 : b0);
          const float p =
              t0 + t < a.T ? fast_exp2(fmaf(x, f, -lt[t])) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dl[t]);
        }
      uint32_t pa[2][4], da[2][4];
      c_to_a_split(pa, st[0], st[1]);
      mma_cols<D>(dv, pa, gt + qc * 16 * L::ld, L::ld, lane);
      c_to_a_split(da, dpt[0], dpt[1]);
      mma_cols<D>(dk, da, qt + qc * 16 * L::ld, L::ld, lane);
    }
  }
  store_c<D>(dkp, a.dk.sl, s0, a.S, dk, a.scale, a.scale, lane);
  store_c<D>(dvp, a.dv.sl, s0, a.S, dv, 1.f, 1.f, lane);
}

// ---------------------------------------------------------------------------
// Launch.

template <int D>
int launch_forward(const FlashArgs& a, cudaStream_t s) {
  if (a.mma) {
    if constexpr (D <= kMmaMaxD) {
      const dim3 grid((a.T + a.qrows - 1) / a.qrows, a.H, a.B);
      flash_fwd_mma_kernel<D><<<grid, 2 * a.qrows, 0, s>>>(a);
      return (int)cudaGetLastError();
    }
    return -1;
  }
  const dim3 grid((a.T + kThreads - 1) / kThreads, a.H, a.B);
  flash_fwd_kernel<D><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_backward(const FlashArgs& a, cudaStream_t s) {
  if (a.mma) {
    if constexpr (D <= kMmaMaxD) {
      const dim3 gq((a.T + a.qrows - 1) / a.qrows, a.H, a.B);
      flash_bwd_dq_mma_kernel<D><<<gq, 2 * a.qrows, 0, s>>>(a);  // delta
      const int rc = (int)cudaGetLastError();
      if (rc != 0) return rc;
      const dim3 gk((a.S + a.krows - 1) / a.krows, a.H, a.B);
      flash_bwd_dkdv_mma_kernel<D><<<gk, 2 * a.krows, 0, s>>>(a);
      return (int)cudaGetLastError();
    }
    return -1;
  }
  const dim3 gq((a.T + kThreads - 1) / kThreads, a.H, a.B);
  flash_bwd_dq_kernel<D><<<gq, kThreads, 0, s>>>(a);  // writes delta first
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const dim3 gk((a.S + kThreads - 1) / kThreads, a.H, a.B);
  flash_bwd_dkdv_kernel<D><<<gk, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// A view the mma kernels' 16-byte copies and bf16-pair loads can take.
inline bool mma_view(const View& x) {
  return !(reinterpret_cast<uintptr_t>(x.p) & 15) &&
         !((x.sb | x.sh | x.sl) & 7);
}

inline bool rows_ok(int r) { return r == 16 || r == 32 || r == 64; }

template <bool kForward>
int dispatch(const FlashArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0 || a->T <= 0 || a->S <= 0 || a->B > 65535 ||
      a->H > 65535 || (a->dt != kF32 && a->dt != kBF16))
    return -1;
  if (a->mma) {
    if (a->dt != kBF16 || a->D > kMmaMaxD || !rows_ok(a->qrows) ||
        (!kForward && !rows_ok(a->krows)) || !mma_view(a->q) ||
        !mma_view(a->k) || !mma_view(a->v) || !mma_view(a->o))
      return -1;
    if (!kForward && (!mma_view(a->dout) || !mma_view(a->dq) ||
                      !mma_view(a->dk) || !mma_view(a->dv)))
      return -1;
  } else if (a->qrows != kThreads || a->krows != kThreads) {
    return -1;
  }
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
