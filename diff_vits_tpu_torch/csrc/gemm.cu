// Tiled GEMM with fused prologues and epilogues: the matrix products of the
// four fused UNet kernels (K1-K4 of the JAX package).
//
//   out[m, n] = epilogue( sum_k prologue(A)[m, k] * Bm[k, n] )
//
// Bm is read through two strides, so a weight is taken in the layout its
// module stores it (nn.Linear [N, K], nn.Conv1d [N, Ci, taps]) or in the
// JAX package's (Dense [K, N], Conv [taps, Ci, N]) without a copy: element
// (k, n) lies at k * sb_k + n * sb_n. For a k=3 conv the reduction index k
// runs over (tap, ci) in the order the weight is stored, so that one stride
// spans it: tap-major k = tap * Ci + ci for the JAX layout, tap-minor
// k = ci * 3 + tap for nn.Conv1d's. The tile loader walks the unit-stride
// index fastest. Norm weights and biases are read in their own dtype
// (norm_dtype, bias_dtype).
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
// K <= 3072, N <= 2048) the products are small; this first version is a
// plain FMA kernel (64x64 tile, 4x4 outputs a thread, float32 accumulation)
// and is bound by its FMA issue rate, far below the tensor-core roof. What
// the design buys: the normalised / activated / shifted A operand and the
// GEGLU [M, 8C] intermediate never touch device memory.
#include <stdint.h>

#include "common.cuh"

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
};

constexpr int BM = 64, BN = 64, BK = 16, kThreads = 256;

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

// What the prologue needs of A's column k; one per thread and k-step, since
// a thread loads one column of the A tile (and four of its rows).
struct ACol {
  int tap, ci, g;   // conv tap, input channel, GroupNorm group
  float w, beta;    // norm affine (1, 0 without a norm)
  bool ok;          // k < K
};

__device__ __forceinline__ ACol a_col(const GemmArgs& p, int k) {
  ACol c;
  c.ok = k < p.K;
  split_k(p, c.ok ? k : 0, c.tap, c.ci);
  c.g = p.norm == kGroupNorm ? c.ci / (p.Ci / p.G) : 0;
  c.w = 1.f;
  c.beta = 0.f;
  if (c.ok && p.norm != kNoNorm) {
    c.w = ld(p.norm_w, c.ci, p.norm_dtype);
    c.beta = ld(p.norm_b, c.ci, p.norm_dtype);
  }
  return c;
}

// Element (row (b, t), column c) of A after the prologue; b < 0 marks a row
// past M.
__device__ __forceinline__ float load_a(const GemmArgs& p, int b, int t,
                                        const ACol& c) {
  if (!c.ok || b < 0) return 0.f;
  int ts = t;
  if (p.taps == 3) {
    ts = t + c.tap - 1;
    if (ts < 0 || ts >= p.T) return 0.f;
  }
  const long row = (long)b * p.T + ts;
  float v = ld(p.a, row * p.Ci + c.ci, p.a_dtype);
  if (p.norm == kLayerNorm) {
    v = (v - p.stat_mean[row]) * p.stat_rstd[row];
  } else if (p.norm == kGroupNorm) {
    const int bg = b * p.G + c.g;
    v = (v - p.stat_mean[bg]) * p.stat_rstd[bg];
  }
  if (p.norm != kNoNorm) v = v * c.w + c.beta;
  if (p.film != nullptr) {
    const float* f = p.film + (long)b * 2 * p.Ci;
    v = v * (1.f + f[c.ci]) + f[p.Ci + c.ci];
  }
  if (p.silu) v = v / (1.f + expf(-v));
  return round_to(v, p.b_dtype);
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

template <bool GEGLU>
__global__ void __launch_bounds__(kThreads) gemm_kernel(const GemmArgs p) {
  // rows padded by 4 floats: 16-byte aligned for vector reads, and a
  // k-fastest B store spreads over the banks
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[GEGLU ? 2 : 1][BK][BN + 4];
  const int z = blockIdx.z;
  const void* __restrict__ bmat = p.b[z];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const bool n_fast = p.sb_n == 1;

  // this thread loads column a_k of the A tile, rows a_r + kRowStep * i
  constexpr int kARows = BM * BK / kThreads, kRowStep = kThreads / BK;
  const int a_k = tid % BK, a_r = tid / BK;
  int ab[kARows], at[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int m = m0 + a_r + kRowStep * i;
    ab[i] = m < p.M ? m / p.T : -1;
    at[i] = m - max(ab[i], 0) * p.T;
  }

  float acc[4][4], acc2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = acc2[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    const ACol col = a_col(p, k0 + a_k);
#pragma unroll
    for (int i = 0; i < kARows; ++i)
      As[a_k][a_r + kRowStep * i] = load_a(p, ab[i], at[i], col);
#pragma unroll
    for (int i = 0; i < (BK * BN) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int kk = n_fast ? e / BN : e % BK;
      const int c = n_fast ? e % BN : e / BK;
      const int k = k0 + kk, n = n0 + c;
      const bool ok = k < p.K && n < p.N;
      const long off = (long)k * p.sb_k + (long)n * p.sb_n;
      Bs[0][kk][c] = ok ? ld(bmat, off, p.b_dtype) : 0.f;
      if (GEGLU)
        Bs[GEGLU ? 1 : 0][kk][c] =
            ok ? ld(bmat, off + (long)p.N * p.sb_n, p.b_dtype) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[4], bg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bv[j] = Bs[0][kk][tx * 4 + j];
        bg[j] = GEGLU ? Bs[GEGLU ? 1 : 0][kk][tx * 4 + j] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
          if (GEGLU) acc2[i][j] = fmaf(a[i], bg[j], acc2[i][j]);
        }
    }
    __syncthreads();
  }

  const void* __restrict__ bias = p.bias[z];
  void* __restrict__ out = p.out[z];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= p.N) continue;
      float v = acc[i][j];
      if (GEGLU) {
        const float gate =
            acc2[i][j] + (bias ? ld(bias, p.N + n, p.bias_dtype) : 0.f);
        v = (v + (bias ? ld(bias, n, p.bias_dtype) : 0.f)) * gelu_erf(gate);
      } else {
        if (bias) v += ld(bias, n, p.bias_dtype);
        if (p.res) v += ld(p.res, (long)m * p.N + n, p.res_dtype);
      }
      st(out, (long)m * p.N + n, v, p.out_dtype);
    }
  }
}

}  // namespace dvt

extern "C" int dvt_gemm_args_size() { return (int)sizeof(dvt::GemmArgs); }

extern "C" int dvt_gemm(const dvt::GemmArgs* args, void* stream) {
  const dvt::GemmArgs& p = *args;
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.T <= 0 || p.Ci <= 0) return -1;
  if (p.problems < 1 || p.problems > 3) return -1;
  if (p.taps != 1 && p.taps != 3) return -1;
  if (p.K != p.taps * p.Ci) return -1;
  if (p.norm == dvt::kGroupNorm && (p.G <= 0 || p.Ci % p.G != 0)) return -1;
  const dim3 grid((p.N + dvt::BN - 1) / dvt::BN, (p.M + dvt::BM - 1) / dvt::BM,
                  p.problems);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.geglu) {
    dvt::gemm_kernel<true><<<grid, dvt::kThreads, 0, s>>>(p);
  } else {
    dvt::gemm_kernel<false><<<grid, dvt::kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
