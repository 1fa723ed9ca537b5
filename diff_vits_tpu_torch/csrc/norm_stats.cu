// Two-pass normalisation statistics: mean and rstd per (batch, group).
//
// Serves both norms of the fused UNet blocks:
//   GroupNorm (K1, ops/fused_resnet.py): x [B, T, C], G groups, one block
//     per (b, g) reducing T * C/G values;
//   LayerNorm (K2-K4, ops/fused_transformer.py): rows [M, C] are passed as
//     B = M, T = 1, G = 1, one block per row.
// The variance is the mean of squared deviations from the mean (two passes
// over the data), as in the reference's plain formulation
// (diff_vits_tpu/ops/fused_resnet.py:93-99), not E[x^2] - mean^2. The
// statistics feed the GEMM prologues in gemm.cu; the normalised tensor is
// never written. Bound by bytes: each input is read twice (the second read
// mostly from L2).
#include "common.cuh"

namespace dvt {

constexpr int kStatsThreads = 256;

__global__ void __launch_bounds__(kStatsThreads)
norm_stats_kernel(const void* __restrict__ x, int dt, float* __restrict__ mean,
                  float* __restrict__ rstd, int T, int C, int G, float eps) {
  __shared__ float scratch[kStatsThreads / 32];
  const int bg = blockIdx.x;
  const int b = bg / G, g = bg - b * G;
  const int cg = C / G;
  const long base = (long)b * T * C + (long)g * cg;
  const int n = T * cg;

  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = i / cg, c = i - t * cg;
    s += ld(x, base + (long)t * C + c, dt);
  }
  const float mu = block_sum(s, scratch) / (float)n;

  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = i / cg, c = i - t * cg;
    const float d = ld(x, base + (long)t * C + c, dt) - mu;
    ss += d * d;
  }
  const float var = block_sum(ss, scratch) / (float)n;
  if (threadIdx.x == 0) {
    mean[bg] = mu;
    rstd[bg] = rsqrtf(var + eps);
  }
}

}  // namespace dvt

extern "C" int dvt_norm_stats(const void* x, int dt, float* mean, float* rstd,
                              int B, int T, int C, int G, float eps,
                              void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || G <= 0 || C % G != 0) return -1;
  dvt::norm_stats_kernel<<<B * G, dvt::kStatsThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, dt, mean, rstd, T, C, G, eps);
  return (int)cudaGetLastError();
}
