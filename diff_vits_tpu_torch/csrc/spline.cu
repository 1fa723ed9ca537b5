// Linear-tail rational-quadratic spline, forward or inverse, and its
// log|det|: kernel K7, replacing the Pallas kernel unconstrained_rqs_pallas
// of diff_vits_tpu/ops/spline_pallas.py:132 (_kernel :32). The math is that
// of the XLA formulation diff_vits_tpu/ops/spline.py:56-194:
//
//   widths  = min_w + (1 - min_w * nb) * softmax(uw); edges on
//             [-tb, tb] by cumulative sum, the outer two exactly -tb, tb
//   heights = the same of uh
//   derivs  = min_d + softplus(ud), padded at knots 0 and nb with the
//             constant whose softplus is 1 - min_d (d_edge, from the host)
//   bin     = the count of interior right edges <= clamp(x, -tb, tb)
//             (searchsorted with the top edge nudged by 1e-6, which a
//             clamped input never reaches)
//   forward: theta = (x - cw) / w; y = ch + h (delta theta^2 + d0 theta
//            (1 - theta)) / (delta + s theta (1 - theta))
//   inverse: the root 2c / (-b - sqrt(max(b^2 - 4ac, 0))) of the quadratic
//   outside [-tb, tb]: identity, log|det| = 0.
//
// x [N] (float32 or bfloat16) with any element stride; uw, uh [N, nb] and
// ud [N, nb - 1] with unit stride along the bins and any row stride (slices
// of one projection); out [N] in x's dtype, logdet [N] float32. Always
// float32 inside.
//
// What bounds it on the H100: at the SDP's N = 4,808 (nb = 10) the bytes,
// 4 * 3 nb read and 8 written an element in float32, take 0.2 us, under
// a launch's own cost; what is left is the latency of one element's chain
// (two softmaxes, two cumulative sums, a bin search, the rational form) and
// how many SMs share the work. So an element is spread over a group of G
// lanes, nb rounded up to a power of two (16 at nb = 10, two elements a
// warp): lane k holds bin k of the widths and heights and knot k of the
// derivatives, so a row's loads are one contiguous run; the softmaxes'
// max and sum are log2(G) xor-shuffles in the group, the edges an inclusive
// shuffle scan, the bin a ballot of `xc >= right edge` counted with popc,
// and the bin's edges and knot derivatives come from lanes idx and idx + 1
// by shuffle. Every lane of a group ends with the same values; lane 0
// stores. Blocks of kThreads = 128 threads (8 elements at G = 16; the
// least device time of 32 to 256 at the SDP's shape) give N = 4,808 601
// blocks, all resident at once. Fewer lanes an element (several bins a
// lane) issue fewer instructions but lengthen each lane's chain, and were
// slower (PERF.md, tools/torch_spline_probe.py).
#include "common.cuh"

namespace dvt {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kThreads = 128;  // a block: whole groups, whole warps

struct SplineArgs {
  const void* x;
  const void* uw;
  const void* uh;
  const void* ud;
  long sx, sw, sh, sd;  // element stride of x, row strides of the rest
  void* out;
  float* logdet;
  long n;
  int x_dt, p_dt, inverse;
  float tb, min_w, min_h, min_d, d_edge;
};

// lanes of an element: nb rounded up to a power of two
template <int NB>
constexpr int kLanes = NB <= 4 ? 4 : NB <= 8 ? 8 : 16;

__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// The right edge of bin k (lane k of a G-lane group; lanes k >= NB hold
// u = -inf) on [-tb, tb] from unnormalised sizes u: softmax over the group,
// a floor of min_frac, an inclusive scan; the last bin's edge exactly tb.
template <int NB, int G>
__device__ __forceinline__ float right_edge(float u, int k, float min_frac,
                                            float tb) {
  float mx = u;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off, G));
  const float p = k < NB ? expf(u - mx) : 0.f;
  float sum = p;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kAll, sum, off, G);
  float cum = k < NB ? min_frac + (1.f - min_frac * NB) * (p / sum) : 0.f;
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const float v = __shfl_up_sync(kAll, cum, off, G);
    if (k >= off) cum += v;
  }
  return k >= NB - 1 ? tb : 2.f * tb * cum - tb;
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
    spline_group_kernel(const SplineArgs a) {
  constexpr int G = kLanes<NB>;
  const int lane = threadIdx.x & 31;
  const int k = lane & (G - 1);
  const long e = ((long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  // a group past the end computes the last element again and stores
  // nothing, so every lane of the warp takes part in every shuffle
  const bool valid = e < a.n;
  const long r = valid ? e : a.n - 1;

  const float x = ld(a.x, r * a.sx, a.x_dt);
  const float uw = k < NB ? ld(a.uw, r * a.sw + k, a.p_dt) : -INFINITY;
  const float uh = k < NB ? ld(a.uh, r * a.sh + k, a.p_dt) : -INFINITY;
  // lane k: the derivative at knot k (knots 0 and NB are d_edge)
  float dk = a.d_edge;
  if (k >= 1 && k < NB)
    dk = a.min_d + softplus(ld(a.ud, r * a.sd + k - 1, a.p_dt));

  const float rw = right_edge<NB, G>(uw, k, a.min_w, a.tb);
  const float rh = right_edge<NB, G>(uh, k, a.min_h, a.tb);

  const bool inside = x >= -a.tb && x <= a.tb;
  const float xc = fminf(fmaxf(x, -a.tb), a.tb);
  const unsigned hit =
      __ballot_sync(kAll, k < NB - 1 && xc >= (a.inverse ? rh : rw));
  const int idx = __popc((hit >> (lane & ~(G - 1))) & ((1u << G) - 1));

  const int below = idx > 0 ? idx - 1 : 0;
  const float w_hi = __shfl_sync(kAll, rw, idx, G);
  const float w_lo = __shfl_sync(kAll, rw, below, G);
  const float h_hi = __shfl_sync(kAll, rh, idx, G);
  const float h_lo = __shfl_sync(kAll, rh, below, G);
  const float d0 = __shfl_sync(kAll, dk, idx, G);
  // knot idx + 1 is lane idx + 1, or d_edge past the last bin (a lane that
  // may not exist when NB == G)
  const float d_next = __shfl_sync(kAll, dk, idx + 1, G);
  const float d1 = idx == NB - 1 ? a.d_edge : d_next;
  const float c_w = idx > 0 ? w_lo : -a.tb;
  const float c_h = idx > 0 ? h_lo : -a.tb;
  const float w = w_hi - c_w;
  const float h = h_hi - c_h;

  const float delta = h / w;
  const float s = d0 + d1 - 2.f * delta;
  float y, ld_v;
  if (a.inverse) {
    const float dy = xc - c_h;
    const float qa = dy * s + h * (delta - d0);
    const float qb = h * d0 - dy * s;
    const float qc = -delta * dy;
    const float disc = qb * qb - 4.f * qa * qc;
    const float root = (2.f * qc) / (-qb - sqrtf(fmaxf(disc, 0.f)));
    y = root * w + c_w;
    const float tom = root * (1.f - root);
    const float den = delta + s * tom;
    const float num = delta * delta * (d1 * root * root + 2.f * delta * tom +
                                       d0 * (1.f - root) * (1.f - root));
    ld_v = -(logf(num) - 2.f * logf(den));
  } else {
    const float theta = (xc - c_w) / w;
    const float tom = theta * (1.f - theta);
    const float den = delta + s * tom;
    y = c_h + h * (delta * theta * theta + d0 * tom) / den;
    const float num = delta * delta * (d1 * theta * theta + 2.f * delta * tom +
                                       d0 * (1.f - theta) * (1.f - theta));
    ld_v = logf(num) - 2.f * logf(den);
  }
  if (valid && k == 0) {
    st(a.out, e, inside ? y : x, a.x_dt);
    a.logdet[e] = inside ? ld_v : 0.f;
  }
}

template <int NB>
int launch(const SplineArgs& a, cudaStream_t s) {
  constexpr int per_block = kThreads / kLanes<NB>;
  const long blocks = (a.n + per_block - 1) / per_block;
  spline_group_kernel<NB><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace dvt

// flags: bit 0 x is bfloat16, bit 1 the parameters are, bit 2 inverse.
// consts (host memory): tail_bound, min_w, min_h, min_d, d_edge.
extern "C" int dvt_spline(const void* x, long sx, const void* uw, long sw,
                          const void* uh, long sh, const void* ud, long sd,
                          void* out, float* logdet, long n, int num_bins,
                          int flags, const float* consts, void* stream) {
  if (n <= 0 || n > 0x7fffffffL || consts[0] <= 0.f) return -1;
  const dvt::SplineArgs a{x,         uw,        uh,        ud,
                          sx,        sw,        sh,        sd,
                          out,       logdet,    n,         flags & 1,
                          (flags >> 1) & 1,     (flags >> 2) & 1,
                          consts[0], consts[1], consts[2], consts[3],
                          consts[4]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_bins) {
    case 4: return dvt::launch<4>(a, s);
    case 8: return dvt::launch<8>(a, s);
    case 10: return dvt::launch<10>(a, s);
    case 16: return dvt::launch<16>(a, s);
    default: return -1;
  }
}
