// Linear-tail rational-quadratic spline, forward or inverse, and its
// log|det|: kernel K7, replacing the Pallas kernel unconstrained_rqs_pallas
// of diff_vits_tpu/ops/spline_pallas.py:132 (_kernel :32). The math is that
// of the XLA formulation diff_vits_tpu/ops/spline.py:56-194:
//
//   widths  = min_w + (1 - min_w * nb) * softmax(uw); edges on
//             [-tb, tb] by cumulative sum, the outer two exactly -tb, tb
//   heights = the same of uh
//   derivs  = min_d + softplus(ud), padded at knots 0 and nb with the
//             constant whose softplus is 1 - min_d
//   bin     = the count of interior right edges <= clamp(x, -tb, tb)
//             (searchsorted with the top edge nudged by 1e-6, which a
//             clamped input never reaches)
//   forward: theta = (x - cw) / w; y = ch + h (delta theta^2 + d0 theta
//            (1 - theta)) / (delta + s theta (1 - theta))
//   inverse: the root 2c / (-b - sqrt(max(b^2 - 4ac, 0))) of the quadratic
//   outside [-tb, tb]: identity, log|det| = 0.
//
// x [N] (float32 or bfloat16); uw, uh [N, nb] and ud [N, nb - 1] with unit
// stride along the bins and any row stride (slices of one projection);
// out [N] in x's dtype, logdet [N] float32. Always float32 inside.
//
// One thread per element, its nb bins in registers (nb is a template
// argument, so every bin loop unrolls and every bin select is a chain of
// predicated moves, never an indexed load from local memory). What bounds
// it on the H100: the bytes, 4 * (3 nb + 1) read and 8 written a element in
// float32 (128 B at nb = 10); a thread's rows are contiguous, so a warp's
// reads cover whole cache lines.
#include "common.cuh"

namespace dvt {

struct SplineArgs {
  const void* x;
  const void* uw;
  const void* uh;
  const void* ud;
  long sw, sh, sd;  // row strides, elements
  void* out;
  float* logdet;
  long n;
  int x_dt, p_dt, inverse;
  float tb, min_w, min_h, min_d;
};

__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// Edges e[0..NB] of the bins on [-tb, tb] from unnormalised sizes u.
template <int NB>
__device__ __forceinline__ void edges(const float (&u)[NB], float min_frac,
                                      float tb, float (&e)[NB + 1]) {
  float mx = u[0];
#pragma unroll
  for (int k = 1; k < NB; ++k) mx = fmaxf(mx, u[k]);
  float p[NB], sum = 0.f;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    p[k] = expf(u[k] - mx);
    sum += p[k];
  }
  float cum = 0.f;
  e[0] = -tb;
#pragma unroll
  for (int k = 0; k < NB - 1; ++k) {
    cum += min_frac + (1.f - min_frac * NB) * (p[k] / sum);
    e[k + 1] = 2.f * tb * cum - tb;
  }
  e[NB] = tb;
}

template <int NB>
__global__ void spline_kernel(const SplineArgs a) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float x = ld(a.x, i, a.x_dt);
  float uw[NB], uh[NB], dk[NB + 1];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    uw[k] = ld(a.uw, i * a.sw + k, a.p_dt);
    uh[k] = ld(a.uh, i * a.sh + k, a.p_dt);
  }
  // knot derivatives: softplus of the boundary constant at 0 and NB
  const float d_edge = a.min_d + softplus(logf(expf(1.f - a.min_d) - 1.f));
  dk[0] = dk[NB] = d_edge;
#pragma unroll
  for (int k = 1; k < NB; ++k)
    dk[k] = a.min_d + softplus(ld(a.ud, i * a.sd + k - 1, a.p_dt));

  float cw[NB + 1], ch[NB + 1];
  edges<NB>(uw, a.min_w, a.tb, cw);
  edges<NB>(uh, a.min_h, a.tb, ch);

  const bool inside = x >= -a.tb && x <= a.tb;
  const float xc = fminf(fmaxf(x, -a.tb), a.tb);
  int idx = 0;
#pragma unroll
  for (int k = 1; k < NB; ++k) idx += (xc >= (a.inverse ? ch[k] : cw[k]));

  float c_w = 0.f, w = 0.f, c_h = 0.f, h = 0.f, d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if (idx == k) {
      c_w = cw[k];
      w = cw[k + 1] - cw[k];
      c_h = ch[k];
      h = ch[k + 1] - ch[k];
      d0 = dk[k];
      d1 = dk[k + 1];
    }
  }
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
  st(a.out, i, inside ? y : x, a.x_dt);
  a.logdet[i] = inside ? ld_v : 0.f;
}

template <int NB>
int launch(const SplineArgs& a, cudaStream_t s) {
  constexpr int kThreads = 128;
  const long blocks = (a.n + kThreads - 1) / kThreads;
  spline_kernel<NB><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace dvt

extern "C" int dvt_spline(const void* x, int x_dt, const void* uw, long sw,
                          const void* uh, long sh, const void* ud, long sd,
                          int p_dt, void* out, float* logdet, long n,
                          int num_bins, int inverse, float tail_bound,
                          float min_w, float min_h, float min_d,
                          void* stream) {
  if (n <= 0 || n > 0x7fffffffL || tail_bound <= 0.f) return -1;
  const dvt::SplineArgs a{x,      uw,   uh,   ud,      sw,   sh,  sd,
                          out,    logdet, n,  x_dt,    p_dt, inverse,
                          tail_bound, min_w, min_h, min_d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_bins) {
    case 4: return dvt::launch<4>(a, s);
    case 8: return dvt::launch<8>(a, s);
    case 10: return dvt::launch<10>(a, s);
    case 16: return dvt::launch<16>(a, s);
    default: return -1;
  }
}
