// The merge of a query tile's key splits over a thread-block cluster, for
// the attention kernels that split their keys (csrc/attention.cu,
// csrc/rel_attention.cu). Each block of the cluster keeps, in its shared
// memory, the partial of its key range for the tile's rows: the
// unnormalised output part[r * pld + c], the row's max pm[r] (base-2
// units) and its sum pl[r]. After a cluster barrier, block `rank` merges
// rows [lo, lo + n) reading every block's partial over distributed shared
// memory in rank order, so every launch gives the same bits. A split
// without a key (max -inf) merges with weight 0: no exp2(-inf - -inf).
#pragma once

#include <cooperative_groups.h>

#include "mma.cuh"

namespace dvt {

namespace cg = cooperative_groups;

constexpr int kMaxSplits = 8;  // the portable cluster size

// wts[r * kMaxSplits + sp] = exp2(m_sp - M) / sum for rows [lo, lo + n),
// M the rows' max over the splits and sum = sum_sp exp2(m_sp - M) l_sp;
// M and 1 / sum also into row_max[r] and row_inv[r] when those are given.
__device__ __forceinline__ void merge_weights(cg::cluster_group& cluster,
                                              float* pm, float* pl,
                                              float* wts, float* row_max,
                                              float* row_inv, int lo, int n,
                                              int splits) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    float mx = -INFINITY;
    for (int sp = 0; sp < splits; ++sp)
      mx = fmaxf(mx, cluster.map_shared_rank(pm, sp)[lo + r]);
    float sum = 0.f;
    for (int sp = 0; sp < splits; ++sp) {  // rank order
      const float ms = cluster.map_shared_rank(pm, sp)[lo + r];
      const float w = ms == -INFINITY ? 0.f : fast_exp2(ms - mx);
      sum += w * cluster.map_shared_rank(pl, sp)[lo + r];
      wts[r * kMaxSplits + sp] = w;
    }
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    for (int sp = 0; sp < splits; ++sp) wts[r * kMaxSplits + sp] *= inv;
    if (row_max != nullptr) {
      row_max[r] = mx;
      row_inv[r] = inv;
    }
  }
}

// The merged output of rows [lo, lo + n), four columns at a time:
// emit(r, c, a) with a = sum_sp wts[r][sp] part_sp[lo + r][c .. c + 3].
template <int D, class Emit>
__device__ __forceinline__ void merge_rows(cg::cluster_group& cluster,
                                           float* part, int pld,
                                           const float* wts, int lo, int n,
                                           int splits, Emit emit) {
  for (int e = threadIdx.x; e < n * (D / 4); e += blockDim.x) {
    const int r = e / (D / 4), c = (e - r * (D / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {  // rank order: the same sum
      const float w = wts[r * kMaxSplits + sp];
      const float4 x = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, sp) + (lo + r) * pld + c);
      a.x += w * x.x;
      a.y += w * x.y;
      a.z += w * x.z;
      a.w += w * x.w;
    }
    emit(r, c, a);
  }
}

}  // namespace dvt
