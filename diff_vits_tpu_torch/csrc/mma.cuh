// Warp-level tensor-core and asynchronous-copy primitives (sm_80 and up)
// for the kernels that tile their products on mma.sync (csrc/attention.cu,
// csrc/flash_attention.cu, csrc/rel_attention.cu): ldmatrix from shared
// memory, bf16 mma.sync with float32 accumulators, the C -> A fragment
// reuse, 16-byte cp.async copies, the base-2 exponential of an online
// softmax, and a warp's 16-row products against a shared tile (QK^T as
// mma_rows, PV as mma_cols). csrc/gemm.cu
// keeps its own copies of these, which tools/torch_gemm_probe.py patches
// to compile parts of the GEMM out.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>

namespace dvt {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (a few ulp; -inf gives +0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Two 8x8 b16 matrices; lanes 0..7 and 8..15 give the row addresses (the
// other lanes' addresses are ignored but kept valid by the callers).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// c += a . b on a 16x8 tile, 16 deep: a row-major (4 registers of bf16
// pairs), b column-major (2), c float32 (4).
__device__ __forceinline__ void mma_m16n8k16(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same, 8 deep: a in 2 registers, b in 1.
__device__ __forceinline__ void mma_m16n8k8(float (&c)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Two float32 values as one register of bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two bf16 values of one register as float32 (lo, hi).
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The C fragments of two adjacent 16x8 tiles (columns 0-7 and 8-15) as
// the A fragment of one 16x16 m16n8k16 operand: the C layout of a warp's
// 16 rows is its A layout, so a product's result feeds the next product
// without leaving registers. It comes as two bf16 fragments whose sum is
// the float32 values to 16 significant bits, a[0] = bf16(c) and a[1] =
// bf16(c - a[0]): a product of both with an exact bf16 operand is one
// float32-accurate product.
__device__ __forceinline__ void c_to_a_split(uint32_t (&a)[2][4],
                                             const float (&c0)[4],
                                             const float (&c1)[4]) {
  const float c[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[0][i] = pack_bf16(c[2 * i], c[2 * i + 1]);
    const float2 hi = unpack_bf16(a[0][i]);
    a[1][i] = pack_bf16(c[2 * i] - hi.x, c[2 * i + 1] - hi.y);
  }
}

// 16-byte global -> shared copy; bytes past `src_bytes` are zero-filled
// (none is read when it is 0, but `src` must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A fragments of a warp's rows over a head dim of D: 16-deep steps, and an
// 8-deep one (registers 0 and 1 of the last entry) when D % 16 == 8.
template <int D>
constexpr int kSteps = D / 16 + (D % 16 != 0);

// s[j] += a . X[8j .. 8j+7, 0:D]^T for the NT 8-row groups of a shared
// tile X (row stride ld): a warp's 16 rows against NT * 8 rows of X, over
// D (ldmatrix: X's rows are the product's columns).
template <int D, int NT>
__device__ __forceinline__ void mma_rows(float (&s)[NT][4],
                                         const uint32_t (&a)[kSteps<D>][4],
                                         const __nv_bfloat16* x, int ld,
                                         int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t r[4];
      ldmatrix_x4(r, x + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                         kk * 16 + ((lane >> 3) & 1) * 8);
      mma_m16n8k16(s[2 * jp], a[kk], r[0], r[1]);
      mma_m16n8k16(s[2 * jp + 1], a[kk], r[2], r[3]);
    }
  if constexpr (D % 16 == 8) {  // the last 8 columns: one matrix a group
    constexpr int kk = D / 16;
#pragma unroll
    for (int j4 = 0; j4 < NT / 4; ++j4) {
      uint32_t r[4];
      ldmatrix_x4(r, x + (j4 * 32 + lane) * ld + kk * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma_m16n8k8(s[j4 * 4 + i], a[kk][0], a[kk][1], r[i]);
    }
    if constexpr (NT % 4 == 2) {
      uint32_t r[2];
      ldmatrix_x2(r, x + ((NT - 2) * 8 + (lane & 15)) * ld + kk * 16);
      mma_m16n8k8(s[NT - 2], a[kk][0], a[kk][1], r[0]);
      mma_m16n8k8(s[NT - 1], a[kk][0], a[kk][1], r[1]);
    }
  }
}

// acc[j] += p . X[0:16, 8j .. 8j+7] for every 8-wide column group j of a
// shared tile X (16 rows from x, row stride ld, D columns): p is a warp's
// A fragment over X's 16 rows in P bf16 parts (one, or the two of
// c_to_a_split), each multiplied with the same X fragments
// (ldmatrix.trans: X's rows are the depth).
template <int D, int P>
__device__ __forceinline__ void mma_cols(float (&acc)[D / 8][4],
                                         const uint32_t (&p)[P][4],
                                         const __nv_bfloat16* x, int ld,
                                         int lane) {
#pragma unroll
  for (int jp = 0; jp < D / 16; ++jp) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, x + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                             jp * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int part = 0; part < P; ++part) {
      mma_m16n8k16(acc[2 * jp], p[part], r[0], r[1]);
      mma_m16n8k16(acc[2 * jp + 1], p[part], r[2], r[3]);
    }
  }
  if constexpr (D % 16 == 8) {
    uint32_t r[2];
    ldmatrix_x2_trans(r, x + (lane & 15) * ld + D - 8);
#pragma unroll
    for (int part = 0; part < P; ++part)
      mma_m16n8k16(acc[D / 8 - 1], p[part], r[0], r[1]);
  }
}

}  // namespace dvt
