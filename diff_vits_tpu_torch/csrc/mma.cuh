// Warp-level tensor-core and asynchronous-copy primitives (sm_80 and up)
// for the kernels that tile their products on mma.sync (csrc/attention.cu,
// csrc/flash_attention.cu): ldmatrix from shared memory, bf16 mma.sync
// with float32 accumulators, the C -> A fragment reuse, 16-byte cp.async
// copies and the base-2 exponential of an online softmax. csrc/gemm.cu
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

}  // namespace dvt
