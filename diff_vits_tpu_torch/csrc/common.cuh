// Shared helpers of the port's kernels.
//
// Every kernel takes its tensors as untyped pointers plus a dtype flag
// (0 = float32, 1 = bfloat16) and computes in float32; the flag is uniform
// across a launch, so the branch in ld/st costs no divergence. The C entry
// points return the launch's cudaGetLastError() so the Python wrapper can
// raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dvt {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float ld(const void* p, long i, int dt) {
  return dt == kBF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                     : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, long i, float v, int dt) {
  if (dt == kBF16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// Round a float32 value to the storage type `dt` and back: the point where
// the reference casts an operand to its compute dtype before a product.
__device__ __forceinline__ float round_to(float v, int dt) {
  return dt == kBF16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

// Sum of `v` over the block; every thread gets the result. `scratch` holds
// at least blockDim.x / 32 floats. Safe to call twice in a row.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nwarps; ++w) s += scratch[w];
  return s;
}

}  // namespace dvt
