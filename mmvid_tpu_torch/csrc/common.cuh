// Shared helpers of the mmvid_tpu_torch CUDA kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmvid {

// dtype codes passed from Python (the _*DTYPE_CODES tables of ops/*.py).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// sum over the 32 lanes of a warp, the result in every lane
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// All blocks of a cooperative launch (co-resident by construction) meet
// here.  count and gen are two uints in device memory, zeroed once; count
// returns to 0 after every barrier.  Writes before the barrier are visible
// after it through L2 (read them with __ldcg: an SM's L1 may hold an older
// copy).
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned* gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* vgen = gen;
    const unsigned g = *vgen;
    __threadfence();
    if (atomicAdd(count, 1u) == gridDim.x - 1) {
      atomicExch(count, 0u);
      __threadfence();
      atomicAdd(gen, 1u);
    } else {
      while (*vgen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

}  // namespace mmvid
