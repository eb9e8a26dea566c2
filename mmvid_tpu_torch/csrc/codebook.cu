// Nearest codebook entry (the VQ encoder's lookup), hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mmvid_tpu/ops/codebook.py::_nn_kernel (driven by
// nearest_codebook_indices_pallas).  It computes the same function as that
// kernel and as the plain reference
// mmvid_tpu_torch/ops/codebook.py::nearest_codebook_reference:
//
//     idx[m] = argmax_j ( z[m] . e_j - 0.5 * |e_j|^2 )     (fp32)
//
// which is argmin_j |z[m] - e_j|^2 without the row-constant |z[m]|^2.  On an
// exact tie the lowest j wins, as jnp.argmax and torch.argmax do.
//
// What bounds it on the H100: 2*M*K*D flops in exact fp32 (no tensor
// cores: TF32 would move near-tie winners) against (M + K) * D * 4 bytes
// read once, so it is compute-bound on the fp32 CUDA cores.  This first
// version: one block of 8 warps per 8 rows of z, one warp per row; the
// rows sit in shared memory and the codebook streams through it in tiles
// of 64 codes (rows padded by 4 floats, so the lanes' float4 reads of 8
// different codes hit 32 distinct banks).  Each tile's |e|^2 is summed once
// per block.  Each lane scores 2 codes per tile against its warp's row
// (float4 broadcast of z, float4 reads of e), keeps its best (score, index)
// in registers across tiles, and the warp reduces them at the end.  The
// [M, K] scores never reach device memory.  Register tiling over several
// rows per warp, to read each code once per several rows, is the next step.

#include "common.cuh"

namespace mmvid {
namespace {

constexpr int kRows = 8;             // rows of z per block, one warp each
constexpr int kThreads = kRows * 32;
constexpr int kCodes = 64;           // codes per shared-memory tile
constexpr int kCPL = kCodes / 32;    // codes per lane per tile
constexpr int kPad = 4;              // floats of padding per code row

__global__ void __launch_bounds__(kThreads)
nearest_code_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                    int M, int D, int K, long long* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int cstride = D + kPad;
  float* zs = reinterpret_cast<float*>(smem4);  // [kRows][D]
  float* cs = zs + kRows * D;                   // [kCodes][D + kPad]
  float* e2 = cs + kCodes * cstride;            // [kCodes]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * kRows;
  const int d4n = D / 4;

  // this block's rows of z; rows past M are zeros and never stored
  for (int i = tid; i < kRows * d4n; i += kThreads) {
    const int r = i / d4n, row = m0 + r;
    reinterpret_cast<float4*>(zs)[i] =
        row < M ? reinterpret_cast<const float4*>(
                      z + static_cast<long long>(row) * D)[i % d4n]
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4* zr = reinterpret_cast<const float4*>(zs + warp * D);

  float best = -INFINITY;
  int best_i = 0;
  for (int k0 = 0; k0 < K; k0 += kCodes) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kCodes * d4n; i += kThreads) {
      const int c = i / d4n, d4 = i % d4n, code = k0 + c;
      reinterpret_cast<float4*>(cs + c * cstride)[d4] =
          code < K ? reinterpret_cast<const float4*>(
                         cb + static_cast<long long>(code) * D)[d4]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    for (int c = warp; c < kCodes; c += kRows) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float e = cs[c * cstride + d];
        s = fmaf(e, e, s);
      }
      s = warp_sum(s);
      if (lane == 0) e2[c] = s;
    }
    __syncthreads();

    float acc[kCPL];
#pragma unroll
    for (int j = 0; j < kCPL; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < d4n; ++d4) {
      const float4 zv = zr[d4];
#pragma unroll
      for (int j = 0; j < kCPL; ++j) {
        const float4 ev =
            reinterpret_cast<const float4*>(cs + (lane + 32 * j) * cstride)[d4];
        acc[j] = fmaf(zv.x, ev.x, acc[j]);
        acc[j] = fmaf(zv.y, ev.y, acc[j]);
        acc[j] = fmaf(zv.z, ev.z, acc[j]);
        acc[j] = fmaf(zv.w, ev.w, acc[j]);
      }
    }
    // codes rise along j and across tiles: a strict > keeps the lowest
#pragma unroll
    for (int j = 0; j < kCPL; ++j) {
      const int c = lane + 32 * j, code = k0 + c;
      const float score = acc[j] - 0.5f * e2[c];
      if (code < K && score > best) {
        best = score;
        best_i = code;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float b2 = __shfl_xor_sync(0xffffffffu, best, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (b2 > best || (b2 == best && i2 < best_i)) {
      best = b2;
      best_i = i2;
    }
  }
  if (lane == 0 && m0 + warp < M) out[m0 + warp] = best_i;
}

}  // namespace
}  // namespace mmvid

// z [M, D] fp32, codebook [K, D] fp32, both contiguous and 16-byte
// aligned; D a multiple of 4.  Writes idx [M] int64.  Returns
// cudaGetLastError() after the launch.
extern "C" int mmvid_nearest_code(const void* z, const void* codebook, int M,
                                  int D, int K, void* idx, void* stream) {
  using namespace mmvid;
  if (M <= 0 || D <= 0 || K <= 0 || D % 4 != 0) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kRows) * D +
                       static_cast<size_t>(kCodes) * (D + kPad) + kCodes);
  cudaError_t err = cudaFuncSetAttribute(
      nearest_code_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (M + kRows - 1) / kRows;
  nearest_code_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(codebook), M, D,
      K, static_cast<long long*>(idx));
  return cudaGetLastError();
}
