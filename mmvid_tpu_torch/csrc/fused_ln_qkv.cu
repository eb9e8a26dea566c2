// Fused LayerNorm + packed QKV projection of a backbone block, hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel mmvid_tpu/ops/fused_ln_qkv.py::_kernel (driven by
// fused_ln_qkv) on the bf16 models it is gated for.  Per row m of x [M, D]
// (bf16):
//
//     mu, var = mean(x[m]), mean(x[m]^2) - mu^2        fp32, eps 1e-5
//     h       = ((x[m] - mu) * rsqrt(var + eps)) * ln_w + ln_b   fp32,
//               then rounded to bf16
//     qkv[m]  = h @ W^T + b      W = in_proj_weight [3D, D] (bf16), products
//                                summed in fp32, b added in fp32, then bf16
//
// the function of that kernel and of the plain reference
// mmvid_tpu_torch/ops/fused_ln_qkv.py::ln_qkv_reference.  The output is
// the packed [M, 3D] projection that the attention takes as strided q, k
// and v views, so nothing is padded or split.
//
// What bounds it on the H100: 2*M*D*3D flops on (M*D + 3D*D + M*3D) * 2
// bytes in bf16, far above the card's flop:byte balance, so it is
// compute-bound on the tensor cores.
//
// Design: two launches.  A statistics pass (one warp per row, 16-byte
// loads) writes (mu, rstd) per row, 8 bytes.  Then a tiled product on the
// tensor cores, one block per 128 x 128 output tile, 8 warps of 64 x 32
// each with mma.sync m16n8k16 and fp32 accumulators in registers.  Raw x
// and W tiles 64 deep stream through a 3-stage cp.async ring in shared
// memory (two tiles in flight while one is used; two blocks fit an SM).
// Each x tile is normalised in shared memory once, by the whole block,
// 16 bytes a thread at a time, into bf16 h before the warps read their
// fragments, so the fp32 LN output never reaches device memory
// and every element is normalised once per block, not once per warp.
// Fragments come by ldmatrix; shared rows are padded by 16 bytes, so the
// eight rows of each 8x8 matrix hit distinct banks.  Blocks walk the
// columns fastest, so the blocks in flight share their x rows in L2.
// wgmma with TMA is the next step.  fp32 inputs take the plain version on
// the CPU; the card's wrapper refuses them.

#include "common.cuh"

namespace mmvid {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-5f;

// ---- statistics pass, then tensor cores (mma.sync m16n8k16) ------------

constexpr int kTM = 128;      // output rows per block
constexpr int kTN = 128;      // output columns per block
constexpr int kTK = 64;       // depth per pipeline stage
constexpr int kStages = 3;
constexpr int kLd = kTK + 8;  // bf16 per shared row (16 bytes of padding)
// 16-byte chunks of one x or W stage tile that each thread copies
constexpr int kCopies = kTM * kTK / 8 / kThreads;

__global__ void __launch_bounds__(kThreads)
ln_stats_kernel(const __nv_bfloat16* __restrict__ x, int M, int D,
                float2* __restrict__ stats) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  // 16-byte loads: 8 bf16 at a time (D is a multiple of 8)
  const uint4* xr =
      reinterpret_cast<const uint4*>(x + static_cast<long long>(row) * D);
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < D / 8; c += 32) {
    const uint4 raw = xr[c];
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float v = __bfloat162float(
          __ushort_as_bfloat16((words[q / 2] >> (16 * (q % 2))) & 0xffffu));
      s += v;
      s2 = fmaf(v, v, s2);
    }
  }
  const float mu = warp_sum(s) / D;
  const float var = warp_sum(s2) / D - mu * mu;
  if (lane == 0) stats[row] = make_float2(mu, rsqrtf(var + kEps));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8x8 bf16 matrices from shared memory, in mma fragment layout
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__global__ void __launch_bounds__(kThreads)
ln_qkv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                   const float2* __restrict__ stats,
                   const float* __restrict__ ln_w,
                   const float* __restrict__ ln_b,
                   const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ bias, int M, int D,
                   int N, __nv_bfloat16* __restrict__ out) {
  static_assert(kTM == kTN && kTM * kTK / 8 == kCopies * kThreads,
                "x and W stage tiles split evenly over the threads");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* ws = xs + kStages * kTM * kLd;
  float2* st = reinterpret_cast<float2*>(ws + kStages * kTN * kLd);
  const int n0 = blockIdx.x * kTN, m0 = blockIdx.y * kTM;
  const int tid = threadIdx.x;

  // copy the x and W tiles of depth step kt into stage kt % kStages; rows
  // of x past M are zero-filled (and never stored)
  auto load_stage = [&](int kt) {
    const int k0 = kt * kTK, stage = kt % kStages;
#pragma unroll
    for (int c = 0; c < kCopies; ++c) {
      const int i = tid + c * kThreads;
      const int r = i / (kTK / 8), c8 = (i % (kTK / 8)) * 8;
      const int row = m0 + r;
      cp_async16(xs + (stage * kTM + r) * kLd + c8,
                 x + static_cast<long long>(row < M ? row : M - 1) * D + k0 +
                     c8,
                 row < M ? 16 : 0);
      cp_async16(ws + (stage * kTN + r) * kLd + c8,
                 w + static_cast<long long>(n0 + r) * D + k0 + c8, 16);
    }
  };

  const int k_steps = D / kTK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_steps) load_stage(s);
    cp_async_commit();
  }
  for (int r = tid; r < kTM; r += kThreads)
    st[r] = m0 + r < M ? stats[m0 + r] : make_float2(0.f, 0.f);

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int wm = warp / 4;                // rows wm*64 .. +64
  const int wn = warp % 4;                // columns wn*32 .. +32
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  for (int kt = 0; kt < k_steps; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step kt landed
    __syncthreads();  // everyone's have; step kt - 1's readers are done
    if (kt + kStages - 1 < k_steps) load_stage(kt + kStages - 1);
    cp_async_commit();

    // normalise the x tile in place: h = ((x - mu) * rstd) * w + b in
    // fp32, rounded to bf16, with the plain reference's rounding steps;
    // 8 elements (16 bytes) at a time, one column chunk per thread
    const int k0 = kt * kTK, stage = kt % kStages;
    __nv_bfloat16* xt = xs + stage * kTM * kLd;
    {
      const int k8 = (tid % (kTK / 8)) * 8;
      const float4 w0 = *reinterpret_cast<const float4*>(ln_w + k0 + k8);
      const float4 w1 = *reinterpret_cast<const float4*>(ln_w + k0 + k8 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(ln_b + k0 + k8);
      const float4 b1 = *reinterpret_cast<const float4*>(ln_b + k0 + k8 + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int c = 0; c < kCopies; ++c) {
        const int r = (tid + c * kThreads) / (kTK / 8);
        const float2 ms = st[r];
        uint4* p = reinterpret_cast<uint4*>(xt + r * kLd + k8);
        const uint4 raw = *p;
        uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int q = 0; q < 8; ++q) {  // bf16 q sits in half q % 2 of word
          const int sh = 16 * (q % 2);
          const float v = __bfloat162float(
              __ushort_as_bfloat16((words[q / 2] >> sh) & 0xffffu));
          const float hv = __fmul_rn(v - ms.x, ms.y);
          const uint32_t h = __bfloat16_as_ushort(
              __float2bfloat16(__fadd_rn(__fmul_rn(hv, wv[q]), bv[q])));
          words[q / 2] = (words[q / 2] & ~(0xffffu << sh)) | (h << sh);
        }
        *p = make_uint4(words[0], words[1], words[2], words[3]);
      }
    }
    __syncthreads();

    // fragments by ldmatrix: lane l addresses row (l % 8) + 8 * ((l / 8)
    // % 2) of the 16-row A slice at column 8 * (l / 16); for B (stored
    // [n][k]) row (l % 8) + 8 * (l / 16) of a 16-column pair at depth
    // 8 * ((l / 8) % 2)
    const __nv_bfloat16* wt = ws + stage * kTN * kLd;
    const int a_row = (lane % 8) + 8 * ((lane / 8) % 2);
    const int a_col = 8 * (lane / 16);
    const int b_row = (lane % 8) + 8 * (lane / 16);
    const int b_col = 8 * ((lane / 8) % 2);
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi], xt + (wm * 64 + mi * 16 + a_row) * kLd + kk + a_col);
#pragma unroll
      for (int nj = 0; nj < 4; nj += 2) {
        uint32_t r[4];
        ldsm_x4(r, wt + (wn * 32 + nj * 8 + b_row) * kLd + kk + b_col);
        b[nj][0] = r[0];
        b[nj][1] = r[1];
        b[nj + 1][0] = r[2];
        b[nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_16816(acc[mi][nj], a[mi], b[nj]);
    }
  }

#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    const int col = n0 + wn * 32 + nj * 8 + 2 * t;
    const float b0 = __bfloat162float(bias[col]);
    const float b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + g + 8 * half;
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<long long>(row) * N + col) =
              __floats2bfloat162_rn(acc[mi][nj][2 * half] + b0,
                                    acc[mi][nj][2 * half + 1] + b1);
      }
  }
}

}  // namespace
}  // namespace mmvid

// x [M, D], w [3D, D] and bias [3D] in bf16, ln_w / ln_b [D] fp32, all
// contiguous and 16-byte aligned; D a multiple of 128.  stats: scratch of M
// float2.  Writes qkv [M, 3D] in bf16.  Returns cudaGetLastError() after
// the launches.
extern "C" int mmvid_ln_qkv(const void* x, const void* ln_w, const void* ln_b,
                            const void* w, const void* bias, int M, int D,
                            void* stats, void* out, void* stream) {
  using namespace mmvid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D <= 0 || D % 128 != 0 || M > 65535 * kTM)
    return cudaErrorInvalidValue;
  const int N = 3 * D;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  float2* st = static_cast<float2*>(stats);
  ln_stats_kernel<<<(M + kWarps - 1) / kWarps, kThreads, 0, s>>>(xb, M, D, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(__nv_bfloat16) * kStages * (kTM + kTN) * kLd +
                      sizeof(float2) * kTM;
  err = cudaFuncSetAttribute(ln_qkv_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kTN, (M + kTM - 1) / kTM);
  ln_qkv_bf16_kernel<<<grid, kThreads, smem, s>>>(
      xb, st, static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), M, D, N,
      static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}
