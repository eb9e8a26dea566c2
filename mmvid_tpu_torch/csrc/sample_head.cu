// Fused sample head of the mask-predict sampler, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mmvid_tpu/ops/sample_head.py::fused_sample_head
// (kernel body _make_kernel).  Per row m of x [M, D]:
//
//     h      = LayerNorm(x[m]) (fp32 statistics, eps 1e-5), rounded to W's
//              dtype
//     logits = h @ W + b              W [D, V], fp32 accumulation
//     noised = logits + temp * G1     G1, G2 ~ Gumbel(0, 1), iid
//     tok    = argmax(noised + G2)    (a draw from softmax(noised))
//     Y      = exp(noised[tok] - logsumexp(noised))
//
// Only tok [M] (int64) and Y [M] (fp32) are written: the [M, V] logits and
// noise live in shared memory and registers.  The noise is drawn in the
// kernel from a counter-based Philox4x32-10 keyed by (seed, row, column),
// so a launch is reproducible from its seed.  The seed is read from device
// memory, so drawing it from a CUDA torch.Generator needs no host sync.
// The uniform is made as the TPU kernel makes it (_gumbel_from_bits):
// u = (bits >> 8) * 2^-24 + 2^-25, g = -log(-log(u + eps) + eps).
//
// What bounds it on the H100: 2*D*V flops per row against D*4 bytes of x,
// with W (1.5 MB in bf16) read once per block from L2, so it is
// compute-bound.  This first version runs the product on the CUDA cores in
// fp32: one block of 256 threads per 16 rows; the normalised rows sit in
// shared memory and are read as float4 broadcasts, each thread accumulates
// 4 vocab columns x 16 rows in registers from coalesced W loads; the 16 x V
// logits tile goes to shared memory, then one warp per row draws the noise
// and reduces max / sum-of-exp / argmax in one pass.  It is the route
// for the shapes the tensor-core kernels (sample_head_sm90.cu for bf16 W,
// sample_head_tf32_sm90.cu for fp32 W) do not take; the noise and the
// running state are sample_head.cuh's, shared by all three.

#include "sample_head.cuh"

namespace mmvid {
namespace {

constexpr int kBM = 16;       // rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCPT = 4;       // vocab columns per thread per pass

template <typename TW>
__global__ void __launch_bounds__(kThreads)
sample_head_kernel(const float* __restrict__ x, const float* __restrict__ ln_w,
                   const float* __restrict__ ln_b, const TW* __restrict__ w,
                   const float* __restrict__ bias, float temp,
                   const unsigned long long* __restrict__ seed_ptr, int M,
                   int D, int V, float* __restrict__ y_out,
                   long long* __restrict__ tok_out) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [kBM][D]
  float* ls = hs + kBM * D;                     // [kBM][V]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * kBM;

  // 1. LayerNorm, one warp per row; rows past M are zeros
  for (int r = warp; r < kBM; r += kWarps) {
    const int row = m0 + r;
    float* hr = hs + r * D;
    if (row >= M) {
      for (int d = lane; d < D; d += 32) hr[d] = 0.f;
      continue;
    }
    const float* xr = x + static_cast<long long>(row) * D;
    float sum = 0.f;
    for (int d = lane; d < D; d += 32) sum += xr[d];
    const float mu = warp_sum(sum) / D;
    float sq = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float t = xr[d] - mu;
      sq += t * t;
    }
    const float rstd = rsqrtf(warp_sum(sq) / D + 1e-5f);
    for (int d = lane; d < D; d += 32) {
      const float hv = (xr[d] - mu) * rstd * ln_w[d] + ln_b[d];
      hr[d] = to_float(from_float<TW>(hv));
    }
  }
  __syncthreads();

  // 2. logits tile [kBM, V] = h @ W + b, fp32 accumulation
  for (int v0 = 0; v0 < V; v0 += kThreads * kCPT) {
    int col[kCPT];
    bool ok[kCPT];
    float acc[kCPT][kBM];
#pragma unroll
    for (int j = 0; j < kCPT; ++j) {
      col[j] = v0 + tid + kThreads * j;
      ok[j] = col[j] < V;
#pragma unroll
      for (int r = 0; r < kBM; ++r) acc[j][r] = 0.f;
    }
    for (int d = 0; d < D; d += 4) {
      float wv[kCPT][4];
#pragma unroll
      for (int j = 0; j < kCPT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wv[j][e] = ok[j] ? to_float(w[static_cast<long long>(d + e) * V +
                                        col[j]])
                           : 0.f;
#pragma unroll
      for (int r = 0; r < kBM; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + r * D + d);
#pragma unroll
        for (int j = 0; j < kCPT; ++j) {
          acc[j][r] = fmaf(hv.x, wv[j][0], acc[j][r]);
          acc[j][r] = fmaf(hv.y, wv[j][1], acc[j][r]);
          acc[j][r] = fmaf(hv.z, wv[j][2], acc[j][r]);
          acc[j][r] = fmaf(hv.w, wv[j][3], acc[j][r]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kCPT; ++j) {
      if (!ok[j]) continue;
      const float bj = bias[col[j]];
#pragma unroll
      for (int r = 0; r < kBM; ++r) ls[r * V + col[j]] = acc[j][r] + bj;
    }
  }
  __syncthreads();

  // 3. Gumbel noise + one-pass logsumexp / argmax, one warp per row
  const unsigned long long seed = *seed_ptr;
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  for (int r = warp; r < kBM; r += kWarps) {
    const int row = m0 + r;
    if (row >= M) continue;
    RowState st = row_state_init(V);
    for (int c = lane; c < V; c += 32) {
      const uint4 bits = philox4x32_10(
          make_uint4(static_cast<uint32_t>(c), static_cast<uint32_t>(row),
                     0u, 0u),
          key);
      const float noised = ls[r * V + c] + temp * gumbel_from_bits(bits.x);
      // columns rise along the loop: the first index wins a tie
      row_state_add(st, noised, noised + gumbel_from_bits(bits.y), c);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) row_state_shfl_merge(st, off);
    if (lane == 0) {
      y_out[row] = row_state_y(st);
      tok_out[row] = st.idx;
    }
  }
}

template <typename TW>
cudaError_t launch(const void* x, const void* ln_w, const void* ln_b,
                   const void* w, const void* bias, float temp,
                   const void* seed, int M, int D, int V, void* y, void* tok,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(kBM) * (D + V);
  cudaError_t err = cudaFuncSetAttribute(
      sample_head_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (M + kBM - 1) / kBM;
  sample_head_kernel<TW><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const TW*>(w),
      static_cast<const float*>(bias), temp,
      static_cast<const unsigned long long*>(seed), M, D, V,
      static_cast<float*>(y), static_cast<long long*>(tok));
  return cudaGetLastError();
}

}  // namespace
}  // namespace mmvid

// x [M, D] fp32, ln_w / ln_b [D] fp32, w [D, V] (w_dtype: 0 fp32, 1 bf16),
// bias [V] fp32, seed: one uint64 in device memory; all contiguous.
// Writes y [M] fp32 and tok [M] int64.  D must be a multiple of 4 and
// kBM * (D + V) floats must fit one block's shared memory.
extern "C" int mmvid_sample_head(int w_dtype, const void* x, const void* ln_w,
                                 const void* ln_b, const void* w,
                                 const void* bias, float temp,
                                 const void* seed, int M, int D, int V,
                                 void* y, void* tok, void* stream) {
  using namespace mmvid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D <= 0 || V <= 0 || D % 4 != 0)
    return cudaErrorInvalidValue;
  if (w_dtype == kFloat32)
    return launch<float>(x, ln_w, ln_b, w, bias, temp, seed, M, D, V, y, tok,
                         s);
  if (w_dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, ln_w, ln_b, w, bias, temp, seed, M, D, V,
                                 y, tok, s);
  return cudaErrorInvalidValue;
}
