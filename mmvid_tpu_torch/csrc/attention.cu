// Full-sequence self-attention for the MMVID backbone: the C entry point
// of both routes, and the fp32 route's kernel on the CUDA cores.
//
// Replaces the TPU kernel mmvid_tpu/ops/attention.py::_make_packed_kernel
// (driven by fused_attention_blhd / _pallas_attention).  It computes the
// same function as that kernel and as the plain reference
// mmvid_tpu_torch/ops/attention.py::attention_reference:
//
//     out[b, i, h, :] = softmax_j(scale * q[b,i,h,:] . k[b,j,h,:] + mask[i,j])
//                       @ v[b, :, h, :]
//
// with fp32 logits, softmax and accumulation, inputs and output in the
// residual stream's [B, L, H*D] layout (strided: q, k and v may be views of
// one fused QKV projection).  Not the TPU's head packing or 16-row padding:
// the ragged L edge is masked here, never padded.
//
// bf16 inputs (every full-width model) go to the tensor-core kernel of
// csrc/attention_sm90.cu.  fp32 inputs (only the tiny models on the card
// and the card-vs-CPU checks run fp32) take the kernel below, the first
// port of the TPU kernel, kept as it was: the products as fp32 FMAs on the
// CUDA cores, one block per (64-row query tile, head, batch); K and V
// tiles of 32 keys staged through shared memory; q scaled in fp32 on load;
// an online softmax (running max, sum and accumulator per row in fp32) so
// the [L, L] logits never reach device memory.  kBf16Probs
// (MMVID_ATTN_BF16=1) rounds the probabilities to bf16 before the product
// with V, as JAX's bf16_av variant does; the row sums stay fp32.  Online
// softmax sums in a different order than the whole-row softmax of the TPU
// kernel; the tests state the tolerance.

#include "common.cuh"

namespace mmvid {
namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 32;   // keys per shared-memory tile
constexpr int kTPR = 4;   // threads per query row
constexpr int kThreads = kBQ * kTPR;

template <int D, bool kBf16Probs>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel_fp32(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ mask,
                          float* __restrict__ out, int L, long long sqb,
                          long long sql, long long sqh, long long skb,
                          long long skl, long long skh, long long svb,
                          long long svl, long long svh, long long sob,
                          long long sol, long long soh, float scale) {
  static_assert(D % kTPR == 0, "head dim must split over kTPR threads");
  constexpr int kCPT = kBK / kTPR;  // score columns per thread
  constexpr int kDPT = D / kTPR;    // output dims per thread
  // +1 padding keeps the row-strided reads free of bank conflicts
  __shared__ float qs[kBQ][D + 1];
  __shared__ float ks[kBK][D + 1];
  __shared__ float vs[kBK][D];
  __shared__ float ps[kBQ][kBK + 1];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  float* ob = out + b * sob + h * soh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, row = q0 + r;
    qs[r][d] = row < L ? qb[row * sql + d] * scale : 0.f;
  }

  const int r = tid / kTPR;    // this thread's query row in the tile
  const int sub = tid % kTPR;  // its slot among the row's kTPR threads
  const int row = q0 + r;
  // rows past L compute on a valid mask row and are never stored
  const float* mrow = mask + static_cast<long long>(row < L ? row : L - 1) * L;

  float acc[kDPT];
#pragma unroll
  for (int i = 0; i < kDPT; ++i) acc[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (int k0 = 0; k0 < L; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D, key = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (key < L) {
        kv = kb[key * skl + d];
        vv = vb[key * svl + d];
      }
      ks[c][d] = kv;
      vs[c][d] = vv;
    }
    __syncthreads();

    float s[kCPT];
#pragma unroll
    for (int j = 0; j < kCPT; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r][d];
#pragma unroll
      for (int j = 0; j < kCPT; ++j) s[j] += qv * ks[sub + kTPR * j][d];
    }
    // key k0 < L is always valid, so the tile max is finite
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCPT; ++j) {
      const int key = k0 + sub + kTPR * j;
      s[j] = key < L ? s[j] + mrow[key] : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    // the kTPR threads of a row are adjacent lanes of one warp
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);  // 0 on the first tile
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kCPT; ++j) {
      const float p = expf(s[j] - m_new);
      ps[r][sub + kTPR * j] =
          kBf16Probs ? __bfloat162float(__float2bfloat16(p)) : p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    __syncwarp();  // the row's probabilities are visible to its lanes

#pragma unroll
    for (int i = 0; i < kDPT; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float p = ps[r][c];
#pragma unroll
      for (int i = 0; i < kDPT; ++i) acc[i] += p * vs[c][sub + kTPR * i];
    }
  }

  if (row < L) {
    const float inv = 1.f / l_run;
#pragma unroll
    for (int i = 0; i < kDPT; ++i)
      ob[row * sol + sub + kTPR * i] = acc[i] * inv;
  }
}

template <int D, bool kBf16Probs>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        const float* mask, void* out, int B, int L, int H,
                        const long long* st, float scale,
                        cudaStream_t stream) {
  const dim3 grid((L + kBQ - 1) / kBQ, H, B);
  attention_fwd_kernel_fp32<D, kBf16Probs><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(out), L, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale);
  return cudaGetLastError();
}

}  // namespace

// the bf16 route, csrc/attention_sm90.cu
cudaError_t attention_wgmma(int head_dim, bool bf16_probs, const void* q,
                            const void* k, const void* v, const float* mask,
                            void* out, int B, int L, int H,
                            const long long* strides, float scale,
                            cudaStream_t stream);

}  // namespace mmvid

// q, k, v, out: [B, L, H, D] with unit stride over D and element strides
// (batch, position, head) given per tensor in `strides` (12 values, in the
// order q, k, v, out); mask: contiguous fp32 [L, L].  dtype: 0 fp32 (the
// CUDA-core kernel), 1 bf16 (the tensor-core kernel: 16-byte aligned q, k,
// v, out and row, head and batch strides that are multiples of 8).
// head_dim: 32 or 64.  bf16_probs: 1 rounds the probabilities to bf16 for
// the product with V (MMVID_ATTN_BF16=1).  Returns cudaGetLastError()
// after launch.
extern "C" int mmvid_attention_fwd(int dtype, int head_dim, int bf16_probs,
                                   const void* q, const void* k,
                                   const void* v, const void* mask, void* out,
                                   int B, int L, int H,
                                   const long long* strides, float scale,
                                   void* stream) {
  using namespace mmvid;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  if (dtype == kBFloat16)
    return attention_wgmma(head_dim, bf16_probs != 0, q, k, v, m, out, B, L,
                           H, strides, scale, s);
  if (dtype != kFloat32) return cudaErrorInvalidValue;
  if (head_dim == 64)
    return bf16_probs
               ? launch_fp32<64, true>(q, k, v, m, out, B, L, H, strides,
                                       scale, s)
               : launch_fp32<64, false>(q, k, v, m, out, B, L, H, strides,
                                        scale, s);
  if (head_dim == 32)
    return bf16_probs
               ? launch_fp32<32, true>(q, k, v, m, out, B, L, H, strides,
                                       scale, s)
               : launch_fp32<32, false>(q, k, v, m, out, B, L, H, strides,
                                        scale, s);
  return cudaErrorInvalidValue;
}
