// Full-sequence self-attention for the MMVID backbone: the C entry point
// of both routes of the forward (mmvid_attention_fwd); the backward's is
// csrc/attention_bwd.cu.
//
// Replaces the TPU kernel mmvid_tpu/ops/attention.py::_make_packed_kernel
// (driven by fused_attention_blhd / _pallas_attention).  Both routes
// compute the same function as that kernel and as the plain reference
// mmvid_tpu_torch/ops/attention.py::attention_reference:
//
//     out[b, i, h, :] = softmax_j(scale * q[b,i,h,:] . k[b,j,h,:] + mask[i,j])
//                       @ v[b, :, h, :]
//
// with fp32 logits, softmax and accumulation, inputs and output in the
// residual stream's [B, L, H*D] layout (strided: q, k and v may be views of
// one fused QKV projection).  Not the TPU's head packing or 16-row padding:
// the ragged L edge is masked, never padded.
//
// bf16 inputs (the full-width serving builds) go to the tensor-core kernel
// of csrc/attention_sm90.cu; fp32 inputs (every released recipe, which
// runs its model in fp32, the CLIP scorer, and the tiny models) to the
// CUDA-core kernel of csrc/attention_fp32_sm90.cu.  kBf16Probs
// (MMVID_ATTN_BF16=1) rounds the probabilities to bf16 before the product
// with V, as JAX's bf16_av variant does; the row sums stay fp32.  Online
// softmax sums in a different order than the whole-row softmax of the TPU
// kernel; the tests state the tolerance.
//
// With grad on, the forward also writes the row statistics that the
// backward (csrc/attention_bwd.cu) reads.

#include "common.cuh"

namespace mmvid {

// the bf16 route, csrc/attention_sm90.cu
cudaError_t attention_wgmma(int head_dim, bool bf16_probs, const void* q,
                            const void* k, const void* v, const float* mask,
                            void* out, float* lse, void* out_lo, int lse_ld,
                            int B, int L, int H, const long long* strides,
                            float scale, cudaStream_t stream);
// the fp32 route, csrc/attention_fp32_sm90.cu
cudaError_t attention_fp32(int head_dim, bool bf16_probs, const void* q,
                           const void* k, const void* v, const float* mask,
                           void* out, float* lse, int lse_ld, int B, int L,
                           int H, const long long* strides, float scale,
                           cudaStream_t stream);
}  // namespace mmvid

// q, k, v, out: [B, L, H, D] with unit stride over D and element strides
// (batch, position, head) given per tensor in `strides` (12 values, in the
// order q, k, v, out); mask: contiguous fp32 [L, L] with a 16-byte aligned
// base.  dtype: 0 fp32 (the CUDA-core kernel: 16-byte aligned q, k, v, out
// and row, head and batch strides that are multiples of 4), 1 bf16 (the
// tensor-core kernel: the same bases and strides that are multiples of 8).
// head_dim: 32 or 64.  bf16_probs: 1 rounds the probabilities to bf16 for
// the product with V (MMVID_ATTN_BF16=1).  With grad on, the backward's
// statistics: lse, null or fp32 [B, H, lse_ld] (lse_ld >= L), takes each
// row's log-sum-exp in base 2; out_lo, null or (bf16 only) a tensor in
// out's layout, the rest of the fp32 output, bf16(O - bf16(O)).  Returns
// cudaGetLastError() after launch.
extern "C" int mmvid_attention_fwd(int dtype, int head_dim, int bf16_probs,
                                   const void* q, const void* k,
                                   const void* v, const void* mask, void* out,
                                   void* lse, void* out_lo, int lse_ld, int B,
                                   int L, int H, const long long* strides,
                                   float scale, void* stream) {
  using namespace mmvid;
  const float* m = static_cast<const float*>(mask);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || B > 65535 || H > 65535 ||
      (ls != nullptr && lse_ld < L))
    return cudaErrorInvalidValue;
  if (dtype == kBFloat16)
    return attention_wgmma(head_dim, bf16_probs != 0, q, k, v, m, out, ls,
                           out_lo, lse_ld, B, L, H, strides, scale, s);
  if (dtype != kFloat32 || out_lo != nullptr) return cudaErrorInvalidValue;
  return attention_fp32(head_dim, bf16_probs != 0, q, k, v, m, out, ls,
                        lse_ld, B, L, H, strides, scale, s);
}
