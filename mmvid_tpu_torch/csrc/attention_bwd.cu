// Attention's backward, the custom_vjp's of the TPU kernel
// (mmvid_tpu/ops/attention.py::_fused_attention_bwd, XLA's VJP of
// _attention_xla): the C entry point of its two routes, bf16 on wgmma in
// csrc/attention_bwd_sm90.cu and fp32 on wgmma in split TF32 in
// csrc/attention_bwd_fp32_sm90.cu.  Both read the row statistics that the
// forward (csrc/attention.cu) writes when grad is on: each row's
// log-sum-exp, and for bf16 the rest of the fp32 output.

#include "attention_bwd.cuh"

namespace mmvid {

cudaError_t attention_bwd_wgmma(int head_dim, const bwd::Args& a, int B,
                                cudaStream_t stream);
cudaError_t attention_bwd_fp32(int head_dim, const bwd::Args& a, int B,
                               cudaStream_t stream);

}  // namespace mmvid

// Attention's backward (ops/attention.py::FusedAttention.backward): bf16
// in two launches (the query pass: delta, dq; the key pass: dk, dv), fp32
// in three (delta; the key pass: dk, dv and dq's partials a block of 128
// keys; dq, the partials' ordered sum).
// ptrs: q, k, v, out (the forward's output), g (the cotangent), dq, dk,
// dv, each [B, L, H, D] with unit stride over D and element strides
// (batch, position, head) in `strides` (24 values, in that order), then
// (bf16) the forward's out_lo in out's layout (null for fp32); the
// dtype's alignment as for mmvid_attention_fwd; mask as there; bits: null,
// or (fp32) the mask's compact form, which the key pass then reads, int32 [L, words] with words = 4 *
// ceil(L / 128), bit j % 32 of word j / 32 of row i set where mask[i, j]
// is c1 (else it is c0), 16-byte aligned; lse: the forward's [B, H,
// lse_ld] statistics; delta: fp32 [B, H, lse_ld] scratch (written, then
// read); lse_ld a multiple of 64 and >= L; scratch: fp32, ceil(L / 128) *
// B * H * L * D floats for fp32 (dq's partials, one [B, H, L, D] a block
// of 128 keys), null for bf16.  Returns cudaGetLastError() after the launches.
extern "C" int mmvid_attention_bwd(int dtype, int head_dim,
                                   const void* const* ptrs, const void* mask,
                                   const void* bits, int words, float c0,
                                   float c1, const void* lse, void* delta,
                                   void* scratch, int B, int L, int H,
                                   int lse_ld, const long long* strides,
                                   float scale, void* stream) {
  using namespace mmvid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || B > 65535 || H > 65535 || lse_ld < L ||
      lse_ld % 64 != 0 || (dtype == kFloat32) != (scratch != nullptr) ||
      (bits != nullptr &&
       (dtype != kFloat32 || words != 4 * ((L + 127) / 128))))
    return cudaErrorInvalidValue;
  bwd::Args a;
  a.q = ptrs[0];
  a.k = ptrs[1];
  a.v = ptrs[2];
  a.o = ptrs[3];
  a.g = ptrs[4];
  a.dq = const_cast<void*>(ptrs[5]);
  a.dk = const_cast<void*>(ptrs[6]);
  a.dv = const_cast<void*>(ptrs[7]);
  a.o_lo = ptrs[8];
  a.mask = static_cast<const float*>(mask);
  a.bits = static_cast<const uint32_t*>(bits);
  a.words = words;
  a.c0 = c0;
  a.c1 = c1;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.part = static_cast<float*>(scratch);
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  a.L = L;
  a.H = H;
  a.lse_ld = lse_ld;
  a.scale = scale;
  if (dtype == kBFloat16) {
    if (a.o_lo == nullptr) return cudaErrorInvalidValue;
    return attention_bwd_wgmma(head_dim, a, B, s);
  }
  if (dtype != kFloat32 || a.o_lo != nullptr) return cudaErrorInvalidValue;
  return attention_bwd_fp32(head_dim, a, B, s);
}
