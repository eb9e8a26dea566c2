// The sample head's noise and its running softmax state, shared by its
// three kernels (sample_head.cu on the CUDA cores, sample_head_sm90.cu on
// wgmma in bf16, sample_head_tf32_sm90.cu on wgmma in split TF32) so that
// one seed gives all the same draws.  The plain version of the
// noise is ops/sample_head.py::philox_gumbel.
#pragma once

#include "common.cuh"

namespace mmvid {

// Philox4x32-10 (Salmon et al., Random123): counter (column, row, 0, 0),
// key (seed low, seed high)
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  const uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  const uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

// Gumbel(0, 1) from 32 random bits, as the TPU kernel makes it
// (_gumbel_from_bits): u = (bits >> 8) * 2^-24 + 2^-25,
// g = -log(-log(u + eps) + eps)
__device__ __forceinline__ float gumbel_from_bits(uint32_t bits) {
  const float u = static_cast<float>(bits >> 8) * (1.f / 16777216.f) +
                  (1.f / 33554432.f);
  return -logf(-logf(u + 1e-20f) + 1e-20f);
}

// s * exp(m - m_new), with an empty partial (s == 0, m == -inf) staying 0
__device__ __forceinline__ float rescale(float s, float m, float m_new) {
  return s > 0.f ? s * expf(m - m_new) : 0.f;
}

// A row's running state over its columns: max m and sum of exp(noised -
// m); the best score, its column (the lowest on a tie) and noised value
struct RowState {
  float m, s, best, noised;
  int idx;
};

__device__ __forceinline__ RowState row_state_init(int V) {
  return RowState{-INFINITY, 0.f, -INFINITY, 0.f, V};
}

// Take column c (columns reach a state in rising order)
__device__ __forceinline__ void row_state_add(RowState& st, float noised,
                                              float score, int c) {
  if (noised > st.m) {
    st.s = rescale(st.s, st.m, noised) + 1.f;
    st.m = noised;
  } else {
    st.s += expf(noised - st.m);
  }
  if (score > st.best) {
    st.best = score;
    st.idx = c;
    st.noised = noised;
  }
}

// Merge another column set's state into st
__device__ __forceinline__ void row_state_merge(RowState& st,
                                                const RowState& o) {
  const float mn = fmaxf(st.m, o.m);
  st.s = rescale(st.s, st.m, mn) + rescale(o.s, o.m, mn);
  st.m = mn;
  if (o.best > st.best || (o.best == st.best && o.idx < st.idx)) {
    st.best = o.best;
    st.idx = o.idx;
    st.noised = o.noised;
  }
}

// Merge the states of the lanes xor `mask` apart into each lane's
__device__ __forceinline__ void row_state_shfl_merge(RowState& st,
                                                     int mask) {
  RowState o;
  o.m = __shfl_xor_sync(0xffffffffu, st.m, mask);
  o.s = __shfl_xor_sync(0xffffffffu, st.s, mask);
  o.best = __shfl_xor_sync(0xffffffffu, st.best, mask);
  o.noised = __shfl_xor_sync(0xffffffffu, st.noised, mask);
  o.idx = __shfl_xor_sync(0xffffffffu, st.idx, mask);
  row_state_merge(st, o);
}

// Y = exp(noised[tok] - logsumexp(noised))
__device__ __forceinline__ float row_state_y(const RowState& st) {
  return expf(st.noised - (st.m + logf(st.s)));
}

}  // namespace mmvid
