// The arguments of attention's backward, which the C entry
// (attention_bwd.cu) hands to either route (attention_bwd_sm90.cu, bf16;
// attention_bwd_fp32_sm90.cu, fp32).
#pragma once

#include "common.cuh"

namespace mmvid {
namespace bwd {

// What the launches read and write.  Strides in elements: batch, row,
// head of q, k, v, o (the forward's output), g (the cotangent), dq, dk,
// dv.  bits (fp32): the mask's compact form (one bit a key, set where the
// mask holds c1, else c0; int32 [L, words]), or null for the fp32 mask.
struct Args {
  const void *q, *k, *v, *o, *g;
  const void* o_lo;  // bf16: the rest of the fp32 O, in o's layout
  void *dq, *dk, *dv;
  const float* mask;
  const uint32_t* bits;
  int words;
  float c0, c1;
  const float* lse;  // [B, H, lse_ld], base 2
  float* delta;      // [B, H, lse_ld]: written by the delta launch
  float* part;       // fp32: [key blocks, B, H, L, D], dQ's partials
  long long st[8][3];
  int L, H, lse_ld;
  float scale;
};
enum { kQ, kK, kV, kO, kG, kDQ, kDK, kDV };

}  // namespace bwd
}  // namespace mmvid
