#!/usr/bin/env python3
"""Where the int8 attention, fused LN+QKV, nearest-code, fp32 attention,
fp32-W sample-head and attention-backward kernels spend their time: the
first kernels (``csrc/attention_int8.cu`` and ``csrc/fused_ln_qkv.cu`` of
commit 3f73783) and the port's current ones (``csrc/attention_int8_sm90.cu``
and ``csrc/fused_ln_qkv_sm90.cu``), each built as it is and as variants
with one part of its work cut out, timed in turns on the card.  The
variants compute wrong outputs on purpose; only their times are read.
Likewise the first nearest-code kernel (``csrc/codebook.cu`` of commit
8e5084f) against the current one (``csrc/codebook_sm90.cu``).

int8 attention, on the main paths' inputs (B16 H12 D64 bf16 on the packed
QKV views, ``mask_prev`` rows, L 565 and 629):

* old ``no_scan``: the per-block scan of the head's q, k and v for the
  three abs-maxima left out (fixed scales);
* old ``no_kv_quant``: the head's K and V not read or quantized into
  shared memory (the products run on whatever shared memory holds);
* old ``const_mask``: the fp32 mask reads of both S passes replaced by 0;
* old ``one_pass``: the first S pass (the exact row max) left out;
* old ``prologue_only``: scan and quantization, then return;
* old ``products_only``: no scan, no K/V quantization, constant mask, one
  S pass: the products, the softmax and the output alone;
* new ``operands_only``: the operand pass, then an attention launch that
  returns at once; new ``no_operands``: the attention alone (on a stale
  workspace);
* new ``no_pass1``: the row-max pass left out; new ``no_exp``: pass 2
  without its ``expf``;
* the route itself through ``ops/attention_int8.py``, with the mask's
  compact form and with the fp32 mask alone.

Fused LN+QKV (bf16, D 768, W [2304, 768]) at M 16 x 629 and 16 x 565: the
old kernel, the route (``ops/fused_ln_qkv.py``), the gate-off pair
``F.layer_norm`` + ``F.linear``, and the current kernel without its
normalisation (``no_norm``), its products (``no_mma``), its output stores
(``no_store``) or its statistics pass (``no_stats``).

Nearest code (fp32, D 256, K 1024) at M 1024, 4096 and 8192 (the
text+mask control frames at batch 16, the image_and_video recipe's 4
control frames, one video's 8 frames): the old kernel, the route
(``ops/codebook.py``), the plain version, and the current kernel as it
is (``as_is``), without its products (``no_fma``) and without its
cross-tile merge (``no_merge``).

Attention's fp32 route (B16 D64 fp32 on the packed QKV views: H12
``mask_prev`` at L 565 and 629, the CLIP scorer's L 50 H12 without a mask
and L 77 H8 causal): the first fp32 kernel (``csrc/attention.cu`` of
commit f37e588), the route (``ops/attention.py``), the plain version,
``F.scaled_dot_product_attention`` in fp32 on the same float mask, the
current kernel (``csrc/attention_fp32_sm90.cu``) at each of its query
tiles (``rows_8``, ``rows_6``, ``rows_4``: rows a thread of 16 row
groups), and at the route's tile as it is (``as_is``) and with one part
cut out: the mask's loads (``no_mask_load``: zeros instead), K's and V's
staging (``no_kv_stage``: the products read stale shared memory), the
exps (``no_exp``), the products Q.K^T (``no_qk``) or P.V (``no_pv``), or
all but the products (``products_only``: no mask loads, no row-max
shuffles, no exps); and with a third stage in its K/V ring
(``three_stages``).

The sample head with fp32 W (``--sample-head``; M 8192 D 768 V 1024, a
genuinely fp32 W): the CUDA-core kernel (``csrc/sample_head.cu``, now
the route of the other shapes), the split-TF32 route
(``ops/sample_head.py``),
``F.layer_norm`` + ``F.linear`` in fp32 with TF32 off (the product
alone), and the split-TF32 kernels (``csrc/sample_head_tf32_sm90.cu``) as
they are and with one part cut out (``NEW_HEAD_TF32``); each build that
computes the function also reads its agreement with the plain version
fed ``philox_gumbel`` (temp 1 and temp 0).

Attention's backward (``--attention-bwd-source DIR``; DIR holds PR 20's
``attention_bwd_sm90.cu`` and ``attention_bwd_fp32_sm90.cu``, the first
hand-written kernels: a query pass and a key pass in bf16, FFMA on the
CUDA cores in fp32): those kernels against the route
(``ops/attention.py::attention_backward_kernel`` given the mask's
compact form as the models give it, and fp32 also with the fp32 mask
alone) and ``F.scaled_dot_product_attention``'s forward and backward in
the same dtype, in turns, on the packed QKV views with ``mask_prev``
rows: B16 H12 D64 at L 565 and 629 in both dtypes, B48 L565 in bf16;
each old and new result's largest gap to the plain version, relative to
1 + |plain|.  ``--attention-bwd-variants``: the current backward kernels
as they are and with one part cut out (NEW_BWD_BF16, NEW_BWD_FP32) at
B16 L565.

Usage (needs nvcc and a CUDA card; the old sources from git history, e.g.
``git show 3f73783:mmvid_tpu_torch/csrc/attention_int8.cu > OLD8.cu``,
``git show 8e5084f:mmvid_tpu_torch/csrc/codebook.cu > OLDCB.cu``,
``git show f37e588:mmvid_tpu_torch/csrc/attention.cu > OLDATT.cu``; each
source is optional and names the families timed):

    python -m mmvid_tpu_torch.attribution --int8-source OLD8.cu \\
        --lnqkv-source OLDLN.cu --codebook-source OLDCB.cu \\
        --attention-fp32-source OLDATT.cu [--sample-head] \\
        [--attention-bwd-source OLDBWD/] [--attention-bwd-variants] \\
        [--out FILE]

(``mkdir OLDBWD; git show 0264c5c:mmvid_tpu_torch/csrc/attention_bwd_sm90.cu
> OLDBWD/attention_bwd_sm90.cu``, likewise ``attention_bwd_fp32_sm90.cu``.)

Prints the card, one line per (shape, variant) and one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from mmvid_tpu_torch.ops import _build

# (pattern, replacement) lists; each pattern must match
OLD_INT8 = {
    'as_is': [],
    'no_scan': [
        (r'float mq = 0\.f, mk = 0\.f, mv = 0\.f;\n  for \(int i = tid; '
         r'i < L \* kChunks;',
         'float mq = 4.f, mk = 4.f, mv = 4.f;\n  for (int i = tid; i < 0;')],
    'no_kv_quant': [
        (r'for \(int i = tid; i < Lp \* kChunks;',
         'for (int i = tid; i < 0;')],
    'const_mask': [(r'm[AB]\[key\]', '0.f')],
    'one_pass': [
        (r'float mxA = -INFINITY, mxB = -INFINITY;\n  for \(int n0 = 0; '
         r'n0 < Lp;',
         'float mxA = 0.f, mxB = 0.f;\n  for (int n0 = 0; n0 < 0;')],
    'prologue_only': [
        (r'  // 3\. each warp: 16 query rows against every key',
         '  if (L > 0) return;')],
}
OLD_INT8['products_only'] = (OLD_INT8['no_scan'] + OLD_INT8['no_kv_quant']
                             + OLD_INT8['const_mask'] + OLD_INT8['one_pass'])
NEW_INT8 = {
    'operands_only': [
        (r'(attention_int8_wgmma\(const uint8_t\* __restrict__ work,[^{]*\{)',
         r'\1\n  if (L > 0) return;')],
    'no_operands': [(r'  int8_operands_kernel<T, D><<<',
                     '  if (L < 0) int8_operands_kernel<T, D><<<')],
    'no_pass1': [(r'float mx\[2\] = \{-INFINITY, -INFINITY\};',
                  'float mx[2] = {0.f, 0.f};'),
                 (r'for \(int j = 0; j < n_tiles; j \+= 2\) \{',
                  'for (int j = 0; j < 0; j += 2) {')],
    'no_exp': [(r'const float p = expf\(', 'const float p = (')],
}
NEW_LNQKV = {
    'no_norm': [(r'for \(int j = 0; j < 4; \+\+j\) \{\n        const int kj',
                 'for (int j = 0; j < 0; ++j) {\n        const int kj')],
    'no_mma': [(r'for \(int kk = 0; kk < kTK / 16; \+\+kk\)\n      wgmma_',
                'for (int kk = 0; kk < 0; ++kk)\n      wgmma_')],
    'no_store': [(r'for \(int bx = 0; bx < kTN / kOutBox; \+\+bx\)',
                  'for (int bx = 0; bx < 0; ++bx)')],
    'no_stats': [(r'  ln_stats_kernel<<<', '  if (M < 0) ln_stats_kernel<<<')],
}
NEW_CODEBOOK = {
    'as_is': [],
    'no_fma': [(r'for \(int q = 0; q < kBK / 4; \+\+q\) \{\n      float4 av',
                'for (int q = 0; q < 0; ++q) {\n      float4 av')],
    'no_merge': [(r'  if \(!is_last\) return;', '  return;')],
}
NEW_ATTN_FP32 = {
    'as_is': [],
    'no_mask_load': [(r'mk\[i\]\[c\] = ok \? __ldg\(mrow\[i\] '
                      r'\+ kCols \* c\) : 0\.f;', 'mk[i][c] = 0.f;')],
    'no_kv_stage': [(r'for \(int n = 0; n < kBK / kPass; \+\+n\)',
                     'for (int n = 0; n < 0; ++n)')],
    'no_exp': [(r'exp2_ftz\(fmaf\(sc\[i\]\[c\]', '(fmaf(sc[i][c]')],
    'no_qk': [(r'for \(int d = 0; d < D; d \+= 4\)',
               'for (int d = 0; d < 0; d += 4)')],
    'no_pv': [(r'for \(int c = 0; c < kBK; c \+= 4\)',
               'for (int c = 0; c < 0; c += 4)')],
    'three_stages': [(r'constexpr int kStages = 2;',
                      'constexpr int kStages = 3;')],
}
# the split-TF32 sample head (fp32 W): the sampling launch cut out
# (no_sample), the logits launch cut out (sample_only: the sampling of
# stale logits), the products cut out, one TF32 pass (h_hi W_hi) alone,
# the tile's products summed in the tensor cores' accumulator over all of
# D instead of a fresh one each slab (no_promote), the LN arithmetic of
# the fragments cut out (no_norm_math: h = x), and the LN statistics'
# prologue cut out (no_stats: mu 0, rstd 1)
NEW_HEAD_TF32 = {
    'as_is': [],
    'no_sample': [(r'  sample_head_tf32_sample<<<',
                   '  if (M < 0) sample_head_tf32_sample<<<')],
    'sample_only': [(r'  sample_head_tf32_logits<<<',
                     '  if (M < 0) sample_head_tf32_logits<<<')],
    'no_products': [(r'    wgmma_fence\(\);\n    wgmma_tf32_n128[^;]*;\n'
                     r'[^;]*;\n[^;]*;\n', '    wgmma_fence();\n')],
    'one_pass': [(r'    wgmma_tf32_n128\(acc, lo, [^;]*;\n'
                  r'    wgmma_tf32_n128\(acc, hi, desc_swizzled\(wlo[^;]*;\n'
                  r'    wgmma_tf32_n128\(acc, hi, desc_swizzled\(whi, 128\), '
                  r'1\);',
                  '    wgmma_tf32_n128(acc, hi, desc_swizzled(whi, 128), '
                  '!fresh);')],
    'no_promote': [(r'products\(it, 0, ahi\[0\], alo\[0\], true\)',
                    'products(it, 0, ahi[0], alo[0], q == 0)'),
                   (r'sum\[i\] \+= acc\[i\];', 'sum[i] = acc[i];')],
    'no_norm_math': [(r'const float hv = __fadd_rn\(\n[^;]*;',
                      'const float hv = xv;')],
    'no_stats': [(r'for \(int i = 0; i < 16; i \+= kStatRows\)',
                  'for (int i = 0; i < 0; i += kStatRows)'),
                 (r'const float2 ms\[2\] = \{[^}]*\};',
                  'const float2 ms[2] = {make_float2(0.f, 1.f), '
                  'make_float2(0.f, 1.f)};')],
}
# the builds whose outputs are wrong on purpose
HEAD_CUT = ('no_sample', 'sample_only', 'no_products', 'no_norm_math',
            'no_stats')
HEAD_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_void_p]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4)
OLD_HEAD_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                 + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 3
                 + [ctypes.c_void_p] * 3)
NEW_ATTN_FP32['products_only'] = (
    NEW_ATTN_FP32['no_mask_load'] + NEW_ATTN_FP32['no_exp']
    + [(r'mx = fmaxf\(mx, __shfl_xor_sync\(0xffffffffu, mx, off\)\);', ';')])
# the first fp32 kernel's C entry also dispatches bf16 to attention_wgmma:
# a stub that refuses it links it alone
WGMMA_STUB = """#include "common.cuh"
namespace mmvid {
cudaError_t attention_wgmma(int, bool, const void*, const void*, const void*,
                            const float*, void*, int, int, int,
                            const long long*, float, cudaStream_t) {
  return cudaErrorNotSupported;
}
}  // namespace mmvid
"""
ATTN_ARGS = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
# the current kernel's query tiles, in rows a thread (kTileRows)
TILE_ROWS = (8, 6, 4)
# (B, L, H, mask kind, mask_prev rows): the fp32 route's shapes
ATTN_FP32_SHAPES = ((16, 565, 12, 'mask_prev', (51, 52)),
                    (16, 629, 12, 'mask_prev', (115, 116)),
                    (16, 50, 12, None, None),
                    (16, 77, 8, 'causal', None))
# C entries of PR 20's two backward sources (their own signatures)
OLD_BWD_STUB = """#include "common.cuh"
namespace mmvid {
cudaError_t attention_bwd_wgmma(int, const void* const*, const float*,
                                const float*, float*, int, int, int, int,
                                const long long*, float, cudaStream_t);
cudaError_t attention_bwd_fp32(int, const void* const*, const float*,
                               const float*, float*, float*, int, int, int,
                               int, const long long*, float, cudaStream_t);
}  // namespace mmvid
extern "C" int mmvid_old_attention_bwd(
    int dtype, int head_dim, const void* const* ptrs, const void* mask,
    const void* lse, void* delta, void* scratch, int B, int L, int H,
    int lse_ld, const long long* strides, float scale, void* stream) {
  const float* m = static_cast<const float*>(mask);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mmvid::kBFloat16)
    return mmvid::attention_bwd_wgmma(head_dim, ptrs, m, ls, dl, B, L, H,
                                      lse_ld, strides, scale, s);
  return mmvid::attention_bwd_fp32(head_dim, ptrs, m, ls, dl,
                                   static_cast<float*>(scratch), B, L, H,
                                   lse_ld, strides, scale, s);
}
"""
OLD_BWD_ARGS = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                + [ctypes.c_int] * 4
                + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
# the current backward kernels as they are and with one part cut out
# (regex, replacement) of csrc/attention_bwd_sm90.cu (bf16) and
# csrc/attention_bwd_fp32_sm90.cu (fp32); each built with the entry
# (csrc/attention_bwd.cu) and the other route as it is
NEW_BWD_BF16 = {
    'as_is': [],
    # one of the two passes alone
    'no_query_pass': [(r'attention_bwd_query<D><<<grid, kThreads, smem, '
                       r'stream>>>\(a\);', '')],
    'no_key_pass': [(r'attention_bwd_key<D><<<grid, kThreads, smem, '
                     r'stream>>>\(a\);', '')],
}
NEW_BWD_FP32 = {
    'as_is': [],
    'no_partial_store': [(r'if \(qr < L\)\n', 'if (false)\n')],
    'no_dq_launch': [(r'attention_bwd_fp32_dq<D>\s*<<<[^;]*;', '')],
    'no_dq_products': [(r'grp < 4', 'grp < 0')],
    'no_dv_products': [(r'product_tile<D>\(acc, st, qt\(1, 0\), '
                        r'qt\(1, 1\)\);', '')],
    'no_dk_products': [(r'product_tile<D>\(acc, dp, qt\(0, 0\), '
                        r'qt\(0, 1\)\);', '')],
    'no_s_products': [(r'wgmma_ss_n32\(x, al, bh_, s > 0\);\s*'
                       r'wgmma_ss_n32\(x, ah, bl, 1\);\s*'
                       r'wgmma_ss_n32\(x, ah, bh_, 1\);', '')],
    # the tile's Q and G split into shared memory (both layouts), or only
    # the transposed copies
    'no_tile_split': [(r'for \(int which = 0; which < 2; \+\+which\)'
                       r'(\n#pragma unroll\n\s*for \(int c = 0; c < '
                       r'T::kSlabs; \+\+c\) \{\n\s*const float4 x = which)',
                       r'for (int which = 0; which < 0; ++which)\1')],
    'no_transposed_store': [(r'st_f32\(qt\(which, 0\) \+ slab_off\(d, lp\), '
                             r'hi\[u\]\);', ''),
                            (r'st_f32\(qt\(which, 1\) \+ slab_off\(d, lp\), '
                             r'lo\[u\]\);', '')],
    # the tile loads a warp's 32 rows of one chunk: the transposed stores
    # fall in 32 banks, not 8
    'chunk_major_loads': [(r'const int lr = tid >> 3, lc = tid & 7;',
                           'const int lr = tid & 31, lc = tid >> 5;')],
    # the mask's bits read (as the models call it: the compact form)
    'no_mask_bits': [(r'\(mb\[4 \* \(8 \* i \+ 2 \* t \+ e\) \+ \(kl >> 5\)\] '
                      r'>> \(kl & 31\)\) & 1u', '0u')],
}
# (B, L, mask_prev rows, dtypes): the backward's timed shapes
ATTN_BWD_SHAPES = ((16, 565, (51, 52), ('bfloat16', 'float32')),
                   (16, 629, (115, 116), ('bfloat16', 'float32')),
                   (48, 565, (51, 52), ('bfloat16',)))
OLD_CODEBOOK_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p] * 2)
NEW_CODEBOOK_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p] * 5)
OLD_INT8_ARGS = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
NEW_INT8_ARGS = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                 + [ctypes.c_int, ctypes.c_float, ctypes.c_float]
                 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
LNQKV_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3


def patch(src: str, subs) -> str:
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        if n == 0:
            raise ValueError(f'pattern not in the source: {pat}')
    return src


def build(int8_source, lnqkv_source, codebook_source, tmp: Path,
          attention_fp32_source=None, sample_head=False,
          attention_bwd_source=None, bwd_variants=False) -> dict:
    """{(family, variant): C entry point}, one library each, all nvcc runs
    at once.  Families: old_int8, new_int8 (with ``int8_source``),
    old_lnqkv, new_lnqkv (``lnqkv_source``), old_codebook, new_codebook
    (``codebook_source``), old_attn_fp32, new_attn_fp32
    (``attention_fp32_source``), old_head, new_head_tf32
    (``sample_head``: the CUDA-core kernel and the split-TF32 one, both
    from this tree), old_bwd (``attention_bwd_source``: PR 20's backward
    kernels, both routes in one library), new_bwd_bf16 and new_bwd_fp32
    (``bwd_variants``: the current backward kernels, NEW_BWD_BF16 and
    NEW_BWD_FP32)."""
    nvcc = _build.find_nvcc()
    for name in ('common.cuh', 'sm90.cuh', 'sample_head.cuh',
                 'attention_sm90.cuh', 'attention_bwd.cuh'):
        (tmp / name).write_bytes((_build.CSRC_DIR / name).read_bytes())

    def current(name):
        return (_build.CSRC_DIR / name).read_text()

    sources = {}
    if int8_source:
        old8, new8 = int8_source.read_text(), current('attention_int8_sm90.cu')
        sources.update({('old_int8', n): patch(old8, v)
                        for n, v in OLD_INT8.items()})
        sources.update({('new_int8', n): patch(new8, v)
                        for n, v in NEW_INT8.items()})
    if lnqkv_source:
        newln = current('fused_ln_qkv_sm90.cu')
        sources[('old_lnqkv', 'as_is')] = lnqkv_source.read_text()
        sources.update({('new_lnqkv', n): patch(newln, v)
                        for n, v in NEW_LNQKV.items()})
    if codebook_source:
        newcb = current('codebook_sm90.cu')
        sources[('old_codebook', 'as_is')] = codebook_source.read_text()
        sources.update({('new_codebook', n): patch(newcb, v)
                        for n, v in NEW_CODEBOOK.items()})
    extra = {}
    if attention_fp32_source:
        newfp = current('attention_fp32_sm90.cu')
        sources[('old_attn_fp32', 'as_is')] = (
            attention_fp32_source.read_text())
        (tmp / 'wgmma_stub.cu').write_text(WGMMA_STUB)
        extra[('old_attn_fp32', 'as_is')] = [str(tmp / 'wgmma_stub.cu')]
        sources.update({('new_attn_fp32', n): patch(newfp, v)
                        for n, v in NEW_ATTN_FP32.items()})
    if attention_bwd_source:
        key = ('old_bwd', 'as_is')
        sources[key] = OLD_BWD_STUB
        extra[key] = []
        for name in ('attention_bwd_sm90.cu', 'attention_bwd_fp32_sm90.cu'):
            (tmp / f'old_{name}').write_bytes(
                (attention_bwd_source / name).read_bytes())
            extra[key].append(str(tmp / f'old_{name}'))
    if bwd_variants:
        # the entry and both routes as they are, compiled once
        objs = {n: str(tmp / f'cur_{n}.o') for n in (
            'attention_bwd.cu', 'attention_bwd_sm90.cu',
            'attention_bwd_fp32_sm90.cu')}
        _build._run_all([[nvcc, *_build.NVCC_FLAGS, f'-I{tmp}', '-c', '-o',
                          o, str(_build.CSRC_DIR / n)]
                         for n, o in objs.items()])
        for route, other, variants in (
                ('bf16', 'attention_bwd_fp32_sm90.cu', NEW_BWD_BF16),
                ('fp32', 'attention_bwd_sm90.cu', NEW_BWD_FP32)):
            mine = current('attention_bwd_sm90.cu' if route == 'bf16'
                           else 'attention_bwd_fp32_sm90.cu')
            for n, v in variants.items():
                key = (f'new_bwd_{route}', n)
                sources[key] = patch(mine, v)
                extra[key] = [objs['attention_bwd.cu'], objs[other]]
    if sample_head:
        sources[('old_head', 'as_is')] = current('sample_head.cu')
        newh = current('sample_head_tf32_sm90.cu')
        sources.update({('new_head_tf32', n): patch(newh, v)
                        for n, v in NEW_HEAD_TF32.items()})
    cmds, libs = [], {}
    for key, src in sources.items():
        stem = '_'.join(key)
        cu = tmp / f'{stem}.cu'
        cu.write_text(src)
        libs[key] = tmp / f'lib_{stem}.so'
        ptxas = (['-Xptxas', '-v'] if key[0] in ('new_head_tf32', 'old_bwd')
                 or key == ('new_bwd_fp32', 'as_is') else [])
        cmds.append([nvcc, *_build.NVCC_FLAGS, *ptxas, f'-I{tmp}', '-shared',
                     '-o', str(libs[key]), str(cu), *extra.get(key, [])])
    for key, out in zip(sources, _build._run_all(cmds)):
        for line in out.splitlines():   # the split-TF32 builds' registers
            if 'spill' in line or 'Used' in line:
                print(f'[attribution] ptxas {"_".join(key)}: '
                      f'{line.strip()}', flush=True)
    fns = {}
    for key, path in libs.items():
        lib = ctypes.CDLL(str(path))
        if key[0].endswith('lnqkv'):
            fn, args = lib.mmvid_ln_qkv, LNQKV_ARGS
        elif key[0] == 'old_attn_fp32':
            fn, args = lib.mmvid_attention_fwd, ATTN_ARGS
        elif key[0] == 'new_attn_fp32':
            fn, args = lib.mmvid_attention_fp32_at, ATTN_ARGS
        elif key[0] == 'old_bwd':
            fn, args = lib.mmvid_old_attention_bwd, OLD_BWD_ARGS
        elif key[0].startswith('new_bwd'):
            from mmvid_tpu_torch.ops.attention import _BWD_ARGTYPES
            fn, args = lib.mmvid_attention_bwd, _BWD_ARGTYPES
        elif key[0] == 'old_head':
            fn, args = lib.mmvid_sample_head, OLD_HEAD_ARGS
        elif key[0] == 'new_head_tf32':
            fn, args = lib.mmvid_sample_head_tf32, HEAD_ARGS
        elif key[0].endswith('codebook'):
            fn = lib.mmvid_nearest_code
            args = (OLD_CODEBOOK_ARGS if key[0] == 'old_codebook'
                    else NEW_CODEBOOK_ARGS)
        else:
            fn = lib.mmvid_attention_int8_fwd
            args = OLD_INT8_ARGS if key[0] == 'old_int8' else NEW_INT8_ARGS
        fn.argtypes = args
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def time_ms(fn, calls=20, reps=5):
    """Device ms a call (``chip_smoke.cuda_time_ms``'s method: the calls
    queued behind a device-side wait, so host time stays out)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(5_000_000)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def in_turns(calls: dict) -> dict:
    """{name: ms}: each call timed twice, in order and in reverse order,
    the mean of the two."""
    times = {name: [] for name in calls}
    for names in (list(calls), list(calls)[::-1]):
        for name in names:
            times[name].append(time_ms(calls[name]))
    return {n: statistics.mean(t) for n, t in times.items()}


def checked(fn, *args):
    """A call of a C entry point that raises on a CUDA error."""
    def call():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f'launch failed: {rc}')
    return call


def int8_attention(fns, res):
    from mmvid_tpu_torch.models.clip import attention_mask
    from mmvid_tpu_torch.ops import attention as A
    from mmvid_tpu_torch.ops import attention_int8 as A8
    os.environ['MMVID_ATTN_INT8'] = '1'
    for l, idx in ((565, (51, 52)), (629, (115, 116))):
        b, h, d = 16, 12, 64
        g = torch.Generator(device='cuda').manual_seed(l)
        qkv = torch.randn((b, l, 3 * h * d), generator=g,
                          device='cuda').bfloat16()
        q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, l, h, d)
                   for i in range(3))
        masks = attention_mask(l, 'mask_prev', index=idx, device='cuda')
        mask, bits = masks.dense, masks.compact.bits
        out = torch.empty((b, l, h, d), dtype=q.dtype, device='cuda')
        work = torch.empty((A8.workspace_bytes(b, l, h),), dtype=torch.uint8,
                           device='cuda')
        st = (ctypes.c_longlong * 12)(
            *(s for t in (q, k, v, out) for s in t.stride()[:3]))
        stream = torch.cuda.current_stream().cuda_stream
        scale = float(torch.tensor(d ** -0.5, dtype=q.dtype))
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr())
        calls = {}
        for (family, name), fn in fns.items():
            if family == 'old_int8':
                calls[f'old_{name}'] = checked(
                    fn, 1, d, *ptrs, out.data_ptr(), b, l, h, st, scale,
                    stream)
            elif family == 'new_int8':
                calls[f'new_{name}'] = checked(
                    fn, 1, d, *ptrs, bits.data_ptr(), A8.mask_words(l),
                    masks.compact.c0, masks.compact.c1, work.data_ptr(),
                    out.data_ptr(), b, l, h, st, scale, stream)
        calls['new_compact_mask'] = lambda: A.fused_attention_blhd(
            q, k, v, masks)
        calls['new_fp32_mask'] = lambda: A.fused_attention_blhd(
            q, k, v, mask)
        res['int8_attention_ms'][l] = in_turns(calls)
        for n, t in res['int8_attention_ms'][l].items():
            print(f'[attribution] int8 attention L={l} {n}: {t:.4f} ms',
                  flush=True)
    os.environ.pop('MMVID_ATTN_INT8')


def ln_qkv(fns, res):
    import torch.nn.functional as F
    from mmvid_tpu_torch.ops import fused_ln_qkv as Q
    d = 768
    for m in (16 * 629, 16 * 565):
        g = torch.Generator(device='cuda').manual_seed(m)
        x = (torch.randn((m, d), generator=g, device='cuda') * 2 + 0.5
             ).bfloat16()
        ln_w = 1 + 0.1 * torch.randn((d,), generator=g, device='cuda')
        ln_b = 0.1 * torch.randn((d,), generator=g, device='cuda')
        w = (torch.randn((3 * d, d), generator=g, device='cuda')
             * d ** -0.5).bfloat16()
        b = (0.1 * torch.randn((3 * d,), generator=g, device='cuda')
             ).bfloat16()
        stats = torch.empty((m, 2), device='cuda')
        out = torch.empty((m, 3 * d), dtype=x.dtype, device='cuda')
        args = (x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w.data_ptr(),
                b.data_ptr(), m, d, stats.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        calls = {f'{family.split("_")[0]}_{name}': checked(fn, *args)
                 for (family, name), fn in fns.items()
                 if family.endswith('lnqkv')}
        calls['new'] = lambda: Q.fused_ln_qkv(x, ln_w, ln_b, w, b)
        calls['layer_norm_linear'] = lambda: F.linear(F.layer_norm(
            x.float(), (d,), ln_w, ln_b, 1e-5).bfloat16(), w, b)
        res['ln_qkv_ms'][m] = in_turns(calls)
        for n, t in res['ln_qkv_ms'][m].items():
            print(f'[attribution] LN+QKV M={m} {n}: {t:.4f} ms', flush=True)


def nearest_code(fns, res):
    from mmvid_tpu_torch.ops import codebook as C
    torch.backends.cuda.matmul.allow_tf32 = False
    d, k = 256, 1024
    g = torch.Generator(device='cuda').manual_seed(11)
    cb = (torch.rand((k, d), generator=g, device='cuda') * 2 - 1) / k
    stream = torch.cuda.current_stream().cuda_stream
    for m in (1024, 4096, 8192):
        z = torch.randn((m, d), generator=g, device='cuda')
        idx = torch.empty((m,), dtype=torch.int64, device='cuda')
        tiles = -(-k // C.CODES_PER_TILE)
        part_s = torch.empty((tiles, m), device='cuda')
        part_i = torch.empty((tiles, m), dtype=torch.int32, device='cuda')
        counters = torch.zeros((-(-m // C.ROWS_PER_TILE),),
                               dtype=torch.int32, device='cuda')
        calls = {}
        for (family, name), fn in fns.items():
            if family == 'old_codebook':
                calls['old'] = checked(fn, z.data_ptr(), cb.data_ptr(), m, d,
                                       k, idx.data_ptr(), stream)
            elif family == 'new_codebook':
                calls[f'new_{name}'] = checked(
                    fn, z.data_ptr(), cb.data_ptr(), m, d, k,
                    part_s.data_ptr(), part_i.data_ptr(),
                    counters.data_ptr(), idx.data_ptr(), stream)
        calls['new'] = lambda: C.nearest_codebook_indices(z, cb)
        calls['plain'] = lambda: C.nearest_codebook_reference(z, cb)
        res['codebook_ms'][m] = in_turns(calls)
        for n, t in res['codebook_ms'][m].items():
            print(f'[attribution] nearest code M={m} {n}: {t:.4f} ms',
                  flush=True)


def attention_fp32(fns, res):
    from mmvid_tpu_torch.models.clip import build_attention_mask
    from mmvid_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    d = 64
    stream = torch.cuda.current_stream().cuda_stream
    for b, l, h, kind, idx in ATTN_FP32_SHAPES:
        g = torch.Generator(device='cuda').manual_seed(l)
        qkv = torch.randn((b, l, 3 * h * d), generator=g, device='cuda')
        q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, l, h, d)
                   for i in range(3))
        mask = (build_attention_mask(l, kind, index=idx, device='cuda')
                if kind else torch.zeros((l, l), device='cuda'))
        out = torch.empty((b, l, h, d), device='cuda')
        st = (ctypes.c_longlong * 12)(
            *(s for t in (q, k, v, out) for s in t.stride()[:3]))
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                out.data_ptr())
        rows = A.fp32_tile_rows(b, l, h)
        calls = {}
        for (family, name), fn in fns.items():
            if family == 'old_attn_fp32':
                calls['old'] = checked(fn, 0, d, 0, *ptrs, b, l, h, st,
                                       d ** -0.5, stream)
            elif family == 'new_attn_fp32':
                calls[f'new_{name}'] = checked(fn, rows, d, 0, *ptrs, b, l,
                                               h, st, d ** -0.5, stream)
        for r in TILE_ROWS:
            calls[f'rows_{r}'] = (lambda r=r: A.fp32_kernel_at(
                r, q, k, v, mask))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        calls['route'] = lambda: A.fused_attention_blhd(q, k, v, mask)
        calls['sdpa_fp32'] = (
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
        calls['plain'] = lambda: A.attention_reference(q, k, v, mask,
                                                       d ** -0.5)
        tag = f'L{l}_H{h}'
        res['attention_fp32_ms'][tag] = in_turns(calls)
        res['attention_fp32_route_rows'][tag] = rows
        print(f'[attribution] fp32 attention B={b} L={l} H={h}: the route '
              f'takes {rows} rows a thread', flush=True)
        for n, t in res['attention_fp32_ms'][tag].items():
            print(f'[attribution] fp32 attention B={b} L={l} H={h} {n}: '
                  f'{t:.4f} ms', flush=True)


def bwd_variants(fns, res):
    """The current backward kernels as they are and with one part cut out
    (NEW_BWD_BF16, NEW_BWD_FP32), in turns, at B16 H12 D64 L565 mask_prev
    on the packed views (fp32 given the mask's compact form, as the models
    call it)."""
    from mmvid_tpu_torch.models.clip import attention_mask
    from mmvid_tpu_torch.ops import attention as A
    from mmvid_tpu_torch.ops.attention_int8 import mask_words
    b, l, h, d = 16, 565, 12, 64
    mask, compact = attention_mask(l, 'mask_prev', index=(51, 52),
                                   device='cuda')
    stream = torch.cuda.current_stream().cuda_stream
    for route, dtype in (('bf16', torch.bfloat16), ('fp32', torch.float32)):
        g = torch.Generator(device='cuda').manual_seed(l + b)
        qkv = torch.randn((b, l, 3 * h * d), generator=g,
                          device='cuda').to(dtype)
        cot = torch.randn((b, l, h, d), generator=g, device='cuda').to(dtype)
        q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, l, h, d)
                   for i in range(3))
        out, lse, out_lo = A._launch(q, k, v, mask, d ** -0.5, False,
                                     with_lse=True)
        bf16 = dtype == torch.bfloat16
        grads = [torch.empty((b, l, h, d), dtype=dtype, device='cuda')
                 for _ in range(3)]
        delta = torch.empty_like(lse)
        scratch = torch.empty(-(-l // 128) * b * h * l * d, device='cuda')
        ts = (q, k, v, out, cot, *grads)
        ptrs = (ctypes.c_void_p * 9)(*(t.data_ptr() for t in ts),
                                     out_lo.data_ptr() if bf16 else None)
        st = (ctypes.c_longlong * 24)(
            *(x for t in ts for x in t.stride()[:3]))
        calls = {}
        for (family, name), fn in fns.items():
            if family == f'new_bwd_{route}':
                calls[name] = checked(
                    fn, int(bf16), d, ptrs, mask.data_ptr(),
                    None if bf16 else compact.bits.data_ptr(),
                    0 if bf16 else mask_words(l), compact.c0, compact.c1,
                    lse.data_ptr(), delta.data_ptr(),
                    None if bf16 else scratch.data_ptr(), b, l, h,
                    lse.shape[-1], st, d ** -0.5, stream)
        res['attention_bwd_variants_ms'][route] = in_turns(calls)
        for n, t in res['attention_bwd_variants_ms'][route].items():
            print(f'[attribution] attention backward {route} B16 L565 {n}: '
                  f'{t:.4f} ms', flush=True)
        del qkv, cot, q, k, v, out, lse, out_lo, grads, scratch
        torch.cuda.empty_cache()


def attention_bwd(old_fn, res):
    """PR 20's backward kernels (``old_fn``, their C entry) against the
    route and SDPA, in turns, at ATTN_BWD_SHAPES; the old and new results'
    gaps to the plain version."""
    from mmvid_tpu_torch.models.clip import attention_mask
    from mmvid_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    h, d = 12, 64
    stream = torch.cuda.current_stream().cuda_stream
    for b, l, idx, dtypes in ATTN_BWD_SHAPES:
        both = attention_mask(l, 'mask_prev', index=idx, device='cuda')
        mask, compact = both
        scale = d ** -0.5
        for name in dtypes:
            dtype = getattr(torch, name)
            g = torch.Generator(device='cuda').manual_seed(l + b)
            qkv = torch.randn((b, l, 3 * h * d), generator=g,
                              device='cuda').to(dtype)
            cot = torch.randn((b, l, h, d), generator=g,
                              device='cuda').to(dtype)
            q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, l, h, d)
                       for i in range(3))
            out, lse, out_lo = A._launch(q, k, v, mask, scale, False,
                                         with_lse=True)
            bf16 = dtype == torch.bfloat16
            grads = [torch.empty((b, l, h, d), dtype=dtype, device='cuda')
                     for _ in range(3)]
            delta = torch.empty_like(lse)
            scratch = torch.empty(-(-l // 128) * b * h * l * d,
                                  device='cuda')
            ts = (q, k, v, out, cot, *grads)
            ptrs = (ctypes.c_void_p * 9)(*(t.data_ptr() for t in ts),
                                         out_lo.data_ptr() if bf16 else None)
            st = (ctypes.c_longlong * 24)(
                *(x for t in ts for x in t.stride()[:3]))
            old = checked(old_fn, int(bf16), d, ptrs, mask.data_ptr(),
                          lse.data_ptr(), delta.data_ptr(),
                          scratch.data_ptr(), b, l, h, lse.shape[-1], st,
                          scale, stream)
            args = (q, k, v, mask, scale, cot, out, lse, out_lo)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            mt, ct = mask.to(dtype), cot.transpose(1, 2)

            def sdpa():
                o = torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mt)
                return torch.autograd.grad(o, (qt, kt, vt), ct)

            calls = {'old': old,
                     'new': lambda: A.attention_backward_kernel(
                         *args, compact=compact),
                     'sdpa': sdpa}
            if not bf16:   # the route reads the bits; the fp32 mask alone
                calls['new_fp32_mask'] = (
                    lambda: A.attention_backward_kernel(*args))
            plain = A.attention_backward(q, k, v, mask, scale, cot)
            old()
            new = calls['new']()
            torch.cuda.synchronize()

            def gap(got):
                return max(((x.float() - w.float()).abs()
                            / (1 + w.float().abs())).max().item()
                           for x, w in zip(got, plain))

            tag = f'B{b}_L{l}_{name}'
            res['attention_bwd_gap'][tag] = {'old': gap(grads),
                                             'new': gap(new)}
            del plain, new
            res['attention_bwd_ms'][tag] = in_turns(calls)
            for n, t in res['attention_bwd_ms'][tag].items():
                print(f'[attribution] attention backward {tag} {n}: '
                      f'{t:.4f} ms', flush=True)
            print(f'[attribution] attention backward {tag}: gap to plain '
                  f'{res["attention_bwd_gap"][tag]}', flush=True)
            del qt, kt, vt, qkv, cot, q, k, v, out, lse, out_lo, grads
            torch.cuda.empty_cache()


def sample_head(fns, res):
    """The sample head with fp32 W at the main paths' M 8192 (16 videos of
    512 tokens), D 768, V 1024: every build in turns, the route, and
    F.layer_norm + F.linear in fp32 (TF32 off; the product alone, another
    function); and each build's agreement with the plain version fed
    philox_gumbel at temp 1 (tokens equal, Y's relative error where they
    are) and at temp 0 (|Y - p(tok)|)."""
    import torch.nn.functional as F
    from mmvid_tpu_torch.ops import sample_head as S
    torch.backends.cuda.matmul.allow_tf32 = False
    m, d, v = 8192, 768, 1024
    g = torch.Generator(device='cuda').manual_seed(7)
    x = torch.randn((m, d), generator=g, device='cuda') * 2 + 0.5
    ln_w = 1 + 0.1 * torch.randn((d,), generator=g, device='cuda')
    ln_b = 0.1 * torch.randn((d,), generator=g, device='cuda')
    w = 0.108 * torch.randn((d, v), generator=g, device='cuda')
    b = 0.1 * torch.randn((v,), generator=g, device='cuda')
    seed = torch.tensor([20260516], dtype=torch.int64, device='cuda')
    hi, lo = S.prepare_head_weight(w)
    runs = S.tf32_runs(m, v, torch.cuda.get_device_properties(
        0).multi_processor_count)
    logits = torch.empty((m, v), device='cuda')
    y = torch.empty((m,), device='cuda')
    tok = torch.empty((m,), dtype=torch.int64, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream

    def call(family, fn, temp):
        if family == 'old_head':
            return checked(fn, 0, x.data_ptr(), ln_w.data_ptr(),
                           ln_b.data_ptr(), w.data_ptr(), b.data_ptr(),
                           temp, seed.data_ptr(), m, d, v, y.data_ptr(),
                           tok.data_ptr(), stream)
        return checked(fn, x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                       hi.data_ptr(), lo.data_ptr(), b.data_ptr(), temp,
                       seed.data_ptr(), m, d, v, runs, logits.data_ptr(),
                       y.data_ptr(), tok.data_ptr(), stream)

    g1, g2 = S.philox_gumbel(int(seed), m, v, 'cuda')
    y_ref, tok_ref = S.sample_head_reference(x, ln_w, ln_b, w, b, 1.0, g1,
                                             g2)
    probs = torch.softmax(S.head_logits(x, ln_w, ln_b, w, b), -1)
    names = {key: 'old' if key[0] == 'old_head' else key[1] for key in fns
             if key[0] in ('old_head', 'new_head_tf32')}
    for key, name in names.items():
        if name in HEAD_CUT:
            continue
        call(key[0], fns[key], 1.0)()
        same = tok == tok_ref
        share = same.float().mean().item()
        y_rel = (((y - y_ref).abs() / y_ref)[same].max().item()
                 if bool(same.any()) else float('nan'))
        call(key[0], fns[key], 0.0)()
        y0 = (y - probs.gather(1, tok[:, None])[:, 0]).abs().max().item()
        res['sample_head_agreement'][name] = {
            'tokens_equal_share': share, 'y_rel_err': y_rel,
            'temp0_y_err': y0}
        print(f'[attribution] sample head {name}: tokens equal {share:.6f}, '
              f'Y rel {y_rel:.3e}; temp 0 |Y - p(tok)| {y0:.3e}', flush=True)
    calls = {name: call(key[0], fns[key], 1.0) for key, name in names.items()}
    calls['route'] = lambda: S.sample_head_kernel(x, ln_w, ln_b, w, b, 1.0,
                                                  seed, w_prepared=(hi, lo))
    wt = w.t().contiguous()
    calls['layer_norm_linear'] = lambda: F.linear(
        F.layer_norm(x, (d,), ln_w, ln_b), wt, b)
    res['sample_head_ms'] = in_turns(calls)
    for n, t in res['sample_head_ms'].items():
        print(f'[attribution] sample head M={m} fp32 W {n}: {t:.4f} ms',
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--int8-source', type=Path, default=None)
    ap.add_argument('--lnqkv-source', type=Path, default=None)
    ap.add_argument('--codebook-source', type=Path, default=None)
    ap.add_argument('--attention-fp32-source', type=Path, default=None)
    ap.add_argument('--sample-head', action='store_true')
    ap.add_argument('--attention-bwd-source', type=Path, default=None)
    ap.add_argument('--attention-bwd-variants', action='store_true')
    ap.add_argument('--out', type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    res = {'device': smi, 'int8_attention_ms': {}, 'ln_qkv_ms': {},
           'codebook_ms': {}, 'attention_fp32_ms': {},
           'attention_fp32_route_rows': {}, 'sample_head_ms': {},
           'sample_head_agreement': {}, 'attention_bwd_ms': {},
           'attention_bwd_gap': {}, 'attention_bwd_variants_ms': {}}
    _build.library()
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(args.int8_source, args.lnqkv_source,
                    args.codebook_source, Path(tmp),
                    args.attention_fp32_source, args.sample_head,
                    args.attention_bwd_source, args.attention_bwd_variants)
        with torch.no_grad():
            if args.int8_source:
                int8_attention(fns, res)
            if args.lnqkv_source:
                ln_qkv(fns, res)
            if args.codebook_source:
                nearest_code(fns, res)
            if args.attention_fp32_source:
                attention_fp32(fns, res)
            if args.sample_head:
                sample_head(fns, res)
        if args.attention_bwd_source:
            attention_bwd(fns[('old_bwd', 'as_is')], res)
        if args.attention_bwd_variants:
            with torch.no_grad():
                bwd_variants(fns, res)
    print(json.dumps(res), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))


if __name__ == '__main__':
    main()
