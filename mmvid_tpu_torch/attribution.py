#!/usr/bin/env python3
"""Where the int8 attention and fused LN+QKV kernels spend their time: the
first kernels (``csrc/attention_int8.cu`` and ``csrc/fused_ln_qkv.cu`` of
commit 3f73783) and the port's current ones (``csrc/attention_int8_sm90.cu``
and ``csrc/fused_ln_qkv_sm90.cu``), each built as it is and as variants
with one part of its work cut out, timed in turns on the card.  The
variants compute wrong outputs on purpose; only their times are read.

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

Usage (needs nvcc and a CUDA card; the old sources from git history, e.g.
``git show 3f73783:mmvid_tpu_torch/csrc/attention_int8.cu > OLD8.cu``):

    python -m mmvid_tpu_torch.attribution --int8-source OLD8.cu \\
        --lnqkv-source OLDLN.cu [--out FILE]

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


def build(int8_source: Path, lnqkv_source: Path, tmp: Path) -> dict:
    """{(family, variant): C entry point}, one library each, all nvcc runs
    at once.  Families: old_int8, new_int8, old_lnqkv, new_lnqkv."""
    nvcc = _build.find_nvcc()
    for name in ('common.cuh', 'sm90.cuh'):
        (tmp / name).write_bytes((_build.CSRC_DIR / name).read_bytes())
    old8 = int8_source.read_text()
    new8 = (_build.CSRC_DIR / 'attention_int8_sm90.cu').read_text()
    newln = (_build.CSRC_DIR / 'fused_ln_qkv_sm90.cu').read_text()
    sources = {('old_int8', n): patch(old8, v) for n, v in OLD_INT8.items()}
    sources.update({('new_int8', n): patch(new8, v)
                    for n, v in NEW_INT8.items()})
    sources[('old_lnqkv', 'as_is')] = lnqkv_source.read_text()
    sources.update({('new_lnqkv', n): patch(newln, v)
                    for n, v in NEW_LNQKV.items()})
    cmds, libs = [], {}
    for key, src in sources.items():
        stem = '_'.join(key)
        cu = tmp / f'{stem}.cu'
        cu.write_text(src)
        libs[key] = tmp / f'lib_{stem}.so'
        cmds.append([nvcc, *_build.NVCC_FLAGS, f'-I{tmp}', '-shared', '-o',
                     str(libs[key]), str(cu)])
    _build._run_all(cmds)
    fns = {}
    for key, path in libs.items():
        lib = ctypes.CDLL(str(path))
        if key[0].endswith('lnqkv'):
            fn, args = lib.mmvid_ln_qkv, LNQKV_ARGS
        else:
            fn = lib.mmvid_attention_int8_fwd
            args = OLD_INT8_ARGS if key[0] == 'old_int8' else NEW_INT8_ARGS
        fn.argtypes = args
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def time_ms(fn, calls=20, reps=5):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--int8-source', type=Path, required=True)
    ap.add_argument('--lnqkv-source', type=Path, required=True)
    ap.add_argument('--out', type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    res = {'device': smi, 'int8_attention_ms': {}, 'ln_qkv_ms': {}}
    _build.library()
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(args.int8_source, args.lnqkv_source, Path(tmp))
        with torch.no_grad():
            int8_attention(fns, res)
            ln_qkv(fns, res)
    print(json.dumps(res), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))


if __name__ == '__main__':
    main()
