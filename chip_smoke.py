#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mmvid_tpu_torch``) on one GPU.

Drives the port's three sampling paths at full width on weights drawn from
a seed: flagship text-to-video mask-predict sampling (768 x 12-layer
backbone, 20 rounds, VQGAN decode of 8 frames at 128 px) through
``factories.flagship`` and ``generate.generate_videos``; the text+mask
visual-control recipe (scripts/mmvoxceleb/text_and_mask/test.sh: one
control frame through the cvae encoder and the nearest-code kernel, the
mask_8x8 erase, sequence 629) through ``factories.get_vae_model`` /
``get_dalle`` and ``MMVIDBert.generate_images``, with the fused LN+QKV
gate off and then on; and ART-V, the autoregressive sampler (the same
backbone from the text-to-video flags with ``--ar``: a prefill of the
115-position control prefix, then 511 KV-cached decode steps), through
``generate.generate_videos``, on the card's default path (the whole-step
decode kernel) and then with ``MMVID_ARTV_FUSED=0`` (the per-layer step);
then ART-V's exact speculative decode (``MMVID_ARTV_SPEC=8``) with a
control frame through the cvae; then int8 serving: the flagship calibrated by
``ops.int8.quantize_for_serving`` (w8a8 backbone and VQGAN decoder) under
``MMVID_ATTN_INT8=1`` (the int8 attention kernel), and ART-V's int8 decode
(``generate_images(int8=True)``).
The paths' models, inputs and batch-16 timings come from
``mmvid_tpu_torch.breakdown`` (``build``, ``inputs``, ``measure``).
Phases, in order; any failure exits non-zero and prints no result line:

1. device: CUDA is required; prints the card's name and power limit.
2. build: compiles ``mmvid_tpu_torch/csrc`` with nvcc (sm_90a), one nvcc
   per source in parallel.
3. attention kernels vs their plain version, ``MMVID_ATTN_BF16`` off and
   on: fp32 (the CUDA-core kernel, TF32 off) and bf16 (the tensor-core
   kernel) at each path's sequence and mask_prev rows: text+mask (L 629),
   flagship (L 565), tiny (L 139); bf16 on q, k, v as packed strided
   views with mask_prev and causal masks, D 64 and 32, and the share of
   outputs that differ from plain; times beside
   ``F.scaled_dot_product_attention`` with the same float mask on the
   packed views at L 629 and L 565.
   Then the int8 attention kernel (``MMVID_ATTN_INT8=1``) vs its plain
   version at L 565 and 629, B16 H12 D64 bf16 on the packed views, given
   the mask with its compact form as the models give it (the compact
   form equal to the dense mask): outputs differing, and by how many
   quantization steps; two calls bitwise equal, and equal to a call with
   the fp32 mask alone; two launches a call; timed with the compact mask
   and with the fp32 mask, beside its plain version (and SDPA's bf16
   time, as context only).
4. sample-head kernels vs their plain version: exact at temp 0 for Y
   given the chosen token, token histograms in distribution (TV bounds);
   at temp 1 both bf16 routes (tensor cores, CUDA cores) against the
   plain version fed the kernels' own noise (``philox_gumbel`` at one
   seed) and against each other, timed in turns.
5. nearest-code kernel vs its plain version at M 1024, 4096 and 8192
   (D 256, K 1024): ids equal on a randn codebook; within 1e-5 of the
   best score on the random-init codebook; kernel, plain and bound times
   at each M.
6. fused LN+QKV kernel vs its plain version at the text+mask and
   flagship shapes (M 16 x 629 and 16 x 565), bf16 (the kernel's only
   dtype; fp32 must raise on the card), timed beside the gate-off pair
   ``F.layer_norm`` + ``F.linear``.
7. ART-V decode-step kernels vs their plain version: both bf16 kernels
   (the phased one, the route, and the streaming one, forced) at full
   width (12 layers, W 626) at B 1, 5 and 64 (pos 0 and 1) beside the
   plain version's own move under a one-ulp move of x, and at B 16 (pos
   115, 370 and 625), cache rows >= pos NaN, two calls bitwise equal,
   timed in turns, and at B 64 timed; the streaming kernel's flags across
   layouts; fp32 and bf16 at a small shape; times and bounds per pos; the
   wrapper's host time a call.
8. grid-step probe vs its plain version: 64 chained calls at 1, 12 and
   192 launches a call, and the cost of one launch.
9. tiny models on the card vs the same weights on the CPU: the flagship,
   the text+mask model's cvae ids and forward logits, and ART-V's greedy
   tokens, each device on its default decode path; then ART-V's exact
   speculative decode on the card: greedy tokens equal to ``ar_sample``'s
   (decode kernel and per-layer step) at k 1, 4 and 8, forced
   acceptance's chunk counts, and the sampled distribution against the
   baseline's (chi^2 and TV, 800 lanes, CUDA generators).
10. flagship path: 6 prompts at batch 4, launch counts, output checks,
    determinism by seed; then ``breakdown.measure`` of a batch of 16.
11. text+mask path: one batch of 16, launch counts, output checks,
    determinism by seed, then ``breakdown.measure``; then again with
    MMVID_FUSED_LNQKV=1 (launch counts, tokens against the gate-off run,
    ``breakdown.measure``).
12. ART-V path: the 16 prompts in one batch on the card's default path
    (511 decode-kernel launches), then with MMVID_ARTV_FUSED=0 (no
    launch): output checks for each, determinism by seed on the default
    path, the host's time a token, the tokens that differ between the
    two, ``breakdown.measure``
    for each (one timed call of each for the per-layer path, seconds a
    batch).
13. ART-V's speculative decode at full width (MMVID_ARTV_SPEC=8, one
    control frame through the cvae and the nearest-code kernel): a greedy
    batch (launch counts, output checks, tokens a chunk), then
    ``breakdown.measure`` of the floor (determinism by seed) and of the
    forced ceiling, and the share of the greedy tokens equal to the
    per-layer baseline's (reported).
14. int8 serving, the flagship at full width: bf16 logits of one forward,
    then ``quantize_for_serving`` under MMVID_ATTN_INT8=1 and the JAX
    package's gates (logits cosine > 0.99, argmax agreement > 0.9; the
    decoder's int32 sums exact at every site, and each site alone within
    mean |d| < 0.02, max < 0.2; the whole decoder reported, see
    ``_int8_decoder_checks``); a batch of
    16 at 20 rounds: launch counts (int8 attention 480, two a call:
    the operand pass and the attention; sample head 20; the bf16
    attention kernel 0), output checks, determinism by seed,
    ``breakdown.measure``.
15. ART-V int8 at full width: a warm-up batch of 16 and one timed, output
    checks, the same tokens on one seed, no kernel launched.

Prints each phase's wall time (``[time]`` lines), the kernels' JSON line,
then as its last line ``{"ok": true, "device": {...}}``.  Run from the
repository root:
``python3 chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

# TV-distance bounds for 65536 samples (expected TV under a correct
# sampler is about 0.02 one-sample and 0.03 two-sample for the peaked
# distribution below; a kernel that drops or reuses its noise moves most
# of the mass onto one token, TV > 0.5).
TV_EXACT_BOUND = 0.05
TV_TWO_SAMPLE_BOUND = 0.07
# attention kernels vs plain, max abs error, by (dtype, MMVID_ATTN_BF16):
# fp32 sums in another order; bf16 outputs rounded from fp32 sums in
# another order (online softmax), up to 2 bf16 ulps at |out| ~ 2; fp32
# with bf16 probabilities: the kernel rounds exp(logit - running max), the
# plain version exp(logit - row max), so a term moves by up to 2^-9 of
# itself
ATTN_TOL = {('float32', False): 1e-4, ('float32', True): 4e-3,
            ('bfloat16', False): 2e-2, ('bfloat16', True): 2e-2}
# share of bf16 outputs of the default route (P_hi + P_lo) that may differ
# from the plain version's (about 0.2% expected; bf16 probabilities move
# about 40%)
ATTN_DIFFER_MAX = 0.02
# kernel Y vs the plain softmax probability of the kernel's token.  With a
# bf16 W the LN output is rounded to bf16 before the product; the kernel's
# and the plain LN statistics differ in the last fp32 bit, which flips the
# rounding of a few elements and moves a logit by ~1e-3.
Y_TOL = {'float32': 1e-5, 'bfloat16': 2e-3}
# a sample-head kernel vs the plain version fed the same Philox noise at
# temp 1: tokens equal on this share of rows at least (the logits' fp32
# sums run in another order, so near-ties may flip), and Y within this
# relative error on equal rows: the LN output's bf16 roundings flip on
# last-bit differences of the statistics (Y_TOL's reason), which moves a
# logit, so noised[tok] and the logsumexp, by ~1e-3.  At M8192 on the H100
# the tensor-core kernel read 2.535e-3 and the CUDA-core kernel 1.588e-3
# in one run, and the control, the plain version with its logits rounded
# to bf16, 4.420e-2; the bound lies between them
HEAD_TOKEN_SHARE = 0.999
HEAD_Y_REL_TOL = 4e-3
# fused LN+QKV kernel (bf16) vs plain: |kernel - plain| <= tol * (1 +
# |plain|) elementwise (rtol = atol = tol, the CPU tests' form): h and the
# output are rounded to bf16, and a last-bit difference of the LN
# statistics can flip one rounding, one bf16 ulp (2^-8 relative; 0.03125
# at |qkv| in [4, 8))
LNQKV_TOL = 2e-2
# chosen code's score within this of the best (fp64) on the random-init
# codebook U(-1/1024, 1/1024), whose scores differ by ~1e-5 between codes
CODE_GAP_TOL = 1e-5
# ART-V decode step vs plain: fp32 max abs (sums in another order); bf16
# y within tol * (1 + |plain|), k_new and v_new within one bf16 ulp of
# max(|plain|, 1): the kernel rounds h, the probabilities and the MLP
# activations at the plain version's places, and a last-bit difference of
# an fp32 sum flips one rounding, which moves later values by about 1e-4
DECODE_TOL = {'float32': 1e-4, 'bfloat16': 2e-2}
# bf16 through 12 random blocks: such flips grow, and moving x by one fp32
# ulp alone moves the plain version's own y and k, v about as far as the
# kernels' whole step differs from it (phase_artv_decode prints both), so
# the whole step is held within this * (1 + |plain|) and each block (fed
# the plain version's input) within DECODE_TOL.  On the H100, at this
# script's seeds, the plain version's own move read up to 4.261e-2 at B <=
# 16 and 4.483e-2 at B 64, both kernels' whole step up to 4.497e-2 and
# 4.655e-2; at tests/test_torch_kernels.py's B 64, pos 0 case the
# streaming kernel's went beyond 5e-2.  So B 64 (the max over four times
# the rows) is held at half as much again
DECODE_DEEP_TOL = 5e-2
DECODE_DEEP_TOL_B64 = 7.5e-2
# grid-step probe vs plain, fp32 outputs of bf16 products summed in
# another order
PROBE_TOL = 1e-4
# int8 attention kernel vs plain (disagreement below): the integers are
# the same, and only expf's last bit can move p * 127 across a rounding
# tie (one quantization step of one output over its row sum) or the row
# sum by an ulp.  On the H100, over the card tests' shapes (B16 L565/L629
# packed, L29, L139 D32, L1024; fp32 and bf16; three seeds each), the
# kernel read at most 0.405 steps, a mean of at most 0.00185 steps and, in
# bf16, at most 0.098 of the outputs differing; the unquantized function
# (and the bf16 kernel) on the same inputs read at least 0.535 steps, a
# mean of at least 0.0333 steps and 0.879 differing.  So a kernel passes
# within these limits, and the unquantized function, which the checks
# compute beside it, must not
INT8_MAX_STEPS = 0.5
INT8_MEAN_STEPS = 0.005
INT8_DIFFER_SHARE_BF16 = 0.25
# int8 serving vs the bf16 model (the JAX package's own gates,
# tests/test_int8.py): backbone logits on one forward, and the int8
# decoder against the unquantized one on the same ids (applied site by
# site: _int8_decoder_checks says why)
INT8_LOGITS_COS = 0.99
INT8_ARGMAX_AGREE = 0.9
INT8_DECODE_MEAN = 0.02
INT8_DECODE_MAX = 0.2

# NVIDIA H100 SXM peaks (data sheet, dense): the bounds of the kernels line
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bf16': 989e12, 'fp32': 67e12, 'int8': 1979e12}


def bound(nbytes: float, flops: float, kind: str):
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def reset_counts():
    from mmvid_tpu_torch.breakdown import KERNELS
    for mod in KERNELS.values():
        mod.launches = 0


def read_counts():
    from mmvid_tpu_torch.breakdown import KERNELS
    return {name: mod.launches for name, mod in KERNELS.items()}


def expected(**launches):
    """Launch counts of a path: the given kernels, every other one 0."""
    from mmvid_tpu_torch.breakdown import KERNELS
    return dict(dict.fromkeys(KERNELS, 0), **launches)


def fail(msg: str):
    print(f'FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


# device cycles that a timed run waits behind (about 2.5 ms), so the host
# queues its calls meanwhile and their host time stays out of the reading
HOST_AHEAD_CYCLES = 5_000_000


def cuda_time_ms(fn, calls: int = 20, reps: int = 5,
                 warmup: int = 3) -> float:
    """Device time per call, in ms: CUDA events around ``calls``
    back-to-back calls queued behind a device-side wait (so the host's
    launch overhead stays out of the device time, also for a call shorter
    than its host work), over ``calls``; median of ``reps``."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(HOST_AHEAD_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this smoke test needs a '
             'CUDA device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f'[device] torch {torch.__version__} cuda {torch.version.cuda} '
          f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}',
          flush=True)
    return smi


def phase_build():
    from mmvid_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    print(f'[build] {time.perf_counter() - t0:.2f} s', flush=True)


def _attention_inputs(b, l, h, d, dtype, packed, seed):
    """q, k, v [B, L, H, D] on the card: contiguous, or (packed) strided
    views of one [B, L, 3 * H * D] projection, the main path's layout
    (models/clip.py)."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(seed)
    if packed:
        qkv = torch.randn((b, l, 3 * h * d), generator=g, device='cuda'
                          ).to(dtype)
        return [qkv[..., i * h * d:(i + 1) * h * d].view(b, l, h, d)
                for i in range(3)]
    return [torch.randn((b, l, h, d), generator=g, device='cuda').to(dtype)
            for _ in range(3)]


def disagreement(out, ref, v) -> dict:
    """How outputs ``out`` of the int8 attention differ from its plain
    version's ``ref`` on the same q, k, ``v``: the max abs difference, the
    share of outputs that differ at all, and in quantization steps the
    largest and the mean difference and the share beyond one step.  One
    step is what one p8 rounding can move an output by: vs = max|v| / 127
    of its (batch, head), over a row sum of at least 1, plus a rounding of
    the output dtype (eps * |ref|)."""
    import torch
    diff = (out.float() - ref.float()).abs()
    step = (v.float().abs().amax(dim=(1, 3), keepdim=True) / 127.0
            + torch.finfo(out.dtype).eps * ref.float().abs())
    steps = diff / step
    return {'max_abs_err': diff.max().item(),
            'differ_share': (diff > 0).float().mean().item(),
            'max_steps': steps.max().item(),
            'mean_steps': steps.mean().item(),
            'beyond_one_step_share': (steps > 1).float().mean().item()}


def int8_agrees(dis: dict, dtype) -> bool:
    """``disagreement``'s reading within the int8 limits: at most
    INT8_MAX_STEPS anywhere, INT8_MEAN_STEPS on average and, for bf16
    outputs, at most INT8_DIFFER_SHARE_BF16 of them differing (fp32
    outputs differ in their last bits wherever the row sums do)."""
    import torch
    return (dis['max_steps'] <= INT8_MAX_STEPS
            and dis['mean_steps'] <= INT8_MEAN_STEPS
            and (dtype != torch.bfloat16
                 or dis['differ_share'] <= INT8_DIFFER_SHARE_BF16))


def _set_attn_bf16(on: bool):
    if on:
        os.environ['MMVID_ATTN_BF16'] = '1'
    else:
        os.environ.pop('MMVID_ATTN_BF16', None)


def phase_attention():
    """The attention kernels against their plain version with
    MMVID_ATTN_BF16 off and on: fp32 (the CUDA-core kernel, TF32 off) and
    bf16 (the tensor-core kernel) on contiguous q, k, v at each path's
    sequence and mask_prev rows (text+mask L 629, flagship L 565, tiny L
    139); bf16 on packed strided views with mask_prev and causal masks, D
    64 and 32.  Fails beyond ATTN_TOL, or where the default bf16 route
    differs from the plain version in more than ATTN_DIFFER_MAX of its
    outputs.  Times the bf16 kernel (both variants), the plain version and
    ``F.scaled_dot_product_attention`` with the same float mask on the
    main path's packed views at L 629 and L 565, and the fp32 kernel."""
    import torch
    from mmvid_tpu_torch.models.clip import build_attention_mask
    from mmvid_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain = fp32

    def check(tag, q, k, v, mask, bf16p):
        _set_attn_bf16(bf16p)
        d = q.shape[-1]
        out = A.fused_attention_blhd(q, k, v, mask)
        ref = A.attention_reference(q, k, v, mask, d ** -0.5, bf16p)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        differ = (out != ref).float().mean().item()
        name = str(q.dtype).split('.')[-1]
        tol = ATTN_TOL[(name, bf16p)]
        variant = 'bf16 probabilities' if bf16p else 'default'
        print(f'[attention] {tag} {name} {variant}: max abs err {err:.3e} '
              f'(tol {tol}), outputs differing from plain {differ:.4f}',
              flush=True)
        if not err <= tol:
            fail(f'attention {tag} {name} {variant}: max abs err {err} > '
                 f'{tol}')
        if name == 'bfloat16' and not bf16p and differ > ATTN_DIFFER_MAX:
            fail(f'attention {tag}: {differ} of the outputs differ from '
                 f'plain (> {ATTN_DIFFER_MAX})')
        return err, differ

    fp32_rows = {}
    for b, l, h, d, idx in ((16, 629, 12, 64, (115, 116)),
                            (16, 565, 12, 64, (51, 52)),
                            (16, 139, 2, 32, (9, 10))):
        mask = build_attention_mask(l, 'mask_prev', index=idx, device='cuda')
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _attention_inputs(b, l, h, d, dtype, False, l)
            for bf16p in (False, True):
                err, _ = check(f'B={b} L={l} H={h} D={d} contiguous', q, k,
                               v, mask, bf16p)
                if dtype == torch.float32 and not bf16p and l != 139:
                    _set_attn_bf16(False)
                    ms = cuda_time_ms(lambda: A.fused_attention_blhd(
                        q, k, v, mask))
                    fp32_rows[l] = {'max_abs_err': err, 'ms': ms}
    for b, l, h, d, kind, idx in ((16, 629, 12, 64, 'mask_prev', (115, 116)),
                                  (16, 565, 12, 64, 'mask_prev', (51, 52)),
                                  (16, 626, 12, 64, 'causal', None),
                                  (16, 139, 2, 32, 'mask_prev', (9, 10)),
                                  (16, 139, 2, 32, 'causal', None)):
        mask = build_attention_mask(l, kind, index=idx, device='cuda')
        q, k, v = _attention_inputs(b, l, h, d, torch.bfloat16, True, l + 1)
        for bf16p in (False, True):
            check(f'B={b} L={l} H={h} D={d} packed {kind}', q, k, v, mask,
                  bf16p)

    # times on the main path's inputs: packed bf16 views, mask_prev
    rows = {}
    for b, l, h, d, idx in ((16, 629, 12, 64, (115, 116)),
                            (16, 565, 12, 64, (51, 52))):
        mask = build_attention_mask(l, 'mask_prev', index=idx, device='cuda')
        q, k, v = _attention_inputs(b, l, h, d, torch.bfloat16, True, l + 2)
        # one PyTorch call for the same function: [B, H, L, D] views and
        # the same additive mask in q's dtype
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mt = mask.to(torch.bfloat16)
        lib_ms = cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mt))
        nbytes = 4 * b * l * h * d * 2 + l * l * 4
        bms, by = bound(nbytes, 4 * b * h * l * l * d, 'bf16')
        for bf16p in (False, True):
            err, differ = check(f'B={b} L={l} H={h} D={d} packed mask_prev '
                                f'(timed)', q, k, v, mask, bf16p)
            _set_attn_bf16(bf16p)
            ms = cuda_time_ms(lambda: A.fused_attention_blhd(q, k, v, mask))
            plain_ms = cuda_time_ms(lambda: A.attention_reference(
                q, k, v, mask, d ** -0.5, bf16p))
            rows[(l, bf16p)] = {'max_abs_err': err, 'differ_share': differ,
                                'ms': ms, 'plain_ms': plain_ms,
                                'library_ms': lib_ms, 'bound_ms': bms,
                                'bound_by': by}
            print(f'[attention] B={b} L={l} H={h} D={d} bfloat16 '
                  f'{"bf16 probabilities" if bf16p else "default"}: kernel '
                  f'{ms:.4f} ms plain {plain_ms:.4f} ms sdpa {lib_ms:.4f} ms '
                  f'bound {bms:.4f} ms ({by})', flush=True)
            if not ms < lib_ms:
                print(f'[attention] note: the kernel is not faster than '
                      f'sdpa at L={l}', flush=True)
    _set_attn_bf16(False)
    print(f'[attention] fp32 CUDA-core kernel: L629 '
          f'{fp32_rows[629]["ms"]:.4f} ms, L565 {fp32_rows[565]["ms"]:.4f} '
          f'ms', flush=True)
    return rows, fp32_rows


def _set_attn_int8(on: bool):
    if on:
        os.environ['MMVID_ATTN_INT8'] = '1'
    else:
        os.environ.pop('MMVID_ATTN_INT8', None)


def phase_attention_int8():
    """MMVID_ATTN_INT8=1: the s8 kernel against attention_int8_reference
    at the main paths' shapes, B16 H12 D64 bf16 on the packed strided
    views with mask_prev rows (flagship L 565, text+mask L 629), given the
    mask as the models give it (``models/clip.py::attention_mask``: the
    fp32 mask and its compact form, which the kernel reads): the compact
    form equal to the dense mask; within the int8 limits
    (``int8_agrees``), while two controls on the same inputs, the
    unquantized function (``attention_reference``) and the bf16 kernel,
    must fall outside them; two calls bitwise equal, and equal to the call
    that reads the fp32 mask; two launches a call (the operand pass and
    the attention); kernel (with the compact mask, and with the fp32 mask
    alone), plain and, as context only (it computes the bf16 function, not
    this one), ``F.scaled_dot_product_attention`` on the same views and
    mask."""
    import torch
    from mmvid_tpu_torch.models.clip import attention_mask
    from mmvid_tpu_torch.ops import attention as A
    from mmvid_tpu_torch.ops import attention_int8 as A8

    rows = {}
    try:
        for b, l, h, d, idx in ((16, 565, 12, 64, (51, 52)),
                                (16, 629, 12, 64, (115, 116))):
            masks = attention_mask(l, 'mask_prev', index=idx, device='cuda')
            mask = masks.dense
            if not torch.equal(masks.compact.dense(), mask):
                fail(f'the compact mask differs from the dense one at L={l}')
            q, k, v = _attention_inputs(b, l, h, d, torch.bfloat16, True,
                                        l + 3)
            bf16_kernel = A.fused_attention_blhd(q, k, v, mask)
            _set_attn_int8(True)
            before = (A.launches, A8.launches)
            out = A.fused_attention_blhd(q, k, v, masks)
            again = A.fused_attention_blhd(q, k, v, masks)
            launched = (A.launches - before[0], A8.launches - before[1])
            dense_read = A.fused_attention_blhd(q, k, v, mask)
            ref = A8.attention_int8_reference(q, k, v, mask, d ** -0.5)
            torch.cuda.synchronize()
            same = torch.equal(out, again)
            same_dense = torch.equal(out, dense_read)
            dis = disagreement(out, ref, v)
            controls = {
                'unquantized': disagreement(A.attention_reference(
                    q, k, v, mask, d ** -0.5), ref, v),
                'bf16_kernel': disagreement(bf16_kernel, ref, v)}
            ms = cuda_time_ms(lambda: A.fused_attention_blhd(q, k, v, masks))
            ms_dense = cuda_time_ms(lambda: A.fused_attention_blhd(q, k, v,
                                                                   mask))
            plain_ms = cuda_time_ms(lambda: A8.attention_int8_reference(
                q, k, v, mask, d ** -0.5), calls=5, reps=3)
            _set_attn_int8(False)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            mt = mask.to(torch.bfloat16)
            sdpa_ms = cuda_time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mt))
            # q, k, v read once, out written once, the mask once
            nbytes = 4 * b * l * h * d * 2 + l * l * 4
            bms, by = bound(nbytes, 4 * b * h * l * l * d, 'int8')
            rows[l] = dict(dis, bitwise_repeat=same,
                           equal_with_fp32_mask=same_dense, ms=ms,
                           ms_fp32_mask=ms_dense, plain_ms=plain_ms,
                           library_ms=None, sdpa_bf16_ms_context=sdpa_ms,
                           bound_ms=bms, bound_by=by, controls=controls)
            print(f'[attention_int8] B={b} L={l} H={h} D={d} bfloat16 '
                  f'packed mask_prev: max abs err {dis["max_abs_err"]:.3e}, '
                  f'max {dis["max_steps"]:.4f} steps (bound '
                  f'{INT8_MAX_STEPS}), mean {dis["mean_steps"]:.3e} steps '
                  f'(bound {INT8_MEAN_STEPS}), outputs differing '
                  f'{dis["differ_share"]:.6f} (bound '
                  f'{INT8_DIFFER_SHARE_BF16}); controls, which must fall '
                  'outside: ' + ', '.join(
                      f'{n} max {c["max_steps"]:.4f} mean '
                      f'{c["mean_steps"]:.4f} differing '
                      f'{c["differ_share"]:.4f}'
                      for n, c in controls.items())
                  + f'; two calls bitwise equal {same}, equal to the fp32 '
                  f'mask\'s call {same_dense}; launches (bf16, int8) '
                  f'{launched}; kernel {ms:.4f} ms (fp32 mask read: '
                  f'{ms_dense:.4f} ms) plain {plain_ms:.4f} ms (sdpa bf16, '
                  f'another function: {sdpa_ms:.4f} ms) bound {bms:.4f} ms '
                  f'({by})', flush=True)
            if launched != (0, 4):
                fail(f'int8 attention launches {launched} != (0, 4)')
            if not (same and same_dense and int8_agrees(dis, out.dtype)):
                fail(f'int8 attention kernel disagrees with plain at L={l}')
            if any(int8_agrees(c, out.dtype) for c in controls.values()):
                fail(f'the int8 limits pass an unquantized control at L={l}')
    finally:
        _set_attn_int8(False)
    return rows


def _tv(p, q):
    return 0.5 * (p - q).abs().sum().item()


def phase_sample_head():
    import torch
    from mmvid_tpu_torch.ops import sample_head as S

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain = fp32
    dev = torch.device('cuda')
    m, d, v = 8192, 768, 1024
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((m, d), generator=g, device=dev) * 2 + 0.5
    ln_w = 1 + 0.1 * torch.randn((d,), generator=g, device=dev)
    ln_b = 0.1 * torch.randn((d,), generator=g, device=dev)
    # logit std about 3: a peaked distribution with tens of likely tokens
    w = (0.108 * torch.randn((d, v), generator=g, device=dev)).bfloat16()
    b = 0.1 * torch.randn((v,), generator=g, device=dev)

    # temp 0: Y must be the plain softmax probability of the chosen token
    for wd in (w.float(), w):
        y, tok = S.fused_sample_head(x, ln_w, ln_b, wd, b, 0.0, g)
        probs = torch.softmax(S.head_logits(x, ln_w, ln_b, wd, b), -1)
        y_ref = probs.gather(1, tok[:, None])[:, 0]
        torch.cuda.synchronize()
        if not (tok.min() >= 0 and tok.max() < v):
            fail('sample head: token out of range')
        y_err = (y - y_ref).abs().max().item()
        tol = Y_TOL[str(wd.dtype).split('.')[-1]]
        print(f'[sample_head] M={m} D={d} V={v} W {wd.dtype} temp=0: max '
              f'|Y - p(tok)| {y_err:.3e} (tol {tol})', flush=True)
        if not y_err <= tol:
            fail(f'sample head Y error {y_err} > {tol}')

    # distribution over 65536 rows that share one logits row
    n = 65536
    xr = x[:1].expand(n, d).contiguous()
    p_row = probs[0]
    hists = {}
    for temp in (0.0, 1.0):
        _, tk = S.fused_sample_head(xr, ln_w, ln_b, w, b, temp, g)
        g1 = S.gumbel((n, v), g, dev)
        g2 = S.gumbel((n, v), g, dev)
        _, tp = S.sample_head_reference(xr, ln_w, ln_b, w, b, temp, g1, g2)
        hists[temp] = (torch.bincount(tk, minlength=v).float() / n,
                       torch.bincount(tp, minlength=v).float() / n)
    tv0 = _tv(hists[0.0][0], p_row)
    tv0_plain = _tv(hists[0.0][1], p_row)
    tv1 = _tv(hists[1.0][0], hists[1.0][1])
    print(f'[sample_head] TV(kernel, softmax) at temp 0: {tv0:.4f} '
          f'(plain {tv0_plain:.4f}, bound {TV_EXACT_BOUND}); '
          f'TV(kernel, plain) at temp 1: {tv1:.4f} '
          f'(bound {TV_TWO_SAMPLE_BOUND})', flush=True)
    if not (tv0 <= TV_EXACT_BOUND and tv1 <= TV_TWO_SAMPLE_BOUND):
        fail('sample head token distribution out of bounds')

    # temp 1 against the plain version fed the kernels' own noise (the
    # plain Philox at the same seed): both routes, and each other
    seed = torch.tensor([20260516], dtype=torch.int64, device=dev)
    g1, g2 = S.philox_gumbel(int(seed), m, v, dev)
    y_ref, tok_ref = S.sample_head_reference(x, ln_w, ln_b, w, b, 1.0, g1,
                                             g2)
    toks, philox = {}, {}
    for route in S.ROUTES:
        y, toks[route] = S.sample_head_kernel(x, ln_w, ln_b, w, b, 1.0, seed,
                                              route)
        same = toks[route] == tok_ref
        share = same.float().mean().item()
        y_rel = ((y - y_ref).abs() / y_ref)[same].max().item()
        philox[route] = {'tokens_equal_share': share, 'y_rel_err': y_rel}
        print(f'[sample_head] M={m} temp 1, {route} kernel vs plain fed '
              f'philox_gumbel at one seed: tokens equal on {share:.6f} of '
              f'rows (bound {HEAD_TOKEN_SHARE}), Y relative error '
              f'{y_rel:.3e} on those (tol {HEAD_Y_REL_TOL})', flush=True)
        if not (share >= HEAD_TOKEN_SHARE and y_rel <= HEAD_Y_REL_TOL):
            fail(f'sample head {route} kernel disagrees with plain Philox '
                 f'sampling')
    # the control: the plain version with its logits rounded to bf16 (what
    # a kernel that kept bf16 logits would give); HEAD_Y_REL_TOL must lie
    # below its Y error, or the check could not tell such a kernel apart
    noised = S.head_logits(x, ln_w, ln_b, w, b).bfloat16().float() + g1
    y_ctrl = torch.exp(noised.gather(1, tok_ref[:, None])[:, 0]
                       - torch.logsumexp(noised, -1))
    ctrl = ((y_ctrl - y_ref).abs() / y_ref).max().item()
    del noised
    print(f'[sample_head] M={m} temp 1, control (plain with bf16 logits): Y '
          f'relative error {ctrl:.3e} (must exceed {HEAD_Y_REL_TOL})',
          flush=True)
    if not ctrl > HEAD_Y_REL_TOL:
        fail('the sample head\'s Y tolerance does not tell bf16 logits apart')
    cross = (toks['wgmma'] == toks['cuda_cores']).float().mean().item()
    print(f'[sample_head] tensor-core vs CUDA-core kernel at one seed: '
          f'tokens equal on {cross:.6f} of rows', flush=True)
    if not cross >= HEAD_TOKEN_SHARE:
        fail('the two sample-head kernels disagree at one seed')

    # in turns: tensor cores, CUDA cores, CUDA cores, tensor cores
    t = {route: [] for route in S.ROUTES}
    for route in ('wgmma', 'cuda_cores', 'cuda_cores', 'wgmma'):
        t[route].append(cuda_time_ms(lambda: S.sample_head_kernel(
            x, ln_w, ln_b, w, b, 1.0, seed, route)))
    ms, ms_cores = min(t['wgmma']), min(t['cuda_cores'])

    def plain():
        g1, g2 = S.philox_gumbel(int(seed), m, v, dev)
        return S.sample_head_reference(x, ln_w, ln_b, w, b, 1.0, g1, g2)

    plain_ms = cuda_time_ms(plain, calls=5, reps=3)
    print(f'[sample_head] M={m} bf16 W: tensor-core kernel {ms:.4f} ms '
          f'({t["wgmma"]}), CUDA-core kernel {ms_cores:.4f} ms '
          f'({t["cuda_cores"]}), plain (Philox noise included) '
          f'{plain_ms:.4f} ms', flush=True)
    # x fp32 read once, W bf16 read once, Y and tok written once
    nbytes = m * d * 4 + d * v * 2 + (2 * d + v) * 4 + m * (4 + 8)
    extra = {'philox': philox, 'bf16_logits_control_y_rel_err': ctrl,
             'kernels_tokens_equal_share': cross,
             'cuda_cores_route': {'source':
                                  'mmvid_tpu_torch/csrc/sample_head.cu',
                                  'ms': ms_cores,
                                  'ms_all': t['cuda_cores']},
             'ms_all': t['wgmma']}
    return (y_err, ms, plain_ms, None) + bound(nbytes, 2 * m * d * v,
                                               'bf16'), extra


def phase_codebook():
    """Nearest-code kernel vs plain at the paths' shapes, D 256, K 1024:
    M 1024 (16 control frames x 64 latents: text+mask, ART-V's speculative
    path), 4096 (the image_and_video recipe's 4 control frames) and 8192
    (one video's 8 frames: recon_images, the VQGAN's training encode).
    Returns the M 1024 row and the times at every M."""
    import torch
    from mmvid_tpu_torch.ops import codebook as C

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    d, k = 256, 1024
    at_m = {}
    for m in (1024, 4096, 8192):
        g = torch.Generator(device=dev).manual_seed(11)
        z = torch.randn((m, d), generator=g, device=dev)
        spread = torch.randn((k, d), generator=g, device=dev)
        init = (torch.rand((k, d), generator=g, device=dev) * 2 - 1) / k

        def gap(cb, idx):
            """best score - chosen score, in fp64, per row."""
            s = z.double() @ cb.double().t() - 0.5 * cb.double().square(
            ).sum(-1)[None]
            return s.max(-1).values - s.gather(1, idx[:, None])[:, 0]

        idx = C.nearest_codebook_indices(z, spread)
        ref = C.nearest_codebook_reference(z, spread)
        torch.cuda.synchronize()
        n_diff = int((idx != ref).sum())
        idx0 = C.nearest_codebook_indices(z, init)
        gaps = torch.cat([gap(spread, idx), gap(init, idx0)])
        err = gaps.max().item()
        ms = cuda_time_ms(lambda: C.nearest_codebook_indices(z, init))
        plain_ms = cuda_time_ms(
            lambda: C.nearest_codebook_reference(z, init))
        nbytes = (m * d + k * d) * 4 + m * 8
        b_ms, b_by = bound(nbytes, 2 * m * k * d, 'fp32')
        print(f'[codebook] M={m} D={d} K={k} fp32: randn codebook ids '
              f'differing from plain {n_diff}; max score gap to the best '
              f'(randn and random-init codebooks) {err:.3e} (tol '
              f'{CODE_GAP_TOL}); kernel {ms:.4f} ms plain {plain_ms:.4f} '
              f'ms bound {b_ms:.4f} ms ({b_by})', flush=True)
        if n_diff or not (idx.min() >= 0 and idx.max() < k):
            fail(f'codebook kernel ids differ from plain in {n_diff} rows '
                 f'at M={m}')
        if not err <= CODE_GAP_TOL:
            fail(f'codebook kernel score gap {err} > {CODE_GAP_TOL} at '
                 f'M={m}')
        at_m[m] = {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                   'bound_ms': b_ms, 'bound_by': b_by}
    row = at_m[1024]
    return ((row['max_abs_err'], row['ms'], row['plain_ms'], None,
             row['bound_ms'], row['bound_by']),
            {f'M{m}': at_m[m] for m in (4096, 8192)})


def phase_ln_qkv():
    """Fused LN+QKV kernel vs plain at the text+mask and flagship
    backbones' shapes (M = 16 x 629 and 16 x 565 rows, D 768, packed W
    [2304, 768]), bf16, timed beside the gate-off pair ``F.layer_norm`` +
    ``F.linear``; fp32 must raise on the card without a launch.  Returns
    the kernels-line row at M 16 x 629 and the readings at both."""
    import torch
    import torch.nn.functional as F
    from mmvid_tpu_torch.ops import fused_ln_qkv as Q

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    d = 768
    at = {}
    for m in (16 * 629, 16 * 565):
        g = torch.Generator(device=dev).manual_seed(13)
        x = torch.randn((m, d), generator=g, device=dev) * 2 + 0.5
        ln_w = 1 + 0.1 * torch.randn((d,), generator=g, device=dev)
        ln_b = 0.1 * torch.randn((d,), generator=g, device=dev)
        w = torch.randn((3 * d, d), generator=g, device=dev) * d ** -0.5
        b = 0.1 * torch.randn((3 * d,), generator=g, device=dev)
        before = Q.launches
        try:
            Q.fused_ln_qkv(x, ln_w, ln_b, w, b)
            fail('LN+QKV kernel accepted fp32 on the card')
        except ValueError:
            pass
        if Q.launches != before:
            fail('LN+QKV counted a launch for a refused fp32 call')
        xd, wd, bd = x.bfloat16(), w.bfloat16(), b.bfloat16()
        out = Q.fused_ln_qkv(xd, ln_w, ln_b, wd, bd)
        ref = Q.ln_qkv_reference(xd, ln_w, ln_b, wd, bd)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        tol = LNQKV_TOL
        within = bool((diff <= tol * (1 + ref.float().abs())).all())
        ms = cuda_time_ms(lambda: Q.fused_ln_qkv(xd, ln_w, ln_b, wd, bd))
        plain_ms = cuda_time_ms(lambda: Q.ln_qkv_reference(xd, ln_w, ln_b,
                                                           wd, bd))
        # what the backbone runs with the gate off
        unfused_ms = cuda_time_ms(lambda: F.linear(F.layer_norm(
            xd.float(), (d,), ln_w, ln_b, 1e-5).bfloat16(), wd, bd))
        nbytes = (m * d + 3 * d * d + 3 * d + 3 * m * d) * 2 + 2 * d * 4
        bms, by = bound(nbytes, 2 * m * d * 3 * d, 'bf16')
        at[m] = {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                 'layer_norm_linear_ms': unfused_ms, 'bound_ms': bms,
                 'bound_by': by}
        print(f'[ln_qkv] M={m} D={d} bfloat16: max abs err {err:.3e} '
              f'(|plain| max {ref.float().abs().max().item():.3f}; within '
              f'{tol} * (1 + |plain|): {within}) kernel {ms:.4f} ms plain '
              f'{plain_ms:.4f} ms unfused F.layer_norm+F.linear '
              f'{unfused_ms:.4f} ms bound {bms:.4f} ms ({by}); fp32 '
              f'refused', flush=True)
        if not within:
            fail(f'LN+QKV: error beyond {tol} * (1 + |plain|) at M={m}')
        if not ms < unfused_ms:
            print(f'[ln_qkv] note: the kernel is not faster than '
                  f'F.layer_norm + F.linear at M={m}', flush=True)
    r = at[16 * 629]
    row = (r['max_abs_err'], r['ms'], r['plain_ms'], None, r['bound_ms'],
           r['bound_by'])
    return row, at


def decode_bound(n_layers, b, d, pos, itemsize=2):
    """(ms, 'bytes'|'operations') of one ART-V step: every weight read
    once, the live cache rows < pos read once, x read and y, k_new, v_new
    written once; the products and the attention's operations."""
    nbytes = (n_layers * (12 * d * d * itemsize + 2 * b * pos * d * itemsize
                          + 2 * b * d * itemsize + 14 * d * 4)
              + 2 * b * d * 4)
    flops = n_layers * (2 * b * 12 * d * d + 4 * b * (pos + 1) * d)
    return bound(nbytes, flops, 'bf16' if itemsize == 2 else 'fp32')


def _decode_errs(got, want):
    """(max |dy|, max |dy| / (1 + |plain y|), max k/v error in bf16 ulps of
    max(|plain|, 1), max k/v error / (1 + |plain|), max |dk|, |dv|)."""
    import torch
    dy = (got[0] - want[0]).abs()
    ulps = rel = kv = 0.0
    for g, w in zip(got[1:], want[1:]):
        g, w = g.float(), w.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1.0)))
                         - 7)
        ulps = max(ulps, ((g - w).abs() / ulp).max().item())
        rel = max(rel, ((g - w).abs() / (1 + w.abs())).max().item())
        kv = max(kv, (g - w).abs().max().item())
    return (dy.max().item(), (dy / (1 + want[0].abs())).max().item(), ulps,
            rel, kv)


def _decode_ok(errs, dtype):
    err, rel, ulps, kv_rel, kv = errs
    if dtype == 'float32':
        return max(err, kv) <= DECODE_TOL['float32']
    return rel <= DECODE_TOL['bfloat16'] and ulps <= 1.0


def _nan_rows(ck, cv, pos):
    """The caches with every row >= pos set to NaN (the kernels must not
    read them)."""
    ck, cv = ck.clone(), cv.clone()
    ck[:, :, pos:] = float('nan')
    cv[:, :, pos:] = float('nan')
    return ck, cv


def _decode_full_width(AD, x, p, ck, cv, pos, heads, ws, kernel):
    """(whole-step errors, worst block-by-block errors, bitwise equal over
    two calls, within tolerance) of a bf16 kernel at full width against
    the plain version, the caches' rows >= pos NaN."""
    import torch
    ckn, cvn = _nan_rows(ck, cv, pos)
    want = AD.decode_token_step_reference(x, p, ckn, cvn, pos, heads)
    got = [t.clone() for t in AD.decode_token_step(
        x, p, ckn, cvn, pos, heads, ws, kernel)]
    again = AD.decode_token_step(x, p, ckn, cvn, pos, heads, ws, kernel)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    whole = _decode_errs(got, want)
    blocks, xi = [], x
    for i in range(p.w_qkv.shape[0]):
        args = (AD.layer_params(p, i), ckn[i:i + 1], cvn[i:i + 1], pos,
                heads)
        ref = AD.decode_token_step_reference(xi, *args)
        blocks.append(_decode_errs(AD.decode_token_step(
            xi, *args, kernel=kernel), ref))
        xi = ref[0]
    torch.cuda.synchronize()
    worst = tuple(max(e[j] for e in blocks) for j in range(5))
    ok = (max(whole[1], whole[3]) <= _deep_tol(x.shape[0])
          and all(_decode_ok(e, 'bfloat16') for e in blocks) and same)
    return whole, worst, same, ok


def _deep_tol(b):
    return DECODE_DEEP_TOL_B64 if b > 16 else DECODE_DEEP_TOL


def _plain_own(AD, x, p, ck, cv, pos, heads):
    """How far the plain version moves itself, by _decode_errs, when x
    moves by at most one fp32 ulp (what DECODE_DEEP_TOL allows for)."""
    want = AD.decode_token_step_reference(x, p, ck, cv, pos, heads)
    return _decode_errs(AD.decode_token_step_reference(
        x * (1 + 1e-7), p, ck, cv, pos, heads), want)


def phase_artv_decode():
    """The ART-V decode step's kernels vs the plain version: fp32 and bf16
    at a small shape (2 layers, D 128, 2 heads, B 2, W 256) at pos 1, 64
    and 200 on the default kernel (the phased one); at full width (12
    layers, D 768, 12 heads, caches W 626 from a seed) fp32 at pos 370;
    both bf16 kernels (the phased one, the route, and the streaming one,
    forced) at B 1, 5 and 64 at pos 0 and 1, beside the plain version's
    own move under a one-ulp move of x, and at B 16, pos 115 (the first
    step), 370 (the mean) and 625 (the last); block by block and whole,
    with the cache rows >= pos NaN and two calls bitwise equal, timed in
    turns at B 16; both at B 64, pos 370, timed."""
    import torch
    from mmvid_tpu_torch.ops import artv_decode as AD

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    cases = [(2, 2, 256, 128, 2, dt, pos)
             for dt in (torch.float32, torch.bfloat16) for pos in (1, 64, 200)]
    cases.append((12, 16, 626, 768, 12, torch.float32, 370))
    for n_layers, b, w, d, heads, dtype, pos in cases:
        g = torch.Generator(device=dev).manual_seed(pos)
        x, p, ck, cv = AD.random_inputs(n_layers, b, w, d, dtype, g, dev)
        got = AD.decode_token_step(x, p, ck, cv, pos, heads)
        want = AD.decode_token_step_reference(x, p, ck, cv, pos, heads)
        torch.cuda.synchronize()
        errs = _decode_errs(got, want)
        name = str(dtype).split('.')[-1]
        ok = _decode_ok(errs, name)
        print(f'[artv_decode] L{n_layers} B{b} W{w} D{d} H{heads} {name} pos '
              f'{pos} (phased kernel): max abs err y {errs[0]:.3e} '
              f'({errs[1]:.3e} of 1 + |plain|), k/v {errs[4]:.3e} '
              f'({errs[2]:.2f} bf16 ulps) (within tolerance: {ok})',
              flush=True)
        if not ok:
            fail(f'ART-V decode L{n_layers} {name} pos {pos} beyond '
                 f'tolerance')
    n_layers, w, d, heads = 12, 626, 768, 12
    edge = {}
    for b in (1, 5, 64):
        g = torch.Generator(device=dev).manual_seed(100 + b)
        x, p, ck, cv = AD.random_inputs(n_layers, b, w, d, torch.bfloat16,
                                        g, dev)
        ws = AD.DecodeWorkspace(p, b, heads)
        for pos in (0, 1):
            own = _plain_own(AD, x, p, ck, cv, pos, heads)
            row = {'plain_own_rel_err': own[1],
                   'plain_own_kv_rel_err': own[3]}
            for kernel in AD.KERNELS:
                whole, worst, same, ok = _decode_full_width(
                    AD, x, p, ck, cv, pos, heads, ws, kernel)
                row[kernel] = {'rel_err': whole[1], 'kv_rel_err': whole[3],
                               'block_kv_ulps': worst[2],
                               'bitwise_repeat': same}
                print(f'[artv_decode] L12 B{b} W626 D768 H12 bfloat16 pos '
                      f'{pos} ({kernel} kernel, rows >= pos NaN): whole step '
                      f'y {whole[1]:.3e}, k/v {whole[3]:.3e} of 1 + |plain| '
                      f'(tol {_deep_tol(b)}; the plain version with x '
                      f'moved by one fp32 ulp: y {own[1]:.3e}, k/v '
                      f'{own[3]:.3e}); block by block y {worst[1]:.3e}, k/v '
                      f'{worst[2]:.2f} bf16 ulps; two calls bitwise equal: '
                      f'{same} (within tolerance: {ok})', flush=True)
                if not ok:
                    fail(f'ART-V decode bf16 {kernel} B{b} pos {pos} beyond '
                         f'tolerance or not repeatable')
            edge[f'B{b}_pos{pos}'] = row
    g = torch.Generator(device=dev).manual_seed(17)
    b = 16
    x, p, ck, cv = AD.random_inputs(n_layers, b, w, d, torch.bfloat16, g,
                                    dev)
    ws = AD.DecodeWorkspace(p, b, heads)
    by_pos = {}
    for pos in (115, 370, 625):
        own = _plain_own(AD, x, p, ck, cv, pos, heads)
        whole, worst, same, ok = _decode_full_width(AD, x, p, ck, cv, pos,
                                                    heads, ws, 'stream')
        pwhole, pworst, psame, pok = _decode_full_width(
            AD, x, p, ck, cv, pos, heads, ws, 'phased')
        # in turns: streaming, phased, phased, streaming
        t = {'stream': [], 'phased': []}
        for kernel in ('stream', 'phased', 'phased', 'stream'):
            t[kernel].append(cuda_time_ms(lambda: AD.decode_token_step(
                x, p, ck, cv, pos, heads, ws, kernel)))
        ms, ms_phased = min(t['stream']), min(t['phased'])
        plain_ms = cuda_time_ms(lambda: AD.decode_token_step_reference(
            x, p, ck, cv, pos, heads), calls=5, reps=3)
        bms, by = decode_bound(n_layers, b, d, pos)
        print(f'[artv_decode] L12 B16 W626 D768 H12 bfloat16 pos {pos}: '
              f'streaming kernel: block by block max abs err y '
              f'{worst[0]:.3e} ({worst[1]:.3e} of 1 + |plain|), k/v '
              f'{worst[2]:.2f} bf16 ulps; whole step y {whole[0]:.3e} '
              f'({whole[1]:.3e}), k/v {whole[3]:.3e} of 1 + |plain|, '
              f'bitwise repeat {same} (within tolerance: {ok}); phased '
              f'kernel: whole y {pwhole[1]:.3e}, blocks {pworst[2]:.2f} '
              f'ulps ({pok}); the plain version with x moved by one fp32 '
              f'ulp: y {own[1]:.3e} of 1 + |plain|, k/v {own[2]:.2f} bf16 '
              f'ulps; streaming {ms:.4f} ms ({t["stream"]}) phased '
              f'{ms_phased:.4f} ms ({t["phased"]}) plain {plain_ms:.4f} ms '
              f'bound {bms:.4f} ms ({by})', flush=True)
        if not (ok and pok):
            fail(f'ART-V decode bf16 full width pos {pos} beyond tolerance '
                 f'or not repeatable')
        # the main path takes the phased kernel: its numbers lead, the
        # streaming kernel's stand beside them
        by_pos[pos] = {'max_abs_err': pwhole[0], 'rel_err': pwhole[1],
                       'block_max_abs_err': pworst[0],
                       'block_kv_ulps': pworst[2], 'bitwise_repeat': psame,
                       'plain_own_rel_err': own[1],
                       'plain_own_kv_ulps': own[2], 'ms': ms_phased,
                       'plain_ms': plain_ms, 'library_ms': None,
                       'bound_ms': bms, 'bound_by': by,
                       'stream': {'ms': ms, 'max_abs_err': whole[0],
                                  'rel_err': whole[1],
                                  'block_kv_ulps': worst[2],
                                  'bitwise_repeat': same}}
    # B 64 at pos 370, where the streaming kernel measured faster (PERF.md;
    # no path runs it there), in turns
    g = torch.Generator(device=dev).manual_seed(64)
    x64, p64, ck64, cv64 = AD.random_inputs(n_layers, 64, w, d,
                                            torch.bfloat16, g, dev)
    ws64 = AD.DecodeWorkspace(p64, 64, heads)
    t = {'stream': [], 'phased': []}
    for kernel in ('stream', 'phased', 'phased', 'stream'):
        t[kernel].append(cuda_time_ms(lambda: AD.decode_token_step(
            x64, p64, ck64, cv64, 370, heads, ws64, kernel)))
    b64 = {'stream_ms': min(t['stream']), 'phased_ms': min(t['phased']),
           'bound_ms': decode_bound(n_layers, 64, d, 370)[0]}
    print(f'[artv_decode] L12 B64 W626 D768 H12 bfloat16 pos 370: streaming '
          f'{b64["stream_ms"]:.4f} ms ({t["stream"]}) phased '
          f'{b64["phased_ms"]:.4f} ms ({t["phased"]}) bound '
          f'{b64["bound_ms"]:.4f} ms', flush=True)
    del x64, p64, ck64, cv64, ws64
    # the wrapper's host time a call (200 launches enqueued, no sync):
    # through a workspace (checked and allocated once, as ar_sample calls
    # it) and without one (checks and allocations every call)
    host = {}
    for tag, wsp in (('workspace', ws), ('no_workspace', None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            AD.decode_token_step(x, p, ck, cv, 370, heads, wsp)
        host[tag] = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
    print(f'[artv_decode] wrapper host time a call at pos 370: '
          f'{host["workspace"]:.4f} ms through a workspace, '
          f'{host["no_workspace"]:.4f} ms without', flush=True)
    mid = by_pos[370]
    return (max(e['max_abs_err'] for e in by_pos.values()), mid['ms'],
            mid['plain_ms'], None, mid['bound_ms'], mid['bound_by']), \
        {'at_pos': by_pos, 'edge_cases': edge, 'b64_pos370': b64,
         'host_ms_per_call': host}


def phase_gridstep():
    """The grid-step probe vs its plain version, and 64 chained calls at
    1, 12 and 192 launches a call: the cost of a launch on this card."""
    import torch
    from mmvid_tpu_torch.ops import gridstep as G

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(19)
    x, w = G.probe_inputs(g, dev)
    wt = G.prepare_weights(w)

    def plain():
        y = x
        for _ in range(G.CALLS):
            y = G.probe_call_reference(y, wt)
        return y

    want = plain()
    outs, times = {}, {}
    for n in G.LAUNCHES_PER_CALL:
        outs[n] = G.probe(x, wt, n)
        times[n] = cuda_time_ms(lambda: G.probe(x, wt, n), calls=3)
    torch.cuda.synchronize()
    err = max((o - want).abs().max().item() for o in outs.values())
    same = all(torch.equal(o, outs[1]) for o in outs.values())
    plain_ms = cuda_time_ms(plain, calls=3)
    n1, n12, n192 = G.LAUNCHES_PER_CALL
    per_launch = (times[n192] - times[n12]) / (G.CALLS * (n192 - n12)) * 1e3
    per_barrier = (times[n12] - times[n1]) / (G.CALLS * (n12 - n1)) * 1e3
    d, layers = G.DIM, G.LAYERS
    nbytes = layers * d * d * 2 + 2 * G.BATCH * d * 4
    bms, by = bound(nbytes, 2 * G.BATCH * d * d * layers * G.CALLS, 'bf16')
    print(f'[gridstep] {G.CALLS} chained calls of {layers} layers, x '
          f'[{G.BATCH}, {d}]: max abs err vs plain {err:.3e} (tol '
          f'{PROBE_TOL}), launch structures bitwise equal: {same}; '
          f'1 launch a call {times[n1]:.4f} ms, {n12} {times[n12]:.4f} ms, '
          f'{n192} {times[n192]:.4f} ms, plain {plain_ms:.4f} ms, bound '
          f'{bms:.4f} ms ({by}); {per_launch:.3f} us per launch, '
          f'{per_barrier:.3f} us per layer launch over a grid barrier',
          flush=True)
    if not (err <= PROBE_TOL and same):
        fail('grid-step probe disagrees with its plain version')
    return (err, times[n1], plain_ms, None, bms, by), {
        'ms_12_launches': times[n12], 'ms_192_launches': times[n192],
        'us_per_launch': per_launch, 'us_per_layer_launch_vs_barrier':
        per_barrier}


def phase_tiny_reference():
    """The tiny model on the card (kernels) against the same weights on the
    CPU (plain versions, the path the CPU tests hold against JAX)."""
    import torch
    from mmvid_tpu_torch import factories

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu, _ = factories.flagship(tiny=True, device='cpu', seed=3)
    gpu, _ = factories.flagship(tiny=True, device='cuda', seed=3)
    cfg = cpu.cfg
    g = torch.Generator().manual_seed(3)
    text = torch.randint(1, 100, (2, cfg.text_seq_len), generator=g)
    tgt = torch.randint(0, 1025, (2, cfg.target_seq_len), generator=g)
    with torch.no_grad():
        ref = cpu.core(text, None, tgt)
        out = gpu.core(text.cuda(), None, tgt.cuda())
        img_ref = cpu.decode_video(tgt.clamp_max(1023))
        img = gpu.decode_video(tgt.clamp_max(1023).cuda())
    errs = [(a.cpu() - r).abs().max().item()
            for a, r in zip(out[:3], ref[:3])]
    img_err = (img.cpu() - img_ref).abs().max().item()
    print(f'[tiny] logits/rel/vid max abs err {errs}, decode {img_err:.3e} '
          f'(tol 1e-3, fp32, TF32 off)', flush=True)
    if not (max(errs) <= 1e-3 and img_err <= 1e-3):
        fail('tiny model on the card disagrees with the CPU')

    # the tiny text+mask model: cvae ids (codebook with spread, in both)
    # and the forward logits with the visual segment
    cpu, _ = factories.flagship(tiny=True, device='cpu', seed=4,
                                use_cvae=True)
    gpu, _ = factories.flagship(tiny=True, device='cuda', seed=4,
                                use_cvae=True)
    spread = torch.randn((1024, 64), generator=g)
    frames = torch.rand((2, 1, 16, 16, 3), generator=g)
    with torch.no_grad():
        for model in (cpu, gpu):
            model.cvae.model.quantize.embedding.weight.copy_(spread)
        ids = cpu.get_image_tokens(frames, which_vae='cvae')
        ids_gpu = gpu.get_image_tokens(frames.cuda(), which_vae='cvae')
        vis = cpu.prepare_visual_tokens(g, frames, vc_mode='mask_8x8',
                                        face_mode='mask')
        ref = cpu.core(text, vis, tgt)
        out = gpu.core(text.cuda(), vis.cuda(), tgt.cuda())
    n_diff = int((ids_gpu.cpu() != ids).sum())
    errs = [(a.cpu() - r).abs().max().item()
            for a, r in zip(out[:3], ref[:3])]
    print(f'[tiny] text+mask: cvae ids differing {n_diff} of '
          f'{ids.numel()}; logits/rel/vid max abs err {errs} (tol 1e-3)',
          flush=True)
    torch.backends.cudnn.allow_tf32 = True
    if n_diff or not max(errs) <= 1e-3:
        fail('tiny text+mask model on the card disagrees with the CPU')


def phase_tiny_artv():
    """The tiny fp32 ART-V on the card against the same weights on the
    CPU, each on its default decode path (the card: the stacked step
    through the decode kernel; the CPU: the per-layer step the CPU tests
    hold against JAX): greedy tokens equal."""
    import torch
    from mmvid_tpu_torch import factories
    from mmvid_tpu_torch.ops import artv_decode as AD

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, _ = factories.artv_tiny(device='cpu', seed=3)
    gpu, _ = factories.artv_tiny(device='cuda', seed=3)
    g = torch.Generator().manual_seed(3)
    text = torch.randint(1, 50, (2, cpu.cfg.text_seq_len), generator=g)
    before = AD.launches
    _, want = cpu.generate_images(torch.Generator().manual_seed(0), text,
                                  temperature=1e-6, decode=False)
    cpu_steps = AD.launches - before
    _, got = gpu.generate_images(
        torch.Generator(device='cuda').manual_seed(0), text.cuda(),
        temperature=1e-6, decode=False)
    steps = AD.launches - before
    n_diff = int((got.cpu() != want).sum())
    print(f'[tiny] ART-V fp32 greedy, default paths: tokens differing card '
          f'vs CPU {n_diff} of {want.numel()} ({steps} decode-kernel steps '
          f'on the card, {cpu_steps} counted on the CPU)', flush=True)
    if n_diff or cpu_steps or steps != cpu.cfg.target_seq_len - 1:
        fail('tiny ART-V on the card disagrees with the CPU')


SPEC_KS = (1, 4, 8)
# the sampled-distribution test of tests/test_artv_spec.py (800 lanes, a
# 32-token vocabulary): the pooled two-sample chi^2 of each position's
# counts (31 degrees of freedom, alpha about 1e-4) and the max TV
# within max(1.3 x the baseline's split-half TV, 0.10)
SPEC_LANES, SPEC_CHI2, SPEC_TV_FACTOR, SPEC_TV_FLOOR = 800, 66.6, 1.3, 0.10


def _marginals(tokens, vocab):
    """[R, N] tokens -> [N, vocab] counts a position."""
    import torch
    return torch.stack([torch.bincount(tokens[:, p], minlength=vocab)
                        for p in range(tokens.shape[1])]).double()


def _chi2(c1, c2):
    """Max over positions of the pooled two-sample chi^2 statistic."""
    n1, n2 = c1.sum(1, keepdim=True), c2.sum(1, keepdim=True)
    pooled = (c1 + c2) / (n1 + n2)
    e1, e2 = n1 * pooled, n2 * pooled
    keep = pooled > 0
    stat = (((c1 - e1) ** 2 / e1.clamp_min(1e-30))
            + ((c2 - e2) ** 2 / e2.clamp_min(1e-30))) * keep
    return stat.sum(1).max().item()


def _tv_counts(c1, c2):
    p, q = c1 / c1.sum(1, keepdim=True), c2 / c2.sum(1, keepdim=True)
    return (0.5 * (p - q).abs().sum(1)).max().item()


def phase_tiny_artv_spec():
    """ART-V's exact speculative decode (``ar_sample_spec``) with the tiny
    fp32 model on the card: greedy tokens equal to ``ar_sample``'s on the
    card's default step (the decode kernel) and with MMVID_ARTV_FUSED=0,
    for k 1, 4 and 8; forced acceptance commits ceil(127 / (k + 1)) chunks
    a lane; and at temperature 1, on a 32-token vocabulary, 800 lanes of
    the speculative path against 800 of the baseline, each drawn from a
    CUDA generator (the chi^2 and TV bounds above)."""
    import dataclasses
    import torch
    from mmvid_tpu_torch import factories
    from mmvid_tpu_torch.models import artv as partv
    from mmvid_tpu_torch.models.artv_spec import ar_sample_spec
    from mmvid_tpu_torch.ops import artv_decode as AD

    torch.backends.cuda.matmul.allow_tf32 = False
    model, _ = factories.artv_tiny(device='cuda', seed=3)
    cfg = model.cfg
    g = torch.Generator().manual_seed(3)
    text = torch.randint(1, 50, (2, cfg.text_seq_len), generator=g).cuda()
    visual = torch.randint(0, cfg.num_image_tokens, (2, cfg.visual_seq_len),
                           generator=g).cuda()
    n_loop = cfg.target_seq_len - 1
    base = {}
    for tag, gate in (('kernel', None), ('per-layer', '0')):
        if gate:
            os.environ['MMVID_ARTV_FUSED'] = gate
        try:
            before = AD.launches
            base[tag] = partv.ar_sample(
                model.core, text, visual,
                torch.Generator(device='cuda').manual_seed(1),
                temperature=1e-6)
            steps = AD.launches - before
        finally:
            os.environ.pop('MMVID_ARTV_FUSED', None)
        if steps != (n_loop if gate is None else 0):
            fail(f'tiny ART-V baseline ({tag}) ran {steps} decode-kernel '
                 f'steps')
    diffs = {}
    for k in SPEC_KS:
        toks, steps = ar_sample_spec(
            model.core, text, visual,
            torch.Generator(device='cuda').manual_seed(2), k,
            temperature=1e-6)
        diffs[k] = {tag: int((toks != b).sum()) for tag, b in base.items()}
        os.environ['MMVID_ARTV_SPEC_FORCE'] = '1'
        try:
            _, forced = ar_sample_spec(
                model.core, text, visual,
                torch.Generator(device='cuda').manual_seed(2), k)
        finally:
            os.environ.pop('MMVID_ARTV_SPEC_FORCE', None)
        want = -(-n_loop // (k + 1))
        print(f'[tiny spec] k={k} fp32 greedy: tokens differing from '
              f'ar_sample {diffs[k]} of {toks.numel()}; chunks {steps.tolist()}'
              f'; forced acceptance {forced.tolist()} chunks (expected '
              f'{want})', flush=True)
        if any(diffs[k].values()):
            fail(f'speculative greedy tokens differ from ar_sample at k={k}')
        if forced.tolist() != [want] * 2:
            fail(f'forced acceptance ran {forced.tolist()} chunks, not {want}')

    # the sampled distribution: 32 tokens, 4 x 4 a frame, 2 frames
    pcfg = dataclasses.replace(cfg, num_image_tokens=32, image_fmap_size=4,
                               image_size=16)
    small = partv.ArtvModel(pcfg, vae=None)
    factories.init_weights(small, torch.Generator().manual_seed(0))
    small = small.cuda().eval()
    g = torch.Generator().manual_seed(7)
    text = torch.randint(1, 50, (1, pcfg.text_seq_len), generator=g).expand(
        SPEC_LANES, -1).cuda()
    visual = torch.randint(0, 32, (1, pcfg.visual_seq_len), generator=g
                           ).expand(SPEC_LANES, -1).cuda()
    os.environ['MMVID_ARTV_FUSED'] = '0'   # 800 lanes: past B5's batch
    try:
        base = partv.ar_sample(small.core, text, visual,
                               torch.Generator(device='cuda').manual_seed(5))
    finally:
        os.environ.pop('MMVID_ARTV_FUSED', None)
    spec, steps = ar_sample_spec(small.core, text, visual,
                                 torch.Generator(device='cuda').manual_seed(6),
                                 4)
    c_base, c_spec = _marginals(base, 32), _marginals(spec, 32)
    chi2 = _chi2(c_base, c_spec)
    half = _tv_counts(_marginals(base[:SPEC_LANES // 2], 32),
                      _marginals(base[SPEC_LANES // 2:], 32))
    cross = _tv_counts(c_base, c_spec)
    tv_bound = max(SPEC_TV_FACTOR * half, SPEC_TV_FLOOR)
    print(f'[tiny spec] k=4 temperature 1, {SPEC_LANES} lanes, 32 tokens: '
          f'chi2 {chi2:.2f} (< {SPEC_CHI2}), TV {cross:.4f} (< {tv_bound:.4f}'
          f', split-half {half:.4f}); tokens a chunk '
          f'{(pcfg.target_seq_len - 1) / steps.double().mean().item():.3f}',
          flush=True)
    if not (chi2 < SPEC_CHI2 and cross < tv_bound):
        fail('the speculative path drifted from the baseline distribution')
    return {'greedy_tokens_differing': diffs, 'chi2': chi2, 'tv': cross,
            'tv_split_half': half}


def report(tag: str, res: dict):
    """Print ``breakdown.measure``'s result: a summary and its JSON."""
    print(f'[{tag}] batch {res["batch"]}, {res["steps"]} steps: '
          f'{res["s_per_batch"]:.4f} s per batch (median of '
          f'{len(res["s_all"])}: {[round(t, 4) for t in res["s_all"]]}), '
          f'{res["frames_per_s"]:.2f} frames/s, peak memory '
          f'{res["peak_memory_bytes"]} B, device idle '
          f'{res["idle_share"]:.4f}', flush=True)
    print(f'[{tag}] breakdown {json.dumps(res)}', flush=True)


def phase_main_path():
    import torch
    from mmvid_tpu_torch import breakdown, generate
    from mmvid_tpu_torch.tokenizer import SimpleTokenizer

    t0 = time.perf_counter()
    model = breakdown.build('flagship')
    tokenizer = SimpleTokenizer()
    torch.cuda.synchronize()
    print(f'[main] flagship built in {time.perf_counter() - t0:.2f} s',
          flush=True)
    cfg = model.cfg
    prompts = breakdown.PROMPTS[:6]
    steps, batch = 20, 4

    def run():
        gen = torch.Generator(device='cuda').manual_seed(0)
        out = list(generate.generate_videos(model, tokenizer, prompts, batch,
                                            gen, mask_predict_steps=steps,
                                            dynamic=False))
        torch.cuda.synchronize()
        return out

    reset_counts()
    out = run()
    counts = read_counts()
    n_batches = -(-len(prompts) // batch)
    want = expected(attention=cfg.clip.layers * steps * n_batches,
                    sample_head=steps * n_batches)
    print(f'[main] launches {counts} (expected {want})', flush=True)
    if counts != want:
        fail(f'launch counts {counts} != {want}')

    sizes = [len(bt.prompts) for bt in out]
    for bt in out:
        vshape = (len(bt.prompts), cfg.num_targets, cfg.image_size,
                  cfg.image_size, 3)
        if tuple(bt.videos.shape) != vshape:
            fail(f'videos {tuple(bt.videos.shape)} != {vshape}')
        vid = bt.videos.float()
        if not (torch.isfinite(vid).all() and vid.min() >= 0
                and vid.max() <= 1):
            fail('videos not finite or outside [0, 1]')
        if not (bt.tokens.min() >= 0
                and bt.tokens.max() < cfg.num_image_tokens):
            fail('tokens outside the codebook')
    again = run()
    same = all(torch.equal(a.tokens, b.tokens) for a, b in zip(out, again))
    print(f'[main] batches {sizes}, videos {tuple(out[0].videos.shape)}, '
          f'finite in [0,1], tokens < {cfg.num_image_tokens}, same seed '
          f'same tokens: {same}', flush=True)
    if not same:
        fail('the same seed gave different tokens')
    report('main', breakdown.measure(model, 'flagship'))
    return counts


def phase_text_mask():
    """The text+mask recipe at full width: cvae encode of one control frame,
    nearest code, mask_8x8 erase (face_mode 'mask', as utils/viz.py sets
    it at test time), the separate visual embedding, 20 rounds of
    mask-predict over L = 629, VQGAN decode; then the same with
    MMVID_FUSED_LNQKV=1."""
    import torch
    from mmvid_tpu_torch import breakdown

    os.environ.pop('MMVID_FUSED_LNQKV', None)
    t0 = time.perf_counter()
    model = breakdown.build('text_mask')
    torch.cuda.synchronize()
    cfg = model.cfg
    print(f'[text+mask] built in {time.perf_counter() - t0:.2f} s: sequence '
          f'{cfg.total_seq_len}, [ST1]/[VID] at {cfg.st1_tok_index}/'
          f'{cfg.vid_tok_index}, separate visual_emb '
          f'{cfg.use_separate_visual_emb}', flush=True)
    if (cfg.total_seq_len, cfg.st1_tok_index) != (629, 115):
        fail(f'text+mask layout: L {cfg.total_seq_len}, [ST1] at '
             f'{cfg.st1_tok_index}')
    b, steps = breakdown.BATCH, breakdown.STEPS
    text, control = breakdown.inputs(model, 'text_mask', b)

    def run(seed=0):
        gen = torch.Generator(device='cuda').manual_seed(seed)
        out = model.generate_images(gen, text, mask_predict_steps=steps,
                                    dynamic=False, **control)
        torch.cuda.synchronize()
        return out

    reset_counts()
    videos, tokens = run()
    counts = read_counts()
    want = expected(attention=cfg.clip.layers * steps, sample_head=steps,
                    codebook=1)
    print(f'[text+mask] launches {counts} (expected {want})', flush=True)
    if counts != want:
        fail(f'text+mask launch counts {counts} != {want}')
    vid = videos.float()
    vshape = (b, cfg.num_targets, cfg.image_size, cfg.image_size, 3)
    if tuple(vid.shape) != vshape:
        fail(f'text+mask videos {tuple(vid.shape)} != {vshape}')
    if not (torch.isfinite(vid).all() and vid.min() >= 0 and vid.max() <= 1):
        fail('text+mask videos not finite or outside [0, 1]')
    if not (tokens.min() >= 0 and tokens.max() < cfg.num_image_tokens):
        fail('text+mask tokens outside the codebook')
    # the control: cvae ids inside the 6x6 window, [MASK] around it
    vis = model.prepare_visual_tokens(None, **control).view(b, 8, 8)
    inner = vis[:, 1:7, 1:7]
    ring_masked = int((vis == cfg.mask_token).sum()) == b * (64 - 36)
    if not (ring_masked and inner.max() < cfg.num_image_tokens):
        fail('text+mask control tokens are not the mask_8x8 pattern')
    _, again = run()
    same = torch.equal(tokens, again)
    print(f'[text+mask] videos {vshape}, finite in [0,1], tokens < '
          f'{cfg.num_image_tokens}, control = mask_8x8 window, same seed '
          f'same tokens: {same}', flush=True)
    if not same:
        fail('text+mask: the same seed gave different tokens')
    report('text+mask', breakdown.measure(model, 'text_mask'))

    os.environ['MMVID_FUSED_LNQKV'] = '1'
    try:
        reset_counts()
        _, ftokens = run()
        fcounts = read_counts()
        fwant = dict(want, fused_ln_qkv=cfg.clip.layers * steps)
        n_diff = int((ftokens != tokens).sum())
        print(f'[text+mask fused] launches {fcounts} (expected {fwant}); '
              f'tokens differing from the gate-off run: {n_diff} of '
              f'{tokens.numel()} (bf16 roundings of h may flip)', flush=True)
        if fcounts != fwant:
            fail(f'fused launch counts {fcounts} != {fwant}')
        if not (ftokens.min() >= 0 and ftokens.max() < cfg.num_image_tokens):
            fail('fused path tokens outside the codebook')
        report('text+mask fused', breakdown.measure(model, 'text_mask'))
    finally:
        os.environ.pop('MMVID_FUSED_LNQKV', None)
    return counts, fcounts


def _check_videos(tag, cfg, videos, tokens):
    import torch
    vid = videos.float()
    vshape = (tokens.shape[0], cfg.num_targets, cfg.image_size,
              cfg.image_size, 3)
    if tuple(vid.shape) != vshape:
        fail(f'{tag} videos {tuple(vid.shape)} != {vshape}')
    if not (torch.isfinite(vid).all() and vid.min() >= 0 and vid.max() <= 1):
        fail(f'{tag} videos not finite or outside [0, 1]')
    if not (tokens.min() >= 0 and tokens.max() < cfg.num_image_tokens):
        fail(f'{tag} tokens outside the codebook')


def _artv_host_per_token(model):
    """The ART-V sampler's time a token on the host clock: from a
    synchronised start until ``generate_images(decode=False)`` returns
    (the host has enqueued every token; it waits only when the launch
    queue is full), and until the device is done."""
    import torch
    from mmvid_tpu_torch import breakdown
    text, _ = breakdown.inputs(model, 'artv', breakdown.BATCH)
    steps = model.cfg.target_seq_len - 1
    gen = torch.Generator(device='cuda').manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.generate_images(gen, text, decode=False)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {'enqueue_ms_per_token': (t1 - t0) / steps * 1e3,
            'wall_ms_per_token': (t2 - t0) / steps * 1e3}


def phase_artv():
    """ART-V at full width (the text-to-video flags with --ar: 768 x 12
    layers, control prefix 115, 511 decode steps, cache widths 179 ..
    626): the 16 prompts in one batch through generate.generate_videos,
    first on the card's default path (the stacked step through the decode
    kernel), then with MMVID_ARTV_FUSED=0 (the per-layer step in plain
    torch ops)."""
    import torch
    from mmvid_tpu_torch import breakdown, generate
    from mmvid_tpu_torch.tokenizer import SimpleTokenizer

    t0 = time.perf_counter()
    model = breakdown.build('artv')
    torch.cuda.synchronize()
    cfg = model.cfg
    print(f'[artv] built in {time.perf_counter() - t0:.2f} s: sequence '
          f'{cfg.total_seq_len}, control prefix {cfg.control_seq_len + 1}, '
          f'vocabulary {cfg.total_tokens}', flush=True)
    if (cfg.total_seq_len, cfg.control_seq_len + 1,
            cfg.total_tokens) != (626, 115, 51570):
        fail('ART-V layout differs from the text-to-video recipe with --ar')
    tokenizer = SimpleTokenizer()
    steps = cfg.target_seq_len - 1

    def run():
        gen = torch.Generator(device='cuda').manual_seed(0)
        out = list(generate.generate_videos(model, tokenizer,
                                            breakdown.PROMPTS,
                                            breakdown.BATCH, gen))
        torch.cuda.synchronize()
        return out[0]

    counts, tokens = {}, {}
    for tag, gate in (('artv', None), ('artv per-layer', '0')):
        if gate is None:
            os.environ.pop('MMVID_ARTV_FUSED', None)
        else:
            os.environ['MMVID_ARTV_FUSED'] = gate
        try:
            reset_counts()
            t0 = time.perf_counter()
            out = run()
            dt = time.perf_counter() - t0
            counts[tag] = read_counts()
            want = expected(artv_decode=steps if gate is None else 0)
            print(f'[{tag}] launches {counts[tag]} (expected {want}); first '
                  f'batch {dt:.3f} s', flush=True)
            if counts[tag] != want:
                fail(f'{tag} launch counts {counts[tag]} != {want}')
            _check_videos(tag, cfg, out.videos, out.tokens)
            tokens[tag] = out.tokens
            if gate is None:
                same = torch.equal(out.tokens, run().tokens)
                print(f'[{tag}] videos {tuple(out.videos.shape)}, finite in '
                      f'[0,1], tokens < {cfg.num_image_tokens}, same seed '
                      f'same tokens: {same}', flush=True)
                if not same:
                    fail(f'{tag}: the same seed gave different tokens')
                host = _artv_host_per_token(model)
                print(f'[{tag}] a batch of 16 without decode: '
                      f'{host["enqueue_ms_per_token"]:.4f} ms a token on the '
                      f'host clock until the last launch is enqueued, '
                      f'{host["wall_ms_per_token"]:.4f} ms a token until '
                      f'the device is done', flush=True)
                report(tag, breakdown.measure(model, 'artv'))
            else:
                # host-bound at seconds a batch: one timed call of each,
                # the batch above its warm-up
                print(f'[{tag}] videos {tuple(out.videos.shape)}, finite in '
                      f'[0,1], tokens < {cfg.num_image_tokens}', flush=True)
                report(tag, breakdown.measure(model, 'artv', reps=1,
                                              warm=False))
        finally:
            os.environ.pop('MMVID_ARTV_FUSED', None)
    n_diff = int((tokens['artv'] != tokens['artv per-layer']).sum())
    print(f'[artv] tokens differing between the kernel and the per-layer '
          f'runs under one seed: {n_diff} of {tokens["artv"].numel()} (bf16 '
          f'roundings flip near-ties, and a flipped token changes every '
          f'later step of its row)', flush=True)
    return counts['artv'], counts['artv per-layer']


def phase_artv_spec():
    """ART-V's exact speculative decode at full width (``MMVID_ARTV_SPEC=8``,
    bf16, batch 16), with one control frame a prompt through the cvae, so
    the nearest-code kernel runs on the path, and its tokens draft frame
    0: one greedy batch through ``ArtvModel.generate_images(visual=frames,
    temperature=1e-6, spec_stats=True)`` (launch counts: the codebook
    kernel once, the decode kernel never, as in JAX; output checks; the
    tokens a chunk), then ``breakdown.measure`` of the floor at
    temperature 1 (random weights accept almost no draft; one timed batch,
    whose runs under one seed must give the same tokens) and of the
    ceiling under MMVID_ARTV_SPEC_FORCE=1; and the share of the greedy
    tokens equal to the per-layer baseline's (MMVID_ARTV_FUSED=0),
    reported, not gated: near-ties of random weights in bf16 flip."""
    import torch
    from mmvid_tpu_torch import breakdown

    t0 = time.perf_counter()
    model = breakdown.build('artv_spec')
    torch.cuda.synchronize()
    cfg = model.cfg
    print(f'[artv spec] built in {time.perf_counter() - t0:.2f} s: k '
          f'{breakdown.SPEC_K}, control prefix {cfg.control_seq_len + 1}, '
          f'a cvae: {model.cvae is not None}', flush=True)
    text, control = breakdown.inputs(model, 'artv_spec', breakdown.BATCH)
    frames = control['visual']
    n_loop = cfg.target_seq_len - 1

    def greedy(**kw):
        gen = torch.Generator(device='cuda').manual_seed(0)
        out = model.generate_images(gen, text, visual=frames,
                                    temperature=1e-6, **kw)
        torch.cuda.synchronize()
        return out

    os.environ['MMVID_ARTV_SPEC'] = str(breakdown.SPEC_K)
    try:
        reset_counts()
        t0 = time.perf_counter()
        videos, tokens, steps = greedy(spec_stats=True)
        dt = time.perf_counter() - t0
        counts = read_counts()
        want = expected(codebook=1)
        tpc = n_loop / steps.double().mean().item()
        print(f'[artv spec] launches {counts} (expected {want}); greedy batch '
              f'{dt:.3f} s; spec acceptance {tpc:.3f} tokens/chunk (ceiling '
              f'{breakdown.SPEC_K + 1})', flush=True)
        if counts != want:
            fail(f'artv spec launch counts {counts} != {want}')
        _check_videos('artv spec', cfg, videos, tokens)
        print(f'[artv spec] videos {tuple(videos.shape)}, finite in [0,1], '
              f'tokens < {cfg.num_image_tokens}', flush=True)
        # temperature 1, seconds a batch: one timed batch
        floor = breakdown.measure(model, 'artv_spec', reps=1, warm=False)
        report('artv spec floor', floor)
        if not floor['same_tokens_across_runs']:
            fail('artv spec: the same seed gave different tokens')
        os.environ['MMVID_ARTV_SPEC_FORCE'] = '1'
        try:
            ceiling = breakdown.measure(model, 'artv_spec')
        finally:
            os.environ.pop('MMVID_ARTV_SPEC_FORCE', None)
        report('artv spec ceiling', ceiling)
    finally:
        os.environ.pop('MMVID_ARTV_SPEC', None)
    print(f'[artv spec] temperature 1: {floor["tokens_per_chunk"]:.4f} tokens '
          f'a chunk at the floor, {ceiling["tokens_per_chunk"]:.4f} forced; '
          f'same seed same tokens: {floor["same_tokens_across_runs"]}',
          flush=True)
    os.environ['MMVID_ARTV_FUSED'] = '0'
    try:
        base = greedy(decode=False)[1]
    finally:
        os.environ.pop('MMVID_ARTV_FUSED', None)
    equal = tokens == base
    first = (int((~equal).any(0).nonzero()[0]) if not equal.all()
             else None)
    print(f'[artv spec] greedy bf16: share of tokens equal to the per-layer '
          f'baseline {equal.double().mean().item():.4f}, first differing '
          f'position {first} (not gated: bf16 near-ties of random weights)',
          flush=True)
    return counts, {'floor': floor, 'ceiling': ceiling,
                    'greedy_equal_share': equal.double().mean().item(),
                    'greedy_first_difference': first}


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def phase_int8_serving():
    """The slice's path at full width: the flagship (bf16, seed 0)
    calibrated by ``ops.int8.quantize_for_serving`` (w8a8 backbone and
    VQGAN decoder) under MMVID_ATTN_INT8=1, batch 16, 20 rounds,
    ``dynamic=False``: the JAX package's gates against the bf16 model
    (logits of one forward; the decoder, ``_int8_decoder_checks``), launch
    counts, output checks, determinism by seed, then
    ``breakdown.measure``."""
    import torch
    from mmvid_tpu_torch import breakdown
    from mmvid_tpu_torch.ops.int8 import quantize_for_serving

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    model = breakdown.build('flagship')
    cfg = model.cfg
    g = torch.Generator(device='cuda').manual_seed(21)
    text4, _ = breakdown.inputs(model, 'flagship', 4)
    target = torch.randint(0, cfg.num_image_tokens,
                           (4, cfg.target_seq_len), generator=g,
                           device='cuda')
    ids = torch.randint(0, cfg.num_image_tokens, (8, cfg.image_seq_len),
                        generator=g, device='cuda')
    with torch.no_grad():
        logits_bf16 = model.core(text4, None, target)[0]
    _set_attn_int8(True)
    try:
        qmodel = quantize_for_serving(
            model, generator=torch.Generator(device='cuda').manual_seed(0))
        torch.cuda.synchronize()
        print(f'[int8] flagship built and calibrated in '
              f'{time.perf_counter() - t0:.2f} s: backbone scales '
              f'{qmodel.cfg.clip.int8_scales[0]} (layer 0) .. '
              f'{qmodel.cfg.clip.int8_scales[-1]} (layer '
              f'{cfg.clip.layers - 1}), {len(qmodel.vae.cfg.int8_scales)} '
              f'decoder sites', flush=True)
        with torch.no_grad():
            logits_int8 = qmodel.core(text4, None, target)[0]
        cos = _cosine(logits_int8, logits_bf16)
        agree = (logits_int8.argmax(-1) == logits_bf16.argmax(-1)
                 ).float().mean().item()
        print(f'[int8] one full-width forward (4 x {cfg.total_seq_len}), int8 '
              f'vs bf16 logits: cosine {cos:.6f} (> {INT8_LOGITS_COS}), '
              f'argmax agreement {agree:.4f} (> {INT8_ARGMAX_AGREE})',
              flush=True)
        if not (cos > INT8_LOGITS_COS and agree > INT8_ARGMAX_AGREE):
            fail('int8 backbone logits too far from the bf16 model\'s')
        decoder = _int8_decoder_checks(model, qmodel, ids)
        b, steps = breakdown.BATCH, breakdown.STEPS
        text, _ = breakdown.inputs(qmodel, 'flagship', b)

        def run(seed=0):
            gen = torch.Generator(device='cuda').manual_seed(seed)
            out = qmodel.generate_images(gen, text, mask_predict_steps=steps,
                                         dynamic=False)
            torch.cuda.synchronize()
            return out

        reset_counts()
        videos, tokens = run()
        counts = read_counts()
        # two int8 launches a call: the operand pass and the attention
        want = expected(attention_int8=2 * cfg.clip.layers * steps,
                        sample_head=steps)
        print(f'[int8] launches {counts} (expected {want})', flush=True)
        if counts != want:
            fail(f'int8 serving launch counts {counts} != {want}')
        _check_videos('int8', cfg, videos, tokens)
        _, again = run()
        same = torch.equal(tokens, again)
        n_diff = int((tokens != run_bf16_tokens(model, text, steps)).sum())
        print(f'[int8] videos {tuple(videos.shape)}, finite in [0,1], tokens '
              f'< {cfg.num_image_tokens}, same seed same tokens: {same}; '
              f'tokens differing from the bf16 model at one seed: {n_diff} '
              f'of {tokens.numel()}', flush=True)
        if not same:
            fail('int8 serving: the same seed gave different tokens')
        res = breakdown.measure(qmodel, 'flagship')
        res['decoder'] = decoder
        res['logits_cosine'], res['argmax_agreement'] = cos, agree
        report('int8', res)
    finally:
        _set_attn_int8(False)
    return counts


# the JAX package's decoder test config (tests/test_int8.py:207-227)
VQ_JAX_TEST = dict(resolution=64, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                   z_channels=64, embed_dim=64, n_embed=256,
                   attn_resolutions=(32,))


def _int8_decoder_checks(model, qmodel, ids):
    """The int8 decoder's checks, on 8 frames of random ids.

    Gated:
    1. Exactness: at every full-width site, the int32 sums of
       ``int8_conv`` on the card (``torch._int_mm`` over gathered windows)
       equal an fp64 convolution of the same int8 values (exact below
       2^53), on the site's own input of one frame.
    2. Each site alone quantized moves the bf16 decoder's [0, 1] images by
       less than the JAX package's bounds (INT8_DECODE_MEAN / _MAX,
       tests/test_int8.py).
    Reported, not gated (PERF.md, section 6): the decoder with every site
    quantized at once against bf16, the same scales on an fp32 copy of
    the weights against fp32, the share of activations beyond their scale,
    and the JAX test's own decoder config (fp32, random calibration, two
    random sequences).  At random weights the method's noise summed over
    the 58 full-width sites passes the JAX bounds in the JAX package too:
    tests/int8_decoder_witness.py runs both packages' quantize_vae_decoder
    on the same full-width weights and ids on the CPU, and the JAX
    package's own int8 decoder reads mean 0.0224-0.0238 against its fp32
    one there, as the port does (PERF.md, section 6)."""
    import torch
    import torch.nn.functional as F
    from mmvid_tpu_torch import factories
    from mmvid_tpu_torch.models.vqgan import SiteConv, VQGanConfig, VQGanVAE
    from mmvid_tpu_torch.ops.int8 import (int8_conv, quantize_activation,
                                          quantize_vae_decoder, quantized_vae)

    def diff(a, b):
        d = (a.float() - b.float()).abs()
        return d.mean().item(), d.max().item()

    sites = {m.site: m for m in qmodel.vae.modules()
             if isinstance(m, SiteConv) and m.a_scale is not None}
    inputs, saturated = {}, {}

    def hook(mod, args):
        x = args[0]
        inputs[mod.site] = x[:1].clone()
        saturated[mod.site] = (x.float().abs() * (127.0 / mod.a_scale)
                               > 127.5).float().mean().item()

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        img_bf16 = model.vae.decode(ids)
        handles = [m.register_forward_pre_hook(hook) for m in sites.values()]
        whole = diff(qmodel.vae.decode(ids), img_bf16)
        for h in handles:
            h.remove()
        inexact = []
        with torch.no_grad():
            for site, conv in sites.items():
                o, c, kh, kw = conv.weight.shape
                # the int8 weights the serving copy froze, and runs
                w_mat = conv.w8[0]
                x_q = quantize_activation(inputs[site], conv.a_scale)
                acc = int8_conv(x_q.permute(0, 2, 3, 1), w_mat, kh, kw)
                ref = F.conv2d(x_q.double(), w_mat.view(o, kh, kw, c).permute(
                    0, 3, 1, 2).double(), padding=(kh // 2, kw // 2))
                if not torch.equal(acc.double(), ref.permute(0, 2, 3, 1)):
                    inexact.append(site)
        per_site = {p: diff(quantized_vae(model.vae, ((p, v),)).decode(ids),
                            img_bf16) for p, v in qmodel.vae.cfg.int8_scales}
        vae32 = VQGanVAE(image_size=model.vae.image_size,
                         cfg=dataclasses.replace(model.vae.cfg,
                                                 int8_scales=None)).cuda()
        vae32.load_state_dict(model.vae.state_dict())
        whole_fp32 = diff(quantized_vae(vae32, qmodel.vae.cfg.int8_scales
                                        ).decode(ids), vae32.decode(ids))
        small = VQGanVAE(image_size=64, cfg=VQGanConfig(**VQ_JAX_TEST)).cuda()
        factories.init_weights(small, torch.Generator().manual_seed(3))
        g = torch.Generator(device='cuda').manual_seed(4)
        qsmall = quantize_vae_decoder(small, generator=g)
        seq = torch.randint(0, 256, (2, small.image_seq_len), generator=g,
                            device='cuda')
        jax_test = diff(qsmall.decode(seq), small.decode(seq))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    worst = max(per_site.items(), key=lambda kv: kv[1][0])
    worst_max = max(per_site.items(), key=lambda kv: kv[1][1])
    print(f'[int8] decoder: int32 sums equal to an fp64 conv at '
          f'{len(sites) - len(inexact)} of {len(sites)} full-width sites; '
          f'each site alone vs bf16: worst mean {worst[1][0]:.5f} '
          f'({worst[0]}), worst max {worst_max[1][1]:.5f} ({worst_max[0]}) '
          f'(bounds {INT8_DECODE_MEAN}, {INT8_DECODE_MAX}); reported: all '
          f'sites at once vs bf16 mean {whole[0]:.5f} max {whole[1]:.5f}, on '
          f'fp32 weights vs fp32 mean {whole_fp32[0]:.5f} max '
          f'{whole_fp32[1]:.5f}, saturated share max '
          f'{max(saturated.values()):.3e}; the JAX test\'s decoder config '
          f'(fp32, random calibration) mean {jax_test[0]:.5f} max '
          f'{jax_test[1]:.5f}', flush=True)
    if inexact:
        fail(f'int8 decoder sums differ from the exact product at {inexact}')
    if not all(m < INT8_DECODE_MEAN and x < INT8_DECODE_MAX
               for m, x in per_site.values()):
        fail('an int8 decoder site moves the full-width decoder too far')
    return {'sites_exact': len(sites) - len(inexact), 'sites': len(sites),
            'per_site_worst_mean': worst, 'per_site_worst_max': worst_max,
            'all_sites_vs_bf16': whole,
            'all_sites_fp32_weights_vs_fp32': whole_fp32,
            'saturated_share_max': max(saturated.values()),
            'jax_test_config': jax_test}


def run_bf16_tokens(model, text, steps):
    """The unquantized model's tokens at seed 0 (MMVID_ATTN_INT8 off)."""
    import torch
    flag = os.environ.pop('MMVID_ATTN_INT8', None)
    try:
        gen = torch.Generator(device='cuda').manual_seed(0)
        return model.generate_images(gen, text, mask_predict_steps=steps,
                                     dynamic=False, decode=False)[1]
    finally:
        if flag is not None:
            os.environ['MMVID_ATTN_INT8'] = flag


def phase_artv_int8():
    """ART-V's int8 decode at full width (``generate_images(int8=True)``:
    int8 weights, head and K/V caches, the per-layer step in torch ops, no
    kernel, as in JAX): one batch of 16 as the warm-up, one timed; output
    checks, the same tokens on one seed, no launch of any kernel."""
    import torch
    from mmvid_tpu_torch import breakdown

    t0 = time.perf_counter()
    model = breakdown.build('artv')
    cfg = model.cfg
    text, _ = breakdown.inputs(model, 'artv', breakdown.BATCH)
    torch.cuda.synchronize()
    print(f'[artv int8] built in {time.perf_counter() - t0:.2f} s',
          flush=True)

    def run():
        gen = torch.Generator(device='cuda').manual_seed(0)
        t0 = time.perf_counter()
        out = model.generate_images(gen, text, int8=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reset_counts()
    (videos, tokens), warm = run()
    counts = read_counts()
    if counts != expected():
        fail(f'ART-V int8 launched kernels: {counts}')
    _check_videos('artv int8', cfg, videos, tokens)
    torch.cuda.reset_peak_memory_stats()
    (_, again), dt = run()
    peak = torch.cuda.max_memory_allocated()
    same = torch.equal(tokens, again)
    fps = breakdown.BATCH * cfg.num_targets / dt
    print(f'[artv int8] batch 16, 511 steps: {dt:.4f} s a batch (warm-up '
          f'{warm:.4f} s), {fps:.2f} frames/s, peak memory {peak} B; '
          f'launches {counts}; videos finite in [0,1], same seed same '
          f'tokens: {same}', flush=True)
    if not same:
        fail('ART-V int8: the same seed gave different tokens')
    return {'s_per_batch': dt, 'frames_per_s': fps, 'peak_memory_bytes': peak,
            'warmup_s': warm}, counts


def timed(phase, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f'[time] {phase.__name__} {time.perf_counter() - t0:.1f} s',
          flush=True)
    return out


def main():
    import torch
    t_start = time.perf_counter()
    # the default paths first
    os.environ.pop('MMVID_FUSED_LNQKV', None)
    os.environ.pop('MMVID_ARTV_FUSED', None)
    os.environ.pop('MMVID_ATTN_BF16', None)
    os.environ.pop('MMVID_ATTN_INT8', None)
    phase_device()
    timed(phase_build)
    attention, attention_fp32 = timed(phase_attention)
    attention_int8 = timed(phase_attention_int8)
    artv_decode, decode_by_pos = timed(phase_artv_decode)
    gridstep, probe = timed(phase_gridstep)
    keys = ('max_abs_err', 'ms', 'plain_ms', 'library_ms', 'bound_ms',
            'bound_by')
    sample_head, head_extra = timed(phase_sample_head)
    ln_qkv, ln_qkv_at = timed(phase_ln_qkv)
    codebook, codebook_at = timed(phase_codebook)
    rows = {'attention': tuple(attention[(629, False)][k] for k in keys),
            'attention_int8': tuple(attention_int8[629][k] for k in keys),
            'sample_head': sample_head,
            'codebook': codebook,
            'fused_ln_qkv': ln_qkv,
            'artv_decode': artv_decode, 'gridstep': gridstep}
    timed(phase_tiny_reference)
    timed(phase_tiny_artv)
    timed(phase_tiny_artv_spec)
    flagship = timed(phase_main_path)
    text_mask, fused = timed(phase_text_mask)
    artv, artv_per_layer = timed(phase_artv)
    artv_spec, _ = timed(phase_artv_spec)
    int8_serving = timed(phase_int8_serving)
    _, artv_int8_counts = timed(phase_artv_int8)
    sources = {'attention': 'mmvid_tpu/ops/attention.py:211',
               'attention_int8': 'mmvid_tpu/ops/attention.py:211',
               'sample_head': 'mmvid_tpu/ops/sample_head.py:97',
               'codebook': 'mmvid_tpu/ops/codebook.py:59',
               'fused_ln_qkv': 'mmvid_tpu/ops/fused_ln_qkv.py:65',
               'artv_decode': 'mmvid_tpu/ops/artv_decode.py:284',
               'gridstep': 'scripts/probe_gridstep.py:36'}
    # launches: the main path that runs the kernel (the gated kernels
    # with their gate on; the probe runs on none); the numbers: at that
    # path's shapes
    main_run = {'attention': text_mask, 'attention_int8': int8_serving,
                'sample_head': text_mask,
                'codebook': text_mask, 'fused_ln_qkv': fused,
                'artv_decode': artv, 'gridstep': artv}
    kernels = []
    for name, row in rows.items():
        entry = {'name': name, 'route': 'cuda',
                 'source': f'mmvid_tpu_torch/csrc/{name}.cu',
                 'replaces': sources[name],
                 'launches': main_run[name][name],
                 **dict(zip(keys, row)),
                 'launches_by_path': {'flagship': flagship[name],
                                      'text_mask': text_mask[name],
                                      'text_mask_fused': fused[name],
                                      'artv': artv[name],
                                      'artv_per_layer': artv_per_layer[name],
                                      'artv_spec': artv_spec[name],
                                      'int8_serving': int8_serving[name],
                                      'artv_int8': artv_int8_counts[name]}}
        if name == 'attention':
            # the bf16 route (the main paths'), the tensor-core kernel,
            # on packed views; the fp32 route's CUDA-core kernel beside it
            entry['source'] = 'mmvid_tpu_torch/csrc/attention_sm90.cu'
            entry['differ_share'] = attention[(629, False)]['differ_share']
            entry['at_flagship_L565'] = attention[(565, False)]
            entry['bf16_probs'] = {'L629': attention[(629, True)],
                                   'L565': attention[(565, True)]}
            entry['fp32_route'] = {
                'source': 'mmvid_tpu_torch/csrc/attention.cu',
                'L629': attention_fp32[629], 'L565': attention_fp32[565]}
        if name == 'attention_int8':
            # MMVID_ATTN_INT8=1; the int8-serving path's launches (two a
            # call: the operand pass and the attention); the body at
            # attention.py:47-53,66-72, chosen at :162
            entry['source'] = 'mmvid_tpu_torch/csrc/attention_int8_sm90.cu'
            entry['at_flagship_L565'] = attention_int8[565]
            entry.update({k: attention_int8[629][k] for k in (
                'differ_share', 'max_steps', 'mean_steps', 'controls',
                'bitwise_repeat', 'equal_with_fp32_mask', 'ms_fp32_mask',
                'sdpa_bf16_ms_context')})
        if name == 'fused_ln_qkv':   # MMVID_FUSED_LNQKV=1, on wgmma
            entry['source'] = 'mmvid_tpu_torch/csrc/fused_ln_qkv_sm90.cu'
            entry['layer_norm_linear_ms'] = ln_qkv_at[16 * 629][
                'layer_norm_linear_ms']
            entry['at_flagship_M9040'] = ln_qkv_at[16 * 565]
        if name == 'artv_decode':   # one cooperative launch a step
            # the phased kernel is the route; the streaming one runs only
            # when asked for
            entry['source'] = 'mmvid_tpu_torch/csrc/artv_decode.cu'
            entry.update(decode_by_pos)
            entry['stream_route'] = {
                'source': 'mmvid_tpu_torch/csrc/artv_decode_sm90.cu',
                'taken': "only when asked for (kernel='stream')",
                'ms_at_pos': {pos: e['stream']['ms'] for pos, e in
                              decode_by_pos['at_pos'].items()},
                'b64_pos370_ms': decode_by_pos['b64_pos370']['stream_ms']}
        if name == 'codebook':   # 2-D tiles, one launch a call
            entry['source'] = 'mmvid_tpu_torch/csrc/codebook_sm90.cu'
            entry['at'] = codebook_at
        if name == 'sample_head':   # the bf16 route, on wgmma
            entry['source'] = 'mmvid_tpu_torch/csrc/sample_head_sm90.cu'
            entry.update(head_extra)
        if name == 'gridstep':
            entry.update(probe)
        kernels.append(entry)
    print(f'[total] {time.perf_counter() - t_start:.1f} s', flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
