#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mmvid_tpu_torch``) on one GPU.

Drives the port's main path -- flagship text-to-video mask-predict sampling
at full width (768 x 12-layer backbone, 20 rounds, VQGAN decode of 8 frames
at 128 px) on weights drawn from a seed -- through ``factories.flagship``
and ``generate.generate_videos``.  Phases, in order; any failure exits
non-zero and prints no result line:

1. device: CUDA is required; prints the card's name and power limit.
2. build: compiles ``mmvid_tpu_torch/csrc`` with nvcc (sm_90a).
3. attention kernel vs its plain version, fp32 (TF32 off) and bf16.
4. sample-head kernel vs its plain version: exact at temp 0 for Y given
   the chosen token, token histograms in distribution (TV bounds).
5. tiny model on the card vs the same weights on the CPU (plain paths).
6. main path: 6 prompts at batch 4, launch counts, output checks,
   determinism by seed; then one batch of 16 timed at steady state.

Prints the kernels' JSON line, then as its last line
``{"ok": true, "device": {...}}``.  Run from the repository root:
``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
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
ATTN_TOL = {'float32': 1e-4, 'bfloat16': 2e-2}   # max abs error
# kernel Y vs the plain softmax probability of the kernel's token.  With a
# bf16 W the LN output is rounded to bf16 before the product; the kernel's
# and the plain LN statistics differ in the last fp32 bit, which flips the
# rounding of a few elements and moves a logit by ~1e-3.
Y_TOL = {'float32': 1e-5, 'bfloat16': 2e-3}


def fail(msg: str):
    print(f'FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` single-call CUDA-event timings, in ms."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def phase_attention():
    import torch
    from mmvid_tpu_torch.models.clip import build_attention_mask
    from mmvid_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain = fp32
    dev = torch.device('cuda')
    rows = {}
    # (B, L, H, D, mask_prev index): the flagship and the tiny config
    for b, l, h, d, idx in ((16, 565, 12, 64, (51, 52)),
                            (16, 139, 2, 32, (9, 10))):
        mask = build_attention_mask(l, 'mask_prev', index=idx, device=dev)
        g = torch.Generator(device=dev).manual_seed(l)
        q, k, v = (torch.randn((b, l, h, d), generator=g, device=dev)
                   for _ in range(3))
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
            out = A.fused_attention_blhd(qd, kd, vd, mask)
            ref = A.attention_reference(qd, kd, vd, mask, d ** -0.5)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            name = str(dtype).split('.')[-1]
            tol = ATTN_TOL[name]
            ms = cuda_time_ms(lambda: A.fused_attention_blhd(qd, kd, vd,
                                                             mask))
            plain_ms = cuda_time_ms(
                lambda: A.attention_reference(qd, kd, vd, mask, d ** -0.5))
            print(f'[attention] B={b} L={l} H={h} D={d} {name}: max abs '
                  f'err {err:.3e} (tol {tol}) kernel {ms:.4f} ms plain '
                  f'{plain_ms:.4f} ms', flush=True)
            if not err <= tol:
                fail(f'attention {name} D={d}: max abs err {err} > {tol}')
            rows[(d, name)] = (err, ms, plain_ms)
    return rows[(64, 'bfloat16')]


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

    ms = cuda_time_ms(lambda: S.fused_sample_head(x, ln_w, ln_b, w, b, 1.0,
                                                  g))

    def plain():
        g1 = S.gumbel((m, v), g, dev)
        g2 = S.gumbel((m, v), g, dev)
        return S.sample_head_reference(x, ln_w, ln_b, w, b, 1.0, g1, g2)

    plain_ms = cuda_time_ms(plain)
    print(f'[sample_head] M={m}: kernel {ms:.4f} ms plain (noise draw '
          f'included) {plain_ms:.4f} ms', flush=True)
    return y_err, ms, plain_ms


def phase_tiny_reference():
    """The tiny model on the card (kernels) against the same weights on the
    CPU (plain versions, the path the CPU tests hold against JAX)."""
    import torch
    from mmvid_tpu_torch import factories

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu, _ = factories.flagship(tiny=True, seed=3)
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
    torch.backends.cudnn.allow_tf32 = True
    if not (max(errs) <= 1e-3 and img_err <= 1e-3):
        fail('tiny model on the card disagrees with the CPU')


def phase_main_path():
    import torch
    from mmvid_tpu_torch import factories, generate
    from mmvid_tpu_torch.ops import attention as A
    from mmvid_tpu_torch.ops import sample_head as S
    from mmvid_tpu_torch.tokenizer import SimpleTokenizer

    t0 = time.perf_counter()
    model, _ = factories.flagship(tiny=False, dtype=torch.bfloat16,
                                  device='cuda', seed=0)
    tokenizer = SimpleTokenizer()
    torch.cuda.synchronize()
    print(f'[main] flagship built in {time.perf_counter() - t0:.2f} s',
          flush=True)
    cfg = model.cfg
    prompts = ['a woman with wavy hair is talking', 'a man is smiling',
               'a young person with glasses speaks',
               'an old man with a beard is talking', 'she laughs',
               'a man with black hair and a mustache is talking']
    steps, batch = 20, 4

    def run():
        gen = torch.Generator(device='cuda').manual_seed(0)
        out = list(generate.generate_videos(model, tokenizer, prompts, batch,
                                            gen, mask_predict_steps=steps,
                                            dynamic=False))
        torch.cuda.synchronize()
        return out

    A.launches = 0
    S.launches = 0
    out = run()
    counts = {'attention': A.launches, 'sample_head': S.launches}
    n_batches = -(-len(prompts) // batch)
    want = {'attention': cfg.clip.layers * steps * n_batches,
            'sample_head': steps * n_batches}
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

    # one batch of 16 at steady state
    prompts16 = (prompts * 3)[:16]
    gen = torch.Generator(device='cuda').manual_seed(1)
    list(generate.generate_videos(model, tokenizer, prompts16, 16, gen,
                                  mask_predict_steps=steps, dynamic=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = list(generate.generate_videos(model, tokenizer, prompts16, 16,
                                            gen, mask_predict_steps=steps,
                                            dynamic=False))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    fps = 16 * cfg.num_targets / dt
    mem = torch.cuda.max_memory_allocated()
    print(f'[main] batch 16, {steps} steps: {dt:.4f} s per batch (median of '
          f'{len(times)}: {[round(t, 4) for t in times]}), {fps:.2f} '
          f'frames/s, peak memory {mem} B ({mem / 2 ** 30:.2f} GiB)',
          flush=True)
    if not torch.isfinite(res[0].videos.float()).all():
        fail('batch-16 videos not finite')
    return counts


def main():
    import torch
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    attn_err, attn_ms, attn_plain = phase_attention()
    sh_err, sh_ms, sh_plain = phase_sample_head()
    phase_tiny_reference()
    counts = phase_main_path()
    kernels = [
        {'name': 'attention', 'route': 'cuda',
         'source': 'mmvid_tpu_torch/csrc/attention.cu',
         'replaces': 'mmvid_tpu/ops/attention.py:211',
         'launches': counts['attention'], 'max_abs_err': attn_err,
         'ms': attn_ms, 'plain_ms': attn_plain},
        {'name': 'sample_head', 'route': 'cuda',
         'source': 'mmvid_tpu_torch/csrc/sample_head.cu',
         'replaces': 'mmvid_tpu/ops/sample_head.py:97',
         'launches': counts['sample_head'], 'max_abs_err': sh_err,
         'ms': sh_ms, 'plain_ms': sh_plain},
    ]
    print(f'[total] {time.perf_counter() - t_start:.1f} s', flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
