#!/usr/bin/env python3
"""Where one sampling batch of the port spends its time on the card.

Builds a full-width bf16 model from a seed, for the flagship text-to-video
path (``factories.flagship``), the text+mask visual-control path
(``factories.text_and_mask_args`` through ``get_vae_model``/``get_dalle``)
or the ART-V path (``factories.artv_args``, the same factories), or
ART-V's exact speculative decode (``artv_spec``: the ART-V model with a
cvae and one control frame, whose tokens draft frame 0, and
``MMVID_ARTV_SPEC=8``), and measures one batch of 16 (the recipes'
batch), mask-predict at 20 rounds and ``dynamic=False`` (the recipes'
``mp_T``), ART-V at its 511 decode steps:

* the whole batch on the host clock, ending in a sync: median of 3 after
  a warm-up (by default), frames/s and peak device memory;
* its phases, each ended by a sync (median of 3 after a warm-up): the
  control (visual tokens and control embedding; for ART-V the prefill of
  the control prefix through the stack), the sampler (ART-V: the token
  loop), the VQGAN decode;
* one batch under ``torch.profiler``: device time by kernel kind, launches
  of the port's kernels, and the device's idle share over the batch (the
  part of the batch's host-side span covered by no device activity);
* whether the timed runs, all from one seed, gave the same tokens;
* for ``artv_spec``, the chunk forwards a lane ran and the tokens a chunk.

``chip_smoke.py`` builds its models and times its batches with
:func:`build`, :func:`inputs` and :func:`measure`.  Usage (needs a CUDA
device; prints one JSON line per path, with the paths taken: the fused
LN+QKV gate ``MMVID_FUSED_LNQKV=1``, ART-V's decode step (the kernel on
the card unless ``MMVID_ARTV_FUSED=0``), ``MMVID_ATTN_BF16``):

    python -m mmvid_tpu_torch.breakdown --path text_mask flagship
    MMVID_FUSED_LNQKV=1 python -m mmvid_tpu_torch.breakdown --path text_mask
    MMVID_ARTV_FUSED=0 python -m mmvid_tpu_torch.breakdown --path artv
    python -m mmvid_tpu_torch.breakdown --path artv_spec

``--path artv_spec`` prints two lines: the floor (random weights accept
almost no draft) and the ceiling under ``MMVID_ARTV_SPEC_FORCE=1`` (every
draft accepted; its tokens are garbage by design).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import torch

from mmvid_tpu_torch import factories
from mmvid_tpu_torch.models.artv import fused_decode
from mmvid_tpu_torch.ops import artv_decode, attention, attention_int8
from mmvid_tpu_torch.ops import codebook, fused_ln_qkv, gridstep, sample_head
from mmvid_tpu_torch.tokenizer import SimpleTokenizer

KERNELS = {'attention': attention, 'attention_int8': attention_int8,
           'sample_head': sample_head,
           'codebook': codebook, 'fused_ln_qkv': fused_ln_qkv,
           'artv_decode': artv_decode, 'gridstep': gridstep}
# (kind, substrings of device kernel names); the first match wins
KINDS = (
    ('attention kernel, int8', ('attention_int8_wgmma',
                                'int8_operands_kernel')),
    ('attention kernel, tensor cores', ('attention_fwd_kernel_wgmma',)),
    ('attention kernel, CUDA cores', ('attention_fwd_kernel',)),
    ('sample-head kernel', ('sample_head_kernel',)),
    ('nearest-code kernel', ('nearest_code_',)),
    ('LN+QKV kernel', ('ln_qkv_', 'ln_stats_kernel')),
    ('ART-V decode kernel', ('artv_step_kernel',)),
    ('grid-step probe', ('probe_layer_kernel', 'probe_persistent_kernel')),
    ('convolutions', ('conv', 'fprop', 'dgrad', 'implicit_gemm',
                      'winograd')),
    ('GEMMs', ('gemm', 'nvjet', 'cutlass', 'xmma', 'cublas')),
    ('LayerNorm / GroupNorm', ('layer_norm', 'group_norm', 'norm')),
    ('copies and casts', ('copy', 'memcpy', 'memset', 'cast', 'convert')),
)
BATCH, STEPS = 16, 20
SPEC_K = 8   # drafts a chunk on the artv_spec path
PROMPTS = ['a woman with wavy hair is talking', 'a man is smiling',
           'a young person with glasses speaks',
           'an old man with a beard is talking', 'she laughs',
           'a man with black hair and a mustache is talking',
           'he has big lips and is young', 'the woman wears earrings',
           'a bald man with a goatee is talking',
           'she has blond hair and arched eyebrows', 'he is chubby',
           'a smiling woman with bangs', 'a man with a pointy nose',
           'the young man has straight hair', 'she wears lipstick',
           'a man with bushy eyebrows is speaking']


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return 'other elementwise and reductions'


def steady(fn, reps: int = 3, warm: bool = True):
    """Warm up once (unless ``warm`` is false), then time ``reps`` calls of
    ``fn``, each ended by a sync, on the host clock: (median s, all s,
    peak device memory in bytes over the timed calls, the last call's
    result)."""
    if warm:
        fn()
        torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return (statistics.median(times), times,
            torch.cuda.max_memory_allocated(), out)


def build(path: str, dtype=torch.bfloat16):
    """The path's full-width model on the card, weights from seed 0."""
    if path == 'flagship':
        model, _ = factories.flagship(tiny=False, dtype=dtype, seed=0)
    elif path in ('text_mask', 'artv', 'artv_spec'):
        args = (factories.text_and_mask_args() if path == 'text_mask'
                else factories.artv_args())
        if path == 'artv_spec':   # one control frame, through the cvae
            args.use_cvae, args.num_visuals = True, 1
        vae = factories.get_vae_model(args, dtype=dtype)
        cvae = (factories.get_vae_model(args, dtype=dtype) if args.use_cvae
                else None)
        model = factories.get_dalle(args, vae, cvae, dtype=dtype).eval()
        factories.init_weights(model, torch.Generator().manual_seed(0))
    else:
        raise ValueError(f'unknown path {path!r}')
    return model


def inputs(model, path: str, batch: int = BATCH):
    """(text ids [batch, text_seq_len] of the first ``batch`` prompts,
    the control keywords of ``generate_images``), on the card.  text+mask
    and artv_spec: seeded random control frames [batch, 1, H, W, 3] in
    [0, 1]; text+mask with vc_mode mask_8x8 and face_mode 'mask', as
    utils/viz.py sets it at test time."""
    cfg = model.cfg
    text = torch.as_tensor(SimpleTokenizer().tokenize(
        (PROMPTS * batch)[:batch], cfg.text_seq_len, truncate_text=True),
        dtype=torch.long).cuda()
    if path not in ('text_mask', 'artv_spec'):
        return text, {}
    g = torch.Generator(device='cuda').manual_seed(5)
    visual = torch.rand((batch, cfg.num_visuals, cfg.image_size,
                         cfg.image_size, 3), generator=g, device='cuda')
    if path == 'artv_spec':
        return text, dict(visual=visual)
    return text, dict(visual=visual, vc_mode='mask_8x8', face_mode='mask')


def measure(model, path: str, batch: int = BATCH, steps: int = STEPS,
            reps: int = 3, warm: bool = True) -> dict:
    """The numbers of the module docstring for ``model`` on ``path``,
    one JSON-ready dict (``steps``: mask-predict rounds; for ART-V its
    decode steps, which ``steps`` does not set).  ``reps`` timed calls
    of each, after a warm-up unless ``warm`` is false (for a caller that
    has just run the path at this batch).  ``artv_spec`` sets
    ``MMVID_ARTV_SPEC`` to :data:`SPEC_K` while it measures and reads
    ``MMVID_ARTV_SPEC_FORCE`` as it finds it."""
    if path == 'artv_spec':
        flag = os.environ.get('MMVID_ARTV_SPEC')
        os.environ['MMVID_ARTV_SPEC'] = str(SPEC_K)
        try:
            return _measure(model, path, batch, steps, reps, warm)
        finally:
            if flag is None:
                os.environ.pop('MMVID_ARTV_SPEC')
            else:
                os.environ['MMVID_ARTV_SPEC'] = flag
    return _measure(model, path, batch, steps, reps, warm)


def _measure(model, path, batch, steps, reps, warm):
    cfg = model.cfg
    text, control = inputs(model, path, batch)
    kw = dict(mask_predict_steps=steps, dynamic=False, **control)
    ar = path in ('artv', 'artv_spec')
    if ar:
        steps = cfg.target_seq_len - 1
    if path == 'artv_spec':
        kw['spec_stats'] = True

    def batch_run(decode=True):
        gen = torch.Generator(device='cuda').manual_seed(1)
        return model.generate_images(gen, text, decode=decode, **kw)

    def control_run():
        if ar:
            return model.prefill(text, control.get('visual'))
        vis = None
        if control:
            vis = model.prepare_visual_tokens(
                None, control['visual'], vc_mode=control['vc_mode'],
                face_mode=control['face_mode'])
        elif cfg.num_visuals:
            vis = model.fully_masked_visual(batch, text.device)
        return model.core.control_embedding(text, vis)

    dt, whole, peak, first = steady(batch_run, reps, warm)
    ctrl = steady(control_run, reps)[0]
    no_decode, _, _, out = steady(lambda: batch_run(decode=False), reps,
                                  warm)
    seq = out[1]
    dec = steady(lambda: model.decode_video(seq), reps)[0]
    phases = {'control': ctrl * 1e3, 'sampler': (no_decode - ctrl) * 1e3,
              'decode': dec * 1e3}

    for mod in KERNELS.values():
        mod.launches = 0
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function('mmvid_batch'):
            batch_run()
            torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in KERNELS.items()}
    # the profiler's raw events (times in ns): prof.events() builds a
    # Python object tree of every host op first, which takes minutes for a
    # batch of half a million launches (the gate-off ART-V path)
    events = prof.profiler.kineto_results.events()
    window = [e for e in events if e.name() == 'mmvid_batch'
              and e.device_type() == DeviceType.CPU][0]
    # device activity: kernels, copies, sets (not the annotation's own
    # device-side span)
    dev = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in events if e.device_type() == DeviceType.CUDA
                  and e.name() != 'mmvid_batch'), key=lambda x: x[0])
    by_kind, busy, cur_s, cur_e = {}, 0.0, None, None
    for s, e, name in dev:
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + (e - s)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = window.duration_ns()
    spec = {}
    if path == 'artv_spec':
        chunks = out[2].double().mean().item()
        spec = {'spec_k': SPEC_K,
                'spec_force': os.environ.get('MMVID_ARTV_SPEC_FORCE') == '1',
                'chunks_per_lane': chunks, 'tokens_per_chunk': steps / chunks}
    return {
        'path': path, 'batch': batch, 'steps': steps,
        'sequence': cfg.total_seq_len,
        'fused_lnqkv': os.environ.get('MMVID_FUSED_LNQKV') == '1',
        'artv_fused': path == 'artv' and fused_decode('cuda'),
        **spec,
        'attn_bf16_probs': attention.bf16_probs(),
        'attn_int8': attention_int8.enabled(),
        'int8_backbone': cfg.clip.int8_scales is not None,
        's_per_batch': dt, 's_all': whole,
        'frames_per_s': batch * cfg.num_targets / dt,
        'peak_memory_bytes': peak, 'phases_ms': phases,
        'launches': launches, 'device_events': len(dev),
        # the whole and the no-decode runs draw from one seed
        'same_tokens_across_runs': bool(torch.equal(first[1], seq)),
        'device_ms_by_kind': {k: v / 1e6 for k, v in sorted(
            by_kind.items(), key=lambda kv: -kv[1])},
        'device_busy_ms': busy / 1e6, 'batch_span_ms': span / 1e6,
        'idle_share': 1 - busy / span if span > 0 else None}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--path', nargs='+', default=['text_mask'],
                   choices=['text_mask', 'flagship', 'artv', 'artv_spec'])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    for path in args.path:
        model = build(path)
        # artv_spec: the floor, then the ceiling with every draft accepted
        for force in ((None, '1') if path == 'artv_spec' else (None,)):
            if force:
                os.environ['MMVID_ARTV_SPEC_FORCE'] = force
            try:
                res = measure(model, path)
            finally:
                os.environ.pop('MMVID_ARTV_SPEC_FORCE', None)
            res['card'] = card
            print(json.dumps(res), flush=True)


if __name__ == '__main__':
    main()
