#!/usr/bin/env python3
"""Where one sampling batch, or one training step, of the port spends its
time on the card.

Builds a full-width bf16 model (``--fp32``: fp32, the precision every
released recipe runs) from a seed, for the flagship text-to-video
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

``--path train`` and ``--path train_artv`` time the training step instead
(:func:`measure_train`, which ``bench_train.py`` and ``chip_smoke.py``
call too): the flagship text-to-video recipe's step (MSM / REL / VID,
beta 7 / 0.5 / 0.5, ``rel_no_fully_masked``; the frozen VQGAN tokenizing
the 8 target frames and the warped frame inside it) or ART-V's, on the
training build (fp32 parameters, bf16 compute, the flagship's blocks
rematerialised; with ``--fp32`` fp32 compute, TF32 off, the released
``train.sh``'s precision), batch 16 of synthetic text ids and uniform
frames from ``np.random.RandomState(0)``: one warm-up step, then 5 timed
steps on the
host clock ending in a sync; peak device memory over them; one profiled
step (device time by kind, idle share, the kernels' launches and
attention's backward calls and backward kernel launches a step).

``chip_smoke.py`` builds its models and times its batches with
:func:`build`, :func:`inputs` and :func:`measure`.  Usage (needs a CUDA
device; prints one JSON line per path, with the paths taken: the fused
LN+QKV gate ``MMVID_FUSED_LNQKV=1``, ART-V's decode step (the kernel on
the card unless ``MMVID_ARTV_FUSED=0``), ``MMVID_ATTN_BF16``):

    python -m mmvid_tpu_torch.breakdown --path text_mask flagship
    MMVID_FUSED_LNQKV=1 python -m mmvid_tpu_torch.breakdown --path text_mask
    MMVID_ARTV_FUSED=0 python -m mmvid_tpu_torch.breakdown --path artv
    python -m mmvid_tpu_torch.breakdown --path artv_spec
    python -m mmvid_tpu_torch.breakdown --path train train_artv
    python -m mmvid_tpu_torch.breakdown --path train --batch 8
    python -m mmvid_tpu_torch.breakdown --fp32 --path train
    python -m mmvid_tpu_torch.breakdown --fp32 --path flagship text_mask

``--path artv_spec`` prints two lines: the floor (random weights accept
almost no draft) and the ceiling under ``MMVID_ARTV_SPEC_FORCE=1`` (every
draft accepted; its tokens are garbage by design).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from mmvid_tpu_torch import factories, training
from mmvid_tpu_torch.models.artv import fused_decode
from mmvid_tpu_torch.ops import artv_decode, attention, attention_int8
from mmvid_tpu_torch.ops import codebook, fused_ln_qkv, gridstep, sample_head
from mmvid_tpu_torch.ops.precision import fp32_exact
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
    ('attention backward, split TF32', ('attention_bwd_fp32_',)),
    ('attention backward, tensor cores', ('attention_bwd_',)),
    ('attention kernel, CUDA cores', ('attention_fwd_kernel',)),
    ('sample-head kernel', ('sample_head_kernel', 'sample_head_tf32_')),
    ('nearest-code kernel', ('nearest_code_',)),
    ('LN+QKV kernel', ('ln_qkv_', 'ln_stats_kernel')),
    ('ART-V decode kernel', ('artv_step_kernel',)),
    ('grid-step probe', ('probe_layer_kernel', 'probe_persistent_kernel')),
    # cuDNN's FFT convolutions: the transforms, the pointwise complex
    # products and the complex GEMM
    ('convolutions', ('conv', 'fprop', 'dgrad', 'wgrad', 'implicit_gemm',
                      'winograd', 'fft', '_complex', 'gemm_cf32')),
    ('GEMMs', ('gemm', 'nvjet', 'cutlass', 'xmma', 'cublas')),
    ('LayerNorm / GroupNorm', ('layer_norm', 'group_norm', 'norm')),
    ('copies and casts', ('copy', 'memcpy', 'memset', 'cast', 'convert')),
)
BATCH, STEPS = 16, 20
TOP_KERNELS = 10   # kernels by name in profile_run's record
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

    prof = profile_run(batch_run)
    launches = prof.pop('launches')
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
        'launches': launches,
        # the whole and the no-decode runs draw from one seed
        'same_tokens_across_runs': bool(torch.equal(first[1], seq)),
        **prof}


def profile_run(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the port's kernels'
    launches in it, attention's backward calls
    (``FusedAttention.backward``) and its kernels' launches
    (``attention.backward_launches``), its device events, device time by
    kind and of the TOP_KERNELS largest kernels by name, the device's
    busy time and the call's host-side span (ms), and the idle share (the
    part of the span covered by no device activity)."""
    for mod in KERNELS.values():
        mod.launches = 0
    attention.backward_calls = attention.backward_launches = 0
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function('mmvid_batch'):
            fn()
            torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in KERNELS.items()}
    backward_calls = attention.backward_calls
    backward_launches = attention.backward_launches
    # the profiler's raw events (times in ns): prof.events() builds a
    # Python object tree of every host op first, which takes minutes for a
    # batch of half a million launches (the gate-off ART-V path)
    events = prof.profiler.kineto_results.events()
    window = [e for e in events if e.name() == 'mmvid_batch'
              and e.device_type() == DeviceType.CPU][0]
    dev = device_events(events, 'mmvid_batch')
    by_kind, by_name = {}, {}
    for s, e, name in dev:
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + (e - s)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    busy = busy_ns(dev)
    span = window.duration_ns()
    return {'launches': launches,
            'attention_backward_calls': backward_calls,
            'attention_backward_launches': backward_launches,
            'device_events': len(dev),
            'device_ms_by_kind': {k: v / 1e6 for k, v in sorted(
                by_kind.items(), key=lambda kv: -kv[1])},
            'top_kernels_ms': [(name[:120], v / 1e6) for name, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]],
            'device_busy_ms': busy / 1e6, 'batch_span_ms': span / 1e6,
            'idle_share': 1 - busy / span if span > 0 else None}


def device_events(events, annotation: str):
    """(start ns, end ns, name) of the device activity among a profile's
    raw events: kernels, copies, sets (not ``annotation``'s own
    device-side span), by start."""
    from torch.autograd import DeviceType
    return sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in events if e.device_type() == DeviceType.CUDA
                   and e.name() != annotation), key=lambda x: x[0])


def busy_ns(dev, lo=None, hi=None) -> float:
    """The time covered by at least one of the (start, end, name) device
    events, clipped to [lo, hi] where given."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e, _ in dev:
        if lo is not None:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_share(prof, annotation: str, skip: int = 0) -> dict:
    """The device's idle share over the host-side spans of the CPU events
    named ``annotation`` (e.g. the training driver's ``mmvid_train_iter``,
    one an iteration) in a finished ``torch.profiler`` run, the first
    ``skip`` of them left out: {'idle_share', 'busy_ms', 'span_ms',
    'windows'}."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    wins = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in events if e.name() == annotation
                  and e.device_type() == DeviceType.CPU)[skip:]
    dev = device_events(events, annotation)
    busy = sum(busy_ns(dev, lo, hi) for lo, hi in wins)
    span = sum(hi - lo for lo, hi in wins)
    return {'idle_share': 1 - busy / span, 'busy_ms': busy / 1e6,
            'span_ms': span / 1e6, 'windows': len(wins)}


TRAIN_STEPS = 5   # timed training steps, after one warm-up step


def train_config(path: str, **changes) -> training.TrainConfig:
    """The recipe's TrainConfig: the flagship text-to-video recipe
    (scripts/mmvoxceleb/text_to_video/train.sh: beta 7 / 0.5 / 0.5,
    ``--rel_no_fully_masked``; the rest as scripts/bench_train.py sets
    it), or ART-V's (beta_msm 1, which AR mode forces)."""
    if path == 'train_artv':
        return training.TrainConfig(beta_msm=1.0, lr_scheduler_warmup=5000,
                                    dropout_vc=0.1, **changes)
    return training.TrainConfig(beta_msm=7.0, beta_rel=0.5, beta_vid=0.5,
                                lr_scheduler_warmup=5000, dropout_vc=0.1,
                                rel_no_fully_masked=True, **changes)


def build_train(path: str, device='cuda', dtype=torch.bfloat16):
    """The full-width training build on ``device``, weights from seed 0,
    fp32 parameters computing in ``dtype``: the flagship (each block
    rematerialised) or ART-V."""
    if path == 'train':
        model, _ = factories.flagship_train(dtype=dtype, device=device,
                                            seed=0)
    elif path == 'train_artv':
        model, _ = factories.artv_train(dtype=dtype, device=device, seed=0)
    else:
        raise ValueError(f'unknown training path {path!r}')
    return model


def train_batch(model, batch: int, device='cuda') -> dict:
    """scripts/bench_train.py's synthetic batch: text ids in [1, 49000)
    (in [1, num_text_tokens) for a smaller vocabulary) and uniform frames
    [B, T, H, W, 3], from ``np.random.RandomState(0)``."""
    cfg = model.cfg
    rng = np.random.RandomState(0)
    text = rng.randint(1, min(49000, cfg.num_text_tokens),
                       (batch, cfg.text_seq_len))
    frames = rng.uniform(0, 1, (batch, cfg.num_targets, cfg.image_size,
                                cfg.image_size, 3))
    return {'text': torch.as_tensor(text, dtype=torch.long, device=device),
            'target': torch.as_tensor(frames, dtype=torch.float32,
                                      device=device)}


def measure_train(model, path: str = 'train', batch: int = BATCH,
                  steps: int = TRAIN_STEPS, profiled=True) -> dict:
    """The training step's numbers (the module docstring), one JSON-ready
    dict: ``ms`` a step (mean of ``steps`` after a warm-up step, host
    clock, ending in a sync, as scripts/bench_train.py times JAX's),
    ``videos_s``, ``frames_s``, the last step's ``loss`` and every timed
    step's (``losses``); on the card also the peak memory over the timed
    steps and, with ``profiled``, one more step under the profiler
    (launches, attention's backward calls and backward kernel launches
    a step, device time by kind, idle share), on the recipe's
    config (:func:`train_config`)."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    cuda = dev.type == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tc = train_config(path)
    state = training.create_train_state(model, tc)
    step = training.make_train_step(model, tc)
    data = train_batch(model, batch, dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def run():
        nonlocal state
        state, metrics = step(state, data, gen)
        return metrics

    t0 = time.perf_counter()
    run()
    sync()
    warm = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = [run() for _ in range(steps)]
    sync()
    dt = (time.perf_counter() - t0) / steps
    losses = [float(m['loss']) for m in metrics]
    res = {'what': 'train_step', 'path': path, 'batch': batch,
           'ms': dt * 1e3, 'videos_s': batch / dt,
           'frames_s': batch * cfg.num_targets / dt, 'loss': losses[-1],
           'losses': losses, 'grad_norm': float(metrics[-1]['grad_norm']),
           'warmup_s': warm, 'steps': steps, 'sequence': cfg.total_seq_len,
           'remat': cfg.clip.remat, 'device': str(dev),
           'peak_memory_bytes': (torch.cuda.max_memory_allocated() if cuda
                                 else None)}
    if cuda and profiled:
        prof = profile_run(run)
        res['launches_per_step'] = prof.pop('launches')
        res['attention_backward_calls_per_step'] = prof.pop(
            'attention_backward_calls')
        res['attention_backward_launches_per_step'] = prof.pop(
            'attention_backward_launches')
        res.update(prof)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--path', nargs='+', default=['text_mask'],
                   choices=['text_mask', 'flagship', 'artv', 'artv_spec',
                            'train', 'train_artv'])
    p.add_argument('--batch', type=int, default=BATCH)
    p.add_argument('--fp32', action='store_true',
                   help='build the paths in fp32, the released recipes\' '
                        'precision (none passes --bf16; training: fp32 '
                        'compute, TF32 off); the default is bf16')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    for path in args.path:
        if path.startswith('train'):
            dtype = torch.float32 if args.fp32 else torch.bfloat16
            with fp32_exact() if args.fp32 else contextlib.nullcontext():
                res = measure_train(build_train(path, dtype=dtype), path,
                                    args.batch)
            res['card'] = card
            res['dtype'] = str(dtype).split('.')[-1]
            print(json.dumps(res), flush=True)
            continue
        model = build(path, torch.float32 if args.fp32 else torch.bfloat16)
        # artv_spec: the floor, then the ceiling with every draft accepted
        for force in ((None, '1') if path == 'artv_spec' else (None,)):
            if force:
                os.environ['MMVID_ARTV_SPEC_FORCE'] = force
            try:
                res = measure(model, path, args.batch)
            finally:
                os.environ.pop('MMVID_ARTV_SPEC_FORCE', None)
            res['card'] = card
            res['dtype'] = 'float32' if args.fp32 else 'bfloat16'
            print(json.dumps(res), flush=True)


if __name__ == '__main__':
    main()
