"""FVD evaluation throughput at flagship size: the twin of
scripts/bench_eval.py.

Everything inside ``eval.evaluate.evaluate``'s loop (the reference runs it
over 2048 samples at batch 16, utils_eval.py:60-97): the flagship's
20-round mask-predict generation in bf16, the ping-pong extension, and
I3D's embedding of the real and the generated clips, then FVD and PRD.
Random I3D weights: timing only, the numbers are not FVD-comparable.
Synthetic real clips (8 frames at 128 px) are made in bulk before the
timing.  Prints the JAX script's JSON line (``what``, ``batch``,
``samples``, ``samples_s``, ``protocol_2048_min``) with the card's name.
Runs on the card:

    python -m mmvid_tpu_torch.bench_eval 16 64
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
import types

import numpy as np
import torch

from mmvid_tpu_torch import breakdown
from mmvid_tpu_torch.eval import prd
from mmvid_tpu_torch.eval.evaluate import (
    VideoEmbedder,
    build_i3d,
    evaluate,
    model_device,
)
from mmvid_tpu_torch.models.mmvid import DEFAULT_MP_CONFIG

STEPS = 20


def eval_args(model, batch: int, n: int, log_dir: str):
    """The flags ``evaluate`` reads, as scripts/bench_eval.py sets them."""
    return types.SimpleNamespace(
        seed=0, num_targets=model.cfg.num_targets, eval_num=n,
        batch_size=batch, log_metric_dir=log_dir,
        mask_predict_steps=[STEPS], pnag_dynamic=False,
        mp_config=DEFAULT_MP_CONFIG, allow_random_i3d=True)


def synthetic_batches(model, batch: int, n_batches: int, seed: int = 0):
    """An endless cycle over ``n_batches`` batches made up front: random
    text ids and real clips [batch, num_targets, H, W, 3] in [0, 1]."""
    cfg = model.cfg
    rng = np.random.RandomState(seed)
    made = [{'text': rng.randint(1, 49000, (batch, cfg.text_seq_len)),
             'target': rng.rand(batch, cfg.num_targets, cfg.image_size,
                                cfg.image_size, 3).astype(np.float32)}
            for _ in range(n_batches)]
    while True:
        yield from made


def _prd_s(fake, real, seed: int = 0) -> float:
    """Host seconds of evaluate's PRD (20 clusters, 10 k-means runs) on
    these embeddings."""
    t0 = time.perf_counter()
    prd.compute_prd_from_embedding(fake, real,
                                   num_clusters=min(20, len(fake)),
                                   rng=np.random.default_rng(seed))
    return time.perf_counter() - t0


def measure_eval(model, batch: int = 16, n: int = 64,
                 reps: int = 3) -> dict:
    """samples/s of ``evaluate`` over ``n`` samples after a warm-up batch
    (host clock, ending in a sync), its extrapolation to 2048 (JAX's
    bench's: ``2048 / samples_s``), its peak memory; PRD's host seconds
    on those ``n`` embeddings and on 2048 random ones (its k-means does
    not scale with the samples), and the extrapolation that takes PRD
    once, at 2048; then per batch, each a median of ``reps`` after a
    warm-up: generation ms, and ping-pong + I3D ms of the real and of the
    fake clips."""
    with tempfile.TemporaryDirectory(prefix='mmvid_eval_') as tmp:
        args = eval_args(model, batch, batch, tmp)
        batches = synthetic_batches(model, batch, max(n // batch, 1))
        evaluate(args, model, batches, metrics=('fvd',))      # warm-up
        args.eval_num = n
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = evaluate(args, model, batches, metrics=('fvd', 'prd'))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        prd_n = _prd_s(np.load(os.path.join(tmp, 'fake_embs.npy')),
                       np.load(os.path.join(tmp, 'real_embs.npy')))
    rng = np.random.RandomState(1)
    prd_2048 = _prd_s(rng.randn(2048, 400), rng.randn(2048, 400))
    sample = next(batches)
    dev = model_device(model)
    text = torch.as_tensor(sample['text'], device=dev).long()
    real = torch.as_tensor(sample['target'], device=dev)
    embed = VideoEmbedder(build_i3d(args, None, dev), 15
                          if model.cfg.num_targets < 16 else 16)
    g = torch.Generator(device=dev).manual_seed(1)

    def generate():
        with torch.no_grad():
            return model.generate_images(g, text, mask_predict_steps=STEPS,
                                         dynamic=False)[0]

    gen_s = breakdown.steady(generate, reps)[0]
    fake = generate()
    real_s = breakdown.steady(lambda: embed(real), reps)[0]
    fake_s = breakdown.steady(lambda: embed(fake), reps)[0]
    sps = n / wall
    return {'what': 'eval_protocol', 'batch': batch, 'samples': n,
            'samples_s': sps, 'protocol_2048_s': 2048 / sps,
            'protocol_2048_min': 2048 / sps / 60,
            'prd_s': prd_n, 'prd_2048_s': prd_2048,
            'protocol_2048_s_prd_once': (2048 * (wall - prd_n) / n
                                         + prd_2048),
            'generate_ms': gen_s * 1e3, 'embed_real_ms': real_s * 1e3,
            'embed_fake_ms': fake_s * 1e3, 'peak_memory_bytes': peak,
            'fvd': res['fvd'], 'prd': res['prd']}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('batch', nargs='?', type=int, default=16)
    p.add_argument('samples', nargs='?', type=int, default=64)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    os.environ['MMVID_ALLOW_RANDOM_I3D'] = '1'
    model = breakdown.build('flagship')
    res = measure_eval(model, args.batch, args.samples)
    print(json.dumps({'what': res['what'], 'batch': res['batch'],
                      'samples': res['samples'],
                      'samples_s': round(res['samples_s'], 2),
                      'protocol_2048_min': round(res['protocol_2048_min'],
                                                 1),
                      'device': torch.cuda.get_device_name(0)}),
          flush=True)


if __name__ == '__main__':
    main()
