"""Flagship training-step throughput: the twin of scripts/bench_train.py.

The full MSM / REL / VID step of the flagship text-to-video recipe (the
frozen VQGAN tokenizing the targets and the warped frame inside it) on
the training build (fp32 parameters, bf16 compute, each block
rematerialised), timed by ``breakdown.measure_train``: one warm-up step,
then 5 timed steps ending in a sync.  Prints one JSON line a batch, the
JAX script's keys (``what``, ``batch``, ``ms``, ``videos_s``,
``frames_s``, ``loss``).  Runs on the card unless ``--device cpu`` is
given:

    python -m mmvid_tpu_torch.bench_train 16
"""

from __future__ import annotations

import argparse
import json

import torch

from mmvid_tpu_torch import breakdown


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('batches', nargs='*', type=int, default=[8, 16])
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    if args.device == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device (or --device cpu)')
    model = breakdown.build_train('train', args.device)
    # each batch size starts from the same weights, as JAX's fresh state
    start = {k: v.clone() for k, v in model.core.state_dict().items()}
    for b in args.batches:
        model.core.load_state_dict(start)
        res = breakdown.measure_train(model, 'train', b, profiled=False)
        print(json.dumps({'what': res['what'], 'batch': b,
                          'ms': round(res['ms'], 1),
                          'videos_s': round(res['videos_s'], 2),
                          'frames_s': round(res['frames_s'], 1),
                          'loss': round(res['loss'], 3)}), flush=True)


if __name__ == '__main__':
    main()
