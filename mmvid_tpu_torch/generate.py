#!/usr/bin/env python3
"""Batch generation CLI of the port: prompts in, videos out.

Counterpart of the repository's ``generate.py``: mask-predict sampling,
and ART-V with ``--ar`` or for a checkpoint whose hparams say ``ar``
(they override the flag, as in the JAX CLI); ``--int8`` calibrates a
mask-predict model at load and serves it w8a8
(``ops.int8.quantize_for_serving``), or runs ART-V's int8 decode;
``--ar --spec K`` samples ART-V by the exact speculative decode
(``models/artv_spec.py``, K drafts a chunk) and prints the tokens a chunk
forward committed.
Loads a reference ``dalle.pt`` once, then streams prompt batches through
the model's ``generate_images``, padding the last batch to the static
batch size.

Usage:
    python -m mmvid_tpu_torch.generate --dalle_path run/dalle.pt \\
        --prompts "a person with wavy hair is talking" --out_dir out/ \\
        --format gif
    python -m mmvid_tpu_torch.generate --dalle_path ... --prompt_file p.txt
    MMVID_ATTN_INT8=1 python -m mmvid_tpu_torch.generate --dalle_path ... \\
        --prompts "a man is smiling" --int8
    python -m mmvid_tpu_torch.generate --dalle_path ... --ar --spec 8 \\
        --prompts "a man is smiling"

``load_model`` and ``generate_videos`` need only torch and numpy;
``main`` also writes files through ``mmvid_tpu_torch.utils.html``, whose
writers import PIL or imageio when they write.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path
from typing import Iterator, List, NamedTuple, Optional

import torch

from mmvid_tpu_torch import factories
from mmvid_tpu_torch.models.mmvid import DEFAULT_MP_CONFIG
from mmvid_tpu_torch.ops.int8 import quantize_for_serving
from mmvid_tpu_torch.tokenizer import SimpleTokenizer
from mmvid_tpu_torch.utils.html import (
    save_gif,
    save_image_array,
    save_mp4,
    tile_video_row,
)
from mmvid_tpu_torch.weights import load_weights, read_dalle_checkpoint

_HPARAM_KEYS = ('dim', 'text_seq_len', 'num_targets', 'num_visuals',
                'which_transformer', 'image_size', 'insert_sep',
                'use_separate_visual_emb', 'fixed_language_model',
                'text_emb_bottleneck', 'loss_img_weight', 'ar')


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--dalle_path', required=True,
                   help='reference-format dalle.pt')
    p.add_argument('--prompts', nargs='*', default=None)
    p.add_argument('--prompt_file', default=None,
                   help='one prompt per line')
    p.add_argument('--out_dir', default='generated')
    p.add_argument('--format', default='gif', choices=['gif', 'mp4', 'png'])
    p.add_argument('--batch_size', type=int, default=16)
    p.add_argument('--mask_predict_steps', type=int, default=0,
                   help='0 = use mp_T (20)')
    p.add_argument('--dynamic', action='store_true')
    p.add_argument('--fps', type=int, default=4)
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--bf16', action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument('--device', default='cuda',
                   help="torch device; 'cpu' runs the plain versions of "
                        'the kernels')
    # model shape overrides for checkpoints without hparams
    p.add_argument('--dim', type=int, default=768)
    p.add_argument('--text_seq_len', type=int, default=50)
    p.add_argument('--num_targets', type=int, default=8)
    p.add_argument('--num_visuals', type=int, default=0)
    p.add_argument('--image_size', type=int, default=128)
    p.add_argument('--which_transformer', default='openai_clip_visual')
    p.add_argument('--vae_path', default=None,
                   help='taming VQGAN .ckpt, for a dalle.pt without '
                        'vae.model.* weights')
    p.add_argument('--fixed_language_model', default=None)
    p.add_argument('--text_emb_bottleneck', default=None)
    p.add_argument('--insert_sep', action='store_true')
    p.add_argument('--use_separate_visual_emb', action='store_true')
    p.add_argument('--loss_img_weight', type=int, default=7)
    p.add_argument('--ar', action='store_true',
                   help='sample as ART-V (checkpoint hparams override)')
    p.add_argument('--spec', type=int, default=0, metavar='K',
                   help='(with --ar) exact speculative decode: verify K '
                        'copy-previous-frame draft tokens a chunk forward '
                        '(models/artv_spec.py); the same output '
                        'distribution as the baseline, faster as the '
                        'served weights accept more drafts')
    p.add_argument('--bench_unsafe', action='store_true',
                   help='allow the benchmark-only MMVID_ARTV_SPEC_FORCE=1, '
                        'whose output is garbage by design')
    p.add_argument('--int8', action='store_true',
                   help='int8 serving: a mask-predict model is calibrated '
                        'at load and runs its backbone and VQGAN decoder '
                        'w8a8 (MMVID_ATTN_INT8=1 also quantizes its '
                        'attention); ART-V decodes with int8 weights and '
                        'K/V caches')
    return p.parse_args(argv)


def load_model(args):
    """(model on args.device in eval mode, tokenizer) from
    ``args.dalle_path``; the checkpoint's hparams override the shape
    flags, and ``ar`` among them builds ART-V."""
    ckpt = read_dalle_checkpoint(args.dalle_path)
    for k in _HPARAM_KEYS:
        if ckpt['hparams'].get(k) is not None:
            setattr(args, k, ckpt['hparams'][k])
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    weights = dict(ckpt['weights'])
    vae = factories.get_vae_model(args, dtype=dtype, device=args.device)
    cvae = None
    if any(k.startswith('cvae.model.') for k in weights):
        cvae = factories.get_vae_model(args, dtype=dtype,
                                       device=args.device)
    model = factories.get_dalle(args, vae, cvae, dtype=dtype,
                                device=args.device)
    if args.vae_path:
        sd = torch.load(args.vae_path, map_location='cpu',
                        weights_only=False)['state_dict']
        weights.update({f'vae.model.{k}': v for k, v in sd.items()
                        if not k.startswith(('loss.', 'colorize'))})
    load_weights(model, weights)
    model = model.eval()
    if getattr(args, 'int8', False) and not getattr(args, 'ar', False):
        model = quantize_for_serving(model)
    return model, SimpleTokenizer()


class Batch(NamedTuple):
    prompts: List[str]
    videos: torch.Tensor   # [len(prompts), T, H, W, 3] in [0, 1]
    tokens: torch.Tensor   # [len(prompts), T * n] int64
    steps: Optional[torch.Tensor] = None   # [len(prompts)]: spec_stats


def generate_videos(model, tokenizer, prompts, batch_size: int,
                    generator: torch.Generator, mask_predict_steps: int = 0,
                    dynamic: bool = False, mp_config=None,
                    int8: bool = False,
                    spec_stats: bool = False) -> Iterator[Batch]:
    """Yield one Batch per ``batch_size`` prompts; the last batch is
    padded with empty prompts to keep the batch shape static, and the
    padding is dropped from what is yielded.  ``generator`` lives on the
    model's device.  ``int8``: ART-V's int8 decode (a mask-predict model
    is quantized when it is built).  ``spec_stats`` (ART-V): each Batch
    carries the forwards each lane ran (``ArtvModel.generate_images``)."""
    device = next(model.parameters()).device
    cfg = model.cfg
    for i in range(0, len(prompts), batch_size):
        chunk = list(prompts[i:i + batch_size])
        pad = batch_size - len(chunk)
        toks = tokenizer.tokenize(chunk + [''] * pad, cfg.text_seq_len,
                                  truncate_text=True)
        text = torch.as_tensor(toks, dtype=torch.long).to(device)
        kw = {'int8': True} if int8 else {}
        if spec_stats:
            kw['spec_stats'] = True
        out = model.generate_images(
            generator, text, mask_predict_steps=mask_predict_steps,
            dynamic=dynamic, mp_config=mp_config or DEFAULT_MP_CONFIG, **kw)
        steps = out[2][:len(chunk)] if spec_stats else None
        yield Batch(chunk, out[0][:len(chunk)], out[1][:len(chunk)], steps)


def main(args=None):
    args = args or parse_args()
    # forced acceptance is a benchmark's ceiling, garbage by design: refused
    # in serving, as the JAX CLI refuses it
    if (os.environ.get('MMVID_ARTV_SPEC_FORCE') == '1'
            and not args.bench_unsafe):
        raise SystemExit(
            'MMVID_ARTV_SPEC_FORCE=1 is a bench-only ceiling knob that '
            'accepts all speculative drafts: generated videos would be '
            'garbage. Unset it, or pass --bench_unsafe if you really are '
            'benchmarking through this CLI.')
    prompts = list(args.prompts or [])
    if args.prompt_file:
        with open(args.prompt_file) as f:
            prompts += [line.strip() for line in f if line.strip()]
    if not prompts:
        raise SystemExit('no prompts given')
    model, tokenizer = load_model(args)
    if args.spec:
        if not args.ar:
            raise SystemExit('--spec requires --ar (speculative decode '
                             'speeds up the autoregressive sampler; '
                             'mask-predict is already parallel)')
        if args.int8:
            raise SystemExit('--spec is a bf16 decode path; drop --int8')
        print(f'speculative AR decode: chunks of {args.spec} '
              f'copy-previous-frame drafts, exact verification')
    flag = os.environ.get('MMVID_ARTV_SPEC')
    if args.spec:   # ar_sample reads it at every call
        os.environ['MMVID_ARTV_SPEC'] = str(args.spec)
    try:
        _write_videos(args, model, tokenizer, prompts)
    finally:
        if args.spec and flag is None:
            os.environ.pop('MMVID_ARTV_SPEC', None)
        elif args.spec:
            os.environ['MMVID_ARTV_SPEC'] = flag


def _write_videos(args, model, tokenizer, prompts):
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    generator = torch.Generator(device=args.device).manual_seed(args.seed)

    t0 = time.time()
    n_done = 0
    for batch in generate_videos(model, tokenizer, prompts, args.batch_size,
                                 generator, args.mask_predict_steps,
                                 args.dynamic,
                                 int8=args.int8 and args.ar,
                                 spec_stats=bool(args.spec)):
        if batch.steps is not None:
            # tokens committed a chunk forward on these weights and
            # prompts (1.0: no gain; spec + 1: every draft accepted)
            n_loop = model.cfg.target_seq_len - 1
            tpc = n_loop / batch.steps.clamp_min(1).double().cpu()
            print(f'  spec acceptance: {tpc.mean():.2f} tokens/chunk (min '
                  f'{tpc.min():.2f}, max {tpc.max():.2f}; ceiling '
                  f'{args.spec + 1})')
        videos = batch.videos.float().cpu().numpy()
        for j, (prompt, vid) in enumerate(zip(batch.prompts, videos)):
            stem = (f'{n_done + j:04d}_'
                    + '_'.join(prompt.split()[:6])[:48])
            if args.format == 'gif':
                save_gif(str(out_dir / f'{stem}.gif'), vid, args.fps)
            elif args.format == 'mp4':
                save_mp4(str(out_dir / f'{stem}.mp4'), vid, args.fps)
            else:
                save_image_array(str(out_dir / f'{stem}.png'),
                                 tile_video_row(vid))
            (out_dir / f'{stem}.txt').write_text(prompt)
        n_done += len(batch.prompts)
        fps = n_done * model.cfg.num_targets / (time.time() - t0)
        print(f'{n_done}/{len(prompts)} prompts ({fps:.1f} frames/sec '
              f'incl. IO)')
    print(f'wrote {n_done} videos to {out_dir}')


if __name__ == '__main__':
    main()
