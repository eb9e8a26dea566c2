#!/usr/bin/env python3
"""Test driver of the port: sampling grids and quantitative evaluation
(reference test.py:27-292).

The twin of the repository's ``test.py``, with the same CLI: the released
``scripts/mmvoxceleb/*/test.sh`` flags run unchanged as

    python -m mmvid_tpu_torch.test <the test.sh flags> [--device cpu]

Loads ``--dalle_path`` (a ``dalle.pt``, a checkpoint directory or a run
directory) or the latest checkpoint under ``<log_root>/<name>``; the
checkpoint's hparams override the model flags; seeds ``random`` and
``np.random`` from ``--seed``, loads deterministically, takes the first
batch (with ``--description`` as every caption, if given) and writes
``visualize_train`` grids into ``<log_root>/<name><suffix>/samples`` and,
with ``--use_html``, the page.  The sampler: mask-predict, ART-V for an
``ar`` checkpoint or ``--ar``, ``--ar --spec K`` (the exact speculative
decode, with JAX's refusals), ``--int8`` (``quantize_for_serving``, or
ART-V's int8 decode).

``--eval_mode eval`` (``scripts/mmvoxceleb/text_to_video/evaluation.sh``)
runs the quantitative evaluation at batch 16, as the root ``test.py``
does: ``--eval_metric fvd``, ``prd`` or ``fvd_prd`` through
``eval.evaluate.evaluate`` (I3D from ``I3D_CHECKPOINT``, an ``.npz`` of
the TF-Hub variables; random weights only with
``MMVID_ALLOW_RANDOM_I3D=1``), ``clip`` through ``evaluate_clip`` with the
scorer of ``--openai_clip_model_path``; the artifacts go to
``<log_root>/<name><suffix>/metrics``.  ``--eval_mode long`` (the root
``test.py``:188-205) samples the first batch as a long video,
``--long_mode long`` (``--t_repeat`` windows overlapping by
``--t_overlap`` frames), ``interp`` (``--t_repeat`` - 1 doubling levels)
or ``interp_real`` (the batch's own clips interpolated), through
``utils.viz.visualize_long`` into ``<log_root>/<name><suffix>/long``;
``--save_codebook`` writes the video's VQGAN ids to
``codebook_long.npy`` beside it.  An ART-V checkpoint takes the mode's
calls and ignores their preserved frames, as JAX's ``generate_images``
does (``**unused``): every window is a fresh sample.

A checkpoint of a fixed-LM model (``--fixed_language_model roberta-large``,
the text_augment recipe) samples from its captions' RoBERTa features
(``factories.get_fixed_language_model``, weights from ``ROBERTA_PATH``);
``--eval_mode eval`` and ``long`` raise for it, since JAX's evaluation and
long videos feed text ids and never build the language model (ROADMAP.md
queue A, item A9).
"""

from __future__ import annotations

import os
import random
import time
from pathlib import Path

import numpy as np

def main(argv=None):
    from mmvid_tpu_torch.config import process_args
    return main_worker(process_args(train=False, argv=argv))


def main_worker(args):
    """Sample as ``args`` say; returns the samples directory and the
    seconds ``visualize_train`` took (``{'sample_dir', 'sample_s'}``),
    with ``--eval_mode eval`` the metrics (:func:`run_eval`), with
    ``--eval_mode long`` :func:`run_long`'s record."""
    from mmvid_tpu_torch import factories
    from mmvid_tpu_torch.data.loader import DataLoader, infinite_batches
    from mmvid_tpu_torch.generate import HPARAM_KEYS
    from mmvid_tpu_torch.train import (
        load_dalle_weights,
        refuse_multi_device,
        resolve_device,
    )
    from mmvid_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
    )

    # MMVID_ARTV_SPEC_FORCE accepts every speculative draft — a bench-only
    # ceiling knob whose output is garbage by design (artv_spec.py)
    if (os.environ.get('MMVID_ARTV_SPEC_FORCE') == '1'
            and not args.bench_unsafe):
        raise SystemExit(
            'MMVID_ARTV_SPEC_FORCE=1 is a bench-only ceiling knob that '
            'accepts all speculative drafts — outputs would be garbage. '
            'Unset it, or pass --bench_unsafe if you really are '
            'benchmarking through this CLI.')
    refuse_multi_device(args)
    device = resolve_device(args.device)

    random.seed(args.seed)
    np.random.seed(args.seed)
    args.deterministic = True
    args.batch_size = 16 if args.eval_mode == 'eval' else args.batch_size
    log_dir = Path(args.log_root) / (args.name + args.name_suffix)
    args.log_metric_dir = str(log_dir / 'metrics')

    # ---- checkpoint discovery (reference test.py:51-57) ----
    ckpt_path = args.dalle_path
    if ckpt_path is None:
        train_dir = Path(args.log_root) / args.name
        ckpt_path = latest_checkpoint(str(train_dir))
        if ckpt_path is None:
            raise FileNotFoundError(f'no checkpoint under {train_dir}')
    print(f'loading checkpoint {ckpt_path}')
    ckpt, hparams = load_checkpoint(str(ckpt_path))
    # hparams frozen into the checkpoint override CLI (train.py:160-174)
    for k in HPARAM_KEYS:
        if hparams.get(k) is not None:
            setattr(args, k, hparams[k])
    if (args.fixed_language_model is not None
            and args.eval_mode in ('eval', 'long')):
        raise NotImplementedError(
            f'--eval_mode {args.eval_mode} of a fixed-LM model: JAX\'s '
            'evaluation and long videos feed text ids and never build the '
            'language model (ROADMAP.md queue A, item A9)')
    if args.spec:
        if not args.ar:
            raise SystemExit('--spec requires --ar (speculative decode '
                             'accelerates the autoregressive sampler)')
        if args.int8:
            raise SystemExit('--spec is a bf16 decode path; drop --int8')

    tokenizer = factories.get_tokenizer(args)
    encode, text_feature_dim = None, 0
    if args.fixed_language_model is not None:
        encode, text_feature_dim = factories.get_fixed_language_model(
            args, device)
    weights = ckpt['weights']
    use_cvae = args.use_cvae or any(k.startswith('cvae.') for k in weights)
    model = factories.get_driver_model(args, device, use_cvae=use_cvae,
                                       training=False,
                                       text_feature_dim=text_feature_dim
                                       ).eval()
    load_dalle_weights(model, weights)
    generate_kw = {}
    if args.int8:
        if args.ar:
            # ART-V int8 serving lives inside ar_sample (int8 weights +
            # int8 KV caches)
            generate_kw['int8'] = True
            print('int8: ART-V decode (int8 weights + int8 KV caches)')
        else:
            from mmvid_tpu_torch.ops.int8 import quantize_for_serving
            model = quantize_for_serving(model)
            print('int8: backbone quantized (w8a8, calibrated static '
                  'scales)')

    dataset = factories.get_dataset(args, tokenizer)
    print(f'{len(dataset)} samples found')
    if len(dataset) == 0:
        raise SystemExit(
            'dataset is empty after filtering (e.g. every clip shorter '
            'than the min_len=8 frame requirement)')
    loader = DataLoader(dataset, batch_size=args.batch_size,
                        shuffle=not args.deterministic,
                        num_workers=min(args.num_workers, 16),
                        seed=args.seed, drop_last=True)
    if generate_kw:
        model.generate_images = _with_defaults(model.generate_images,
                                               generate_kw)
    flag = os.environ.get('MMVID_ARTV_SPEC')
    if args.spec:   # ar_sample reads it at every call
        os.environ['MMVID_ARTV_SPEC'] = str(args.spec)
        print(f'speculative AR decode: chunks of {args.spec} '
              f'copy-previous-frame drafts, exact verification')
    try:
        if args.eval_mode == 'eval':
            return run_eval(args, model, tokenizer,
                            infinite_batches(loader), device)
        if args.eval_mode == 'long':
            return run_long(args, model, tokenizer, loader, device, log_dir)
        return _visualize(args, model, tokenizer, loader, device, log_dir,
                          encode)
    finally:
        if args.spec and flag is None:
            os.environ.pop('MMVID_ARTV_SPEC', None)
        elif args.spec:
            os.environ['MMVID_ARTV_SPEC'] = flag


def _first_batch(args, tokenizer, loader):
    """The loader's first batch, with ``--description`` as every caption
    if given."""
    from mmvid_tpu_torch.data.loader import infinite_batches
    batch = next(infinite_batches(loader))
    if args.description is not None:
        batch['text'] = tokenizer.tokenize(
            [args.description] * args.batch_size, args.text_seq_len,
            truncate_text=True)
        batch['description'] = [args.description] * args.batch_size
    return batch


def run_long(args, model, tokenizer, loader, device, log_dir):
    """``--eval_mode long`` as the root ``test.py`` runs it (:188-205): the
    first batch through ``visualize_long`` at the first
    ``--mask_predict_steps``; with ``--save_codebook`` the video's ids
    (``model.get_image_tokens``) in ``codebook_long.npy``.  Returns
    ``{'long_dir', 'video' [B, F, H, W, 3] on the host, 'long_s'}``, the
    seconds ``visualize_long`` took."""
    from mmvid_tpu_torch.train import VIZ_SALT, step_generator
    from mmvid_tpu_torch.utils.viz import video_tokens, visualize_long

    batch = _first_batch(args, tokenizer, loader)
    out_dir = str(log_dir / 'long')
    t = time.perf_counter()
    video = visualize_long(
        model, batch, step_generator(args.seed, 0, VIZ_SALT, device),
        out_dir, long_mode=args.long_mode, t_repeat=args.t_repeat,
        t_overlap=args.t_overlap,
        mask_predict_steps=args.mask_predict_steps[0],
        mp_config=args.mp_config)
    long_s = time.perf_counter() - t
    if args.save_codebook:
        np.save(str(log_dir / 'codebook_long.npy'),
                video_tokens(model, video).cpu().numpy())
    print(f'wrote {video.shape[1]}-frame videos to {out_dir}')
    return {'long_dir': out_dir, 'video': video, 'long_s': long_s}


def _visualize(args, model, tokenizer, loader, device, log_dir,
               encode=None):
    """The sampling grids of the first batch (reference visualize_test);
    ``encode``: the fixed language model's, whose features of the
    captions are the text."""
    from mmvid_tpu_torch.train import VIZ_SALT, step_generator
    from mmvid_tpu_torch.utils.viz import visualize_train

    batch = _first_batch(args, tokenizer, loader)
    if encode is not None:
        batch['text'] = encode(batch['description'])
    webpage = None
    if args.use_html:
        from mmvid_tpu_torch.utils.html import initialize_webpage
        webpage = initialize_webpage(str(log_dir / 'web'),
                                     'MMVID-TPU test: ' + args.name, False)
    sample_dir = log_dir / 'samples'
    t = time.perf_counter()
    visualize_train(model, batch,
                    step_generator(args.seed, 0, VIZ_SALT, device),
                    str(sample_dir), 0, n_sample=args.n_sample,
                    n_per_sample=args.n_per_sample,
                    mask_predict_steps=args.mask_predict_steps,
                    mask_predict_steps1=args.mask_predict_steps1,
                    vc_mode=args.vc_mode, rand_visual=args.rand_visual,
                    counterfactual=(args.num_visuals > 0),
                    debug=args.debug, test_mode=args.test_mode,
                    webpage=webpage, mp_config=args.mp_config)
    print(f'wrote samples to {sample_dir}')
    return {'sample_dir': str(sample_dir),
            'sample_s': time.perf_counter() - t}


def run_eval(args, model, tokenizer, dl_iter, device):
    """``--eval_mode eval`` as the root ``test.py`` runs it (:156-187):
    FVD and / or PRD through ``evaluate``, the CLIP score through
    ``evaluate_clip``; returns the results ({'fvd', 'prd', 'clip'})."""
    from mmvid_tpu_torch.eval.evaluate import evaluate, evaluate_clip
    i3d_vars = None
    i3d_path = os.environ.get('I3D_CHECKPOINT')
    if i3d_path:
        from mmvid_tpu_torch.eval.i3d import load_i3d_checkpoint
        i3d_vars = load_i3d_checkpoint(i3d_path)
    metrics = []
    if any('fvd' in m for m in args.eval_metric):
        metrics.append('fvd')
    if any('prd' in m for m in args.eval_metric):
        metrics.append('prd')
    clip = any('clip' in m for m in args.eval_metric)
    results = {}
    if metrics or not clip:
        results = evaluate(args, model, dl_iter, i3d_variables=i3d_vars,
                           metrics=metrics or ('fvd', 'prd'))
    if clip:
        from mmvid_tpu_torch.models.clip_full import load_clip_scorer
        scorer = load_clip_scorer(args.openai_clip_model_path, device=device)

        def encode_text(descriptions):
            toks = tokenizer.tokenize(list(descriptions), 77,
                                      truncate_text=True)
            return scorer.encode_text(toks).cpu().numpy()

        results['clip'] = evaluate_clip(
            args, model, dl_iter, (encode_text, scorer.encode_image))
    print(results)
    return results


def _with_defaults(fn, defaults):
    def call(*a, **kw):
        return fn(*a, **{**defaults, **kw})
    return call


if __name__ == '__main__':
    main()
