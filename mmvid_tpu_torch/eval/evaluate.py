"""Quantitative evaluation (reference utils/utils_eval.py), the port's
counterpart of ``mmvid_tpu/eval/evaluate.py``.

:func:`evaluate`: ``eval_num / batch`` batches: sample videos,
ping-pong-extend real and fake to 15 or 16 frames, embed both with I3D,
save ``real_embs.npy`` / ``fake_embs.npy``, report FVD and PRD to
``fvd_score.txt`` (with ``n_samples``), ``prd_data.pkl`` and
``prd_score.txt`` (utils_eval.py:31-219).

:func:`evaluate_clip`: per-frame CLIP similarity, the max over frames,
mean +/- std to ``clip_score.txt`` (utils_eval.py:226-323, with the
reference's call of the missing ``generate_images_debug`` replaced by the
normal generation, as in JAX).

Generated videos never visit the host: the ping-pong extension is a gather
on the device (indices per source clip length, since real clips have
``frame_num`` frames and generated ones ``num_targets``), then the
preprocessing and I3D; only the [B, 400] embeddings come back.  I3D runs
in fp32 with TF32 off (:func:`fp32_exact`), as JAX runs eval in fp32.
"""

from __future__ import annotations

import os
import pickle
import warnings
from pathlib import Path

import numpy as np
import torch

from mmvid_tpu_torch.eval import prd as prd_mod
from mmvid_tpu_torch.eval.fvd import (
    frechet_distance,
    pingpong_indices,
    preprocess_videos,
)
from mmvid_tpu_torch.ops.precision import fp32_exact


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def build_i3d(args, i3d_variables, device):
    """The I3D of ``i3d_variables`` (JAX's trees, e.g. from
    ``i3d.load_i3d_checkpoint``) on ``device``; without them a random one,
    only with ``args.allow_random_i3d`` or ``MMVID_ALLOW_RANDOM_I3D``."""
    from mmvid_tpu_torch.eval.i3d import I3D, init_random
    from mmvid_tpu_torch.weights import load_conv_bn_variables
    i3d = I3D()
    if i3d_variables is None:
        # A random-weight I3D produces MEANINGLESS FVD/PRD numbers; refuse
        # unless the caller explicitly opts in (pipeline tests), so nobody
        # mistakes a smoke run for a measurement.
        if not (getattr(args, 'allow_random_i3d', False)
                or os.environ.get('MMVID_ALLOW_RANDOM_I3D')):
            raise RuntimeError(
                'No I3D weights: set I3D_CHECKPOINT=<converted kinetics '
                'checkpoint .npz> (see mmvid_tpu_torch.eval.i3d.'
                'load_i3d_checkpoint) to compute a real FVD, or set '
                'MMVID_ALLOW_RANDOM_I3D=1 to run the pipeline with random '
                'weights (numbers NOT comparable to the reference).')
        warnings.warn('evaluate(): running with RANDOM I3D weights — '
                      'FVD/PRD numbers are not comparable to the '
                      'reference.', stacklevel=3)
        init_random(i3d, torch.Generator().manual_seed(0))
    else:
        load_conv_bn_variables(i3d, i3d_variables)
    return i3d.to(device).eval()


class VideoEmbedder:
    """I3D activations of [B, T, H, W, 3] clips in [0, 1], on the clips'
    device: the ping-pong gather to ``video_length`` frames (indices made
    once per source length), the TF1 resize to 224, I3D in fp32."""

    def __init__(self, i3d, video_length: int):
        self.i3d, self.video_length = i3d, video_length
        self._idx = {}

    @torch.no_grad()
    def __call__(self, videos: torch.Tensor) -> torch.Tensor:
        t = int(videos.shape[1])
        idx = self._idx.get((t, videos.device))
        if idx is None:
            idx = torch.as_tensor(pingpong_indices(t, self.video_length),
                                  device=videos.device)
            self._idx[(t, videos.device)] = idx
        with fp32_exact():
            v = videos.float().index_select(1, idx)
            return self.i3d.embed(preprocess_videos(v))


def _mask_predict_steps(args):
    steps = getattr(args, 'mask_predict_steps', None)
    return steps[0] if steps else 0


def evaluate(args, model, dl_iter, i3d_variables=None, generator=None,
             metrics=('fvd', 'prd')):
    """Returns {'fvd': float, 'prd': (F8, F1/8)} and writes the artifacts
    to ``args.log_metric_dir``; ``generator`` (on the model's device,
    seeded from ``args.seed`` unless given) draws the samples."""
    device = model_device(model)
    out_dir = Path(getattr(args, 'log_metric_dir', 'metrics'))
    out_dir.mkdir(parents=True, exist_ok=True)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(args.seed)

    video_length = 15 if args.num_targets < 16 else 16
    total = args.eval_num
    batch = args.batch_size
    embed = VideoEmbedder(build_i3d(args, i3d_variables, device),
                          video_length)

    real_embs, fake_embs = [], []
    steps = max(total // batch, 1)
    n_actual = steps * batch
    if n_actual != total:
        # no silent caps: eval_num not divisible by batch under-samples
        # (the reference truncates here too, utils_eval.py:86-96)
        print(f'evaluate: eval_num={total} not divisible by '
              f'batch={batch}; using {n_actual} samples')
    for _ in range(steps):
        sample = next(dl_iter)
        text = torch.as_tensor(np.asarray(sample['text']),
                               device=device).long()
        frames = torch.as_tensor(np.asarray(sample['target']),
                                 device=device)
        visual = (torch.as_tensor(np.asarray(sample['visual']),
                                  device=device)
                  if model.cfg.num_visuals > 0 and 'visual' in sample
                  else None)
        with torch.no_grad():
            fake, _ = model.generate_images(
                generator, text, visual=visual,
                mask_predict_steps=_mask_predict_steps(args),
                dynamic=getattr(args, 'pnag_dynamic', False),
                mp_config=args.mp_config)
        real_embs.append(embed(frames).cpu().numpy())
        fake_embs.append(embed(fake).cpu().numpy())

    real_embs = np.concatenate(real_embs)
    fake_embs = np.concatenate(fake_embs)
    np.save(out_dir / 'real_embs.npy', real_embs)
    np.save(out_dir / 'fake_embs.npy', fake_embs)

    results = {}
    if 'fvd' in metrics:
        fvd = frechet_distance(real_embs, fake_embs)
        results['fvd'] = fvd
        # the sample count beside the score, so a non-divisible
        # eval_num / batch pair shows in the artifact
        (out_dir / 'fvd_score.txt').write_text(
            f'{fvd}\nn_samples = {len(fake_embs)}\n')
    if 'prd' in metrics:
        # 20 clusters like the reference, clamped for tiny smoke evals
        n_clusters = min(20, len(fake_embs))
        p, r = prd_mod.compute_prd_from_embedding(
            fake_embs, real_embs, num_clusters=n_clusters,
            rng=np.random.default_rng(args.seed))
        pair = prd_mod.prd_to_max_f_beta_pair(p, r)
        results['prd'] = pair
        with open(out_dir / 'prd_data.pkl', 'wb') as f:
            pickle.dump({'precision': p, 'recall': r}, f)
        (out_dir / 'prd_score.txt').write_text(
            f'F_8 = {pair[0]}, F_1/8 = {pair[1]}\n')
    return results


def evaluate_clip(args, model, dl_iter, clip_encoders, generator=None):
    """CLIP score: the max over frames of the image-text similarity, mean
    and std over the samples (utils_eval.py:226-323).

    ``clip_encoders``: (encode_text(descriptions) -> [B, D] numpy,
    encode_image(frames [B, H, W, 3] in [0, 1]) -> [B, D])."""
    encode_text, encode_image = clip_encoders
    device = model_device(model)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(args.seed)
    scores = []
    steps = max(args.eval_num // args.batch_size, 1)
    for _ in range(steps):
        sample = next(dl_iter)
        text = torch.as_tensor(np.asarray(sample['text']),
                               device=device).long()
        with torch.no_grad():
            fake, _ = model.generate_images(
                generator, text, mp_config=args.mp_config,
                mask_predict_steps=_mask_predict_steps(args))
        t_emb = np.asarray(encode_text(sample['description']))
        t_emb = t_emb / np.linalg.norm(t_emb, axis=-1, keepdims=True)
        per_frame = []
        with fp32_exact():
            for f in range(fake.shape[1]):
                i_emb = torch.as_tensor(encode_image(fake[:, f].float())
                                        ).cpu().numpy()
                i_emb = i_emb / np.linalg.norm(i_emb, axis=-1,
                                               keepdims=True)
                per_frame.append((t_emb * i_emb).sum(-1))
        scores.append(np.max(np.stack(per_frame), axis=0))
    scores = np.concatenate(scores)
    out_dir = Path(getattr(args, 'log_metric_dir', 'metrics'))
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / 'clip_score.txt').write_text(
        f'{scores.mean()} +/- {scores.std()}\n')
    return float(scores.mean()), float(scores.std())
