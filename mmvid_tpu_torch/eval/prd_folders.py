"""Standalone PRD between two image folders.

The port's counterpart of ``mmvid_tpu/eval/prd_folders.py`` (reference:
precision_recall_distributions/prd_from_image_folders.py:70-141, which
embeds with a frozen TF-slim Inception pool_3 graph).  Embedders:

* ``inception``: InceptionV3 pool_3 (the reference's embedder; a TF-slim
  checkpoint, or an ``.npz`` of its variables, through
  ``--inception_path``; random weights without one);
* ``clip``: the CLIP image tower (``--clip_path ViT-B-32.pt``);
* ``pixels``: raw pixels resized to 16x16 (a weight-free baseline).

Images are read without Pillow (``data/transforms.py``: PNG, PPM/PGM,
JPEG and BMP)
and resized to 224x224 as Pillow's bilinear.  Runs on the card unless
``--device cpu``:

    python -m mmvid_tpu_torch.eval.prd_folders --reference_dir A \\
        --eval_dirs B C --embedder clip --clip_path ViT-B-32.pt
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np
import torch

from mmvid_tpu_torch.eval import prd


IMG_EXTS = ('.png', '.jpg', '.jpeg', '.bmp')


def list_images(folder: str) -> List[str]:
    return sorted(
        os.path.join(folder, f) for f in os.listdir(folder)
        if f.lower().endswith(IMG_EXTS))


def load_images(paths: List[str], size: int = 224) -> np.ndarray:
    from mmvid_tpu_torch.data.transforms import (
        open_rgb,
        resize_exact,
        to_array,
    )
    return np.stack([to_array(resize_exact(open_rgb(p), (size, size)))
                     for p in paths])


def make_embedder(kind: str, clip_path: str | None = None, batch: int = 32,
                  inception_path: str | None = None, device='cuda'):
    """images01 [N, H, W, 3] numpy -> [N, D] numpy, on ``device``."""
    device = torch.device(device)
    if kind == 'inception':
        from mmvid_tpu_torch.eval.i3d import init_random
        from mmvid_tpu_torch.eval.inception import (
            InceptionV3,
            inception_preprocess,
            load_inception_checkpoint,
        )
        from mmvid_tpu_torch.ops.precision import fp32_exact
        from mmvid_tpu_torch.weights import load_conv_bn_variables
        model = InceptionV3()
        if inception_path:
            load_conv_bn_variables(model,
                                   load_inception_checkpoint(inception_path))
        else:
            init_random(model, torch.Generator().manual_seed(0))
        model = model.to(device).eval()

        @torch.no_grad()
        def embed(images01: np.ndarray) -> np.ndarray:
            outs = []
            with fp32_exact():
                for i in range(0, len(images01), batch):
                    x = torch.as_tensor(images01[i:i + batch], device=device)
                    outs.append(model.embed(inception_preprocess(x)).cpu()
                                .numpy())
            return np.concatenate(outs)

        return embed
    if kind == 'clip':
        from mmvid_tpu_torch.ops.precision import fp32_exact
        from mmvid_tpu_torch.models.clip_full import load_clip_scorer
        scorer = load_clip_scorer(clip_path, device=device)

        def embed(images01: np.ndarray) -> np.ndarray:
            outs = []
            with fp32_exact():
                for i in range(0, len(images01), batch):
                    outs.append(scorer.encode_image(
                        images01[i:i + batch]).cpu().numpy())
            return np.concatenate(outs)

        return embed
    if kind == 'pixels':
        from mmvid_tpu_torch.utils.resize import resize_bilinear

        def embed(images01: np.ndarray) -> np.ndarray:
            x = resize_bilinear(torch.as_tensor(images01, device=device),
                                16, 16)
            return x.reshape(x.shape[0], -1).cpu().numpy()

        return embed
    raise NotImplementedError(kind)


def compute_folder_prd(reference_dir: str, eval_dirs: List[str],
                       embedder, num_clusters: int = 20,
                       num_runs: int = 10, seed: int = 0):
    ref_paths = list_images(reference_dir)
    rng = np.random.default_rng(seed)
    results = []
    for d in eval_dirs:
        eval_paths = list_images(d)
        n = min(len(ref_paths), len(eval_paths))
        ref_emb = embedder(load_images(ref_paths[:n]))
        eval_emb = embedder(load_images(eval_paths[:n]))
        p, r = prd.compute_prd_from_embedding(
            eval_emb, ref_emb, num_clusters=min(num_clusters, n),
            num_runs=num_runs, rng=rng)
        results.append((p, r))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--reference_dir', required=True)
    ap.add_argument('--eval_dirs', nargs='+', required=True)
    ap.add_argument('--embedder', default='inception',
                    choices=['inception', 'clip', 'pixels'])
    ap.add_argument('--clip_path', default='ViT-B-32.pt')
    ap.add_argument('--inception_path', default=None,
                    help='TF-slim InceptionV3 checkpoint (or .npz)')
    ap.add_argument('--num_clusters', type=int, default=20)
    ap.add_argument('--num_runs', type=int, default=10)
    ap.add_argument('--seed', type=int, default=0,
                    help="seeds the k-means starts")
    ap.add_argument('--plot_path', default=None)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    if args.device.startswith('cuda') and not torch.cuda.is_available():
        raise SystemExit('--device cuda: no GPU is visible; pass '
                         '--device cpu to run on the CPU')
    embedder = make_embedder(args.embedder, args.clip_path,
                             inception_path=args.inception_path,
                             device=args.device)
    results = compute_folder_prd(args.reference_dir, args.eval_dirs,
                                 embedder, args.num_clusters, args.num_runs,
                                 args.seed)
    for d, (p, r) in zip(args.eval_dirs, results):
        f8, f18 = prd.prd_to_max_f_beta_pair(p, r)
        print(f'{d}: F_8={f8:.4f} F_1/8={f18:.4f}')
    if args.plot_path:
        prd.plot(results, labels=args.eval_dirs, out_path=args.plot_path)
    return results


if __name__ == '__main__':
    main()
