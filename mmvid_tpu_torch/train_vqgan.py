#!/usr/bin/env python3
"""VQGAN finetuning driver of the port, on one device.

The twin of the repository's ``train_vqgan.py`` (taming's Lightning
trainer, taming/models/vqgan.py:94-204), with its flags and defaults and
``--device`` (``cuda`` by default, which raises without a GPU):

    python -m mmvid_tpu_torch.train_vqgan --image_folder data/frames \\
        --image_size 128 --vae_path pretrained_models/vae_vox.ckpt

Each iteration draws ``--batch_size`` images with
``np.random.RandomState(seed).randint`` over the sorted image files under
``--image_folder``, read by ``data/transforms.py`` (PNG, JPEG or BMP, without Pillow)
and scaled to [-1, 1], then runs the generator step and the
discriminator step of ``models/vqgan_losses.py::VQGanTrainer``.  The log
line is JAX's.  LPIPS runs on ``--vgg_path``'s torchvision VGG16 weights,
else on seeded random ones, as JAX's does.  Checkpoints go every
``--save_every_n_steps`` and at the end to
``<log_root>/<name>/weights/<iter>/vqgan.ckpt`` and ``weights/last/``: a
taming ``.ckpt`` (``{'state_dict', 'global_step'}``, the VQModel under
taming's names), which ``--vae_path`` of this driver and of ``train.py``
read (``factories.taming_vqgan_state``).  JAX writes the same weights as
orbax directories; neither saves the discriminator or resumes.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

CKPT_FILE = 'vqgan.ckpt'
IMAGE_SUFFIXES = ('.png', '.jpg', '.jpeg', '.bmp')


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--image_folder', required=True,
                   help='folder of images (recursive) or video frame tree')
    p.add_argument('--image_size', type=int, default=128)
    p.add_argument('--vae_path', type=str, default=None,
                   help='taming .ckpt to finetune from')
    p.add_argument('--vgg_path', type=str, default=None,
                   help='torchvision vgg16 state_dict for LPIPS')
    p.add_argument('--name', default='vqgan_finetune')
    p.add_argument('--log_root', default='logs')
    p.add_argument('--batch_size', type=int, default=8)
    p.add_argument('--iters', type=int, default=10000)
    p.add_argument('--learning_rate', type=float, default=4.5e-6)
    p.add_argument('--disc_start', type=int, default=0)
    p.add_argument('--disc_weight', type=float, default=0.8)
    p.add_argument('--codebook_weight', type=float, default=1.0)
    p.add_argument('--save_every_n_steps', type=int, default=2000)
    p.add_argument('--log_every', type=int, default=100)
    p.add_argument('--num_workers', type=int, default=8)
    p.add_argument('--seed', type=int, default=42)
    # architecture overrides (defaults = the shipped vqgan.1024 config)
    p.add_argument('--ch', type=int, default=128)
    p.add_argument('--ch_mult', type=str, default='1,1,2,2,4')
    p.add_argument('--num_res_blocks', type=int, default=2)
    p.add_argument('--z_channels', type=int, default=256)
    p.add_argument('--embed_dim', type=int, default=256)
    p.add_argument('--n_embed', type=int, default=1024)
    p.add_argument('--attn_resolutions', type=str, default='16')
    p.add_argument('--device', default='cuda',
                   help="torch device; 'cuda' raises without a GPU")
    return p.parse_args(argv)


def build_trainer(args, device):
    """The trainer of ``args`` on ``device``: the VQModel and the
    discriminator drawn from ``--seed`` (``VQGanTrainer.init_weights``),
    the VQModel then from ``--vae_path`` where given, LPIPS on
    ``--vgg_path``'s weights or seeded random ones."""
    from mmvid_tpu_torch import factories
    from mmvid_tpu_torch.models.lpips import LPIPS, vgg16_state_to_port
    from mmvid_tpu_torch.models.vqgan import VQGanConfig
    from mmvid_tpu_torch.models.vqgan_losses import (
        VQGanLossConfig,
        VQGanTrainer,
    )
    from mmvid_tpu_torch.weights import load_weights

    lpips = None
    if args.vgg_path:
        lpips = LPIPS(vgg16_state_to_port(torch.load(
            args.vgg_path, map_location='cpu', weights_only=True)))
    cfg = VQGanConfig(
        resolution=args.image_size, ch=args.ch,
        ch_mult=tuple(int(x) for x in args.ch_mult.split(',')),
        num_res_blocks=args.num_res_blocks, z_channels=args.z_channels,
        embed_dim=args.embed_dim, n_embed=args.n_embed,
        attn_resolutions=tuple(int(x) for x in
                               args.attn_resolutions.split(',') if x))
    lc = VQGanLossConfig(disc_start=args.disc_start,
                         disc_weight=args.disc_weight,
                         codebook_weight=args.codebook_weight,
                         learning_rate=args.learning_rate)
    trainer = VQGanTrainer(cfg, lc, lpips=lpips, device=device)
    trainer.init_weights(torch.Generator().manual_seed(args.seed))
    if args.vae_path:
        load_weights(trainer.model, factories.taming_vqgan_state(
            args.vae_path))
    return trainer


def image_paths(folder):
    """Every image under ``folder``, sorted."""
    return sorted(p for p in Path(folder).rglob('*')
                  if p.suffix.lower() in IMAGE_SUFFIXES)


def image_batch(paths, rng: np.random.RandomState, batch_size: int,
                image_size: int) -> np.ndarray:
    """``batch_size`` images drawn by ``rng`` from ``paths``, resized to
    ``image_size``: [B, S, S, 3] float32 in [-1, 1]."""
    from mmvid_tpu_torch.data.transforms import (
        open_rgb,
        resize_exact,
        to_array,
    )
    idx = rng.randint(0, len(paths), batch_size)
    imgs = [to_array(resize_exact(open_rgb(paths[i]),
                                  (image_size, image_size)))
            for i in idx]
    return np.stack(imgs) * 2.0 - 1.0


def checkpoint_payload(model, it: int) -> dict:
    """A taming ``.ckpt`` of ``model`` (a VQModel) at iteration ``it``."""
    return {'state_dict': {k: v.detach().float().cpu()
                           for k, v in model.state_dict().items()},
            'global_step': int(it)}


def main(args=None):
    """Finetune as ``args`` say; returns the run's record: per iteration
    the image read's and the steps' seconds (``load_s``, ``step_s``, the
    latter up to the metrics' read on a logged iteration), and the saved
    files."""
    from mmvid_tpu_torch.train import resolve_device
    from mmvid_tpu_torch.utils.checkpoint import save_file

    args = args or parse_args()
    device = resolve_device(args.device)
    log_dir = Path(args.log_root) / args.name
    log_dir.mkdir(parents=True, exist_ok=True)
    trainer = build_trainer(args, device)

    paths = image_paths(args.image_folder)
    if not paths:
        raise FileNotFoundError(f'no images under {args.image_folder}')
    rng = np.random.RandomState(args.seed)
    print(f'{len(paths)} images found')
    record = {'iters': [], 'saves': []}

    def save(it):
        record['saves'].append(save_file(
            str(log_dir), it, checkpoint_payload(trainer.model, it),
            CKPT_FILE))

    t0 = time.time()
    for it in range(args.iters):
        t = time.perf_counter()
        x = torch.from_numpy(image_batch(
            paths, rng, args.batch_size, args.image_size)).permute(
            0, 3, 1, 2).contiguous().to(device)
        t_load = time.perf_counter()
        gm = trainer.g_step(x)
        dm = trainer.d_step(x)
        if it % args.log_every == 0:
            line = (f'iter {it} ae {float(gm["aeloss"]):.4f} '
                    f'nll {float(gm["nll"]):.4f} '
                    f'disc {float(dm["discloss"]):.4f} '
                    f'd_w {float(gm["d_weight"]):.3f} '
                    f'({time.time() - t0:.1f}s)')
            print(line)
            with open(log_dir / 'log.txt', 'a') as f:
                f.write(line + '\n')
        record['iters'].append({'load_s': t_load - t,
                                'step_s': time.perf_counter() - t_load})
        if it and it % args.save_every_n_steps == 0:
            save(it)
    save(args.iters)
    print('vqgan finetuning done')
    return record


if __name__ == '__main__':
    main()
