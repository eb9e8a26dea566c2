"""Pixel-space video warps in PyTorch: the negatives of the VID
(temporal-consistency) head, and the motion-color augmentation of visual
controls.

Counterpart of ``mmvid_tpu/models/warp.py``.  Four per-sample strategies,
chosen with ``vid_strategy_prob``:
  0: replace frame j1 with frame j2 of another batch element
  1: shuffle the frames (a permutation that is not the identity)
  2: additive color shift of frame j1 (all channels, or one)
  3: affine warp of frame j1 (rotation, translation, scale; bilinear with
     reflection padding, as ``jax.scipy.ndimage.map_coordinates``'s
     ``mode='reflect'``)

Every function is batched and takes its random draws as tensors (a dict,
see :func:`warp_draws` and :func:`color_draws`), so a test can feed it the
JAX package's draws; given a ``torch.Generator`` instead, it draws them
itself, on the video's device, with no read back to the host.  Videos are
[B, T, H, W, 3] in [0, 1].

``MMVID_TOKEN_WARP`` (read at every loss, default ``1``, as in JAX) makes
the VID branch re-encode only the one modified frame a sample
(:func:`warp_token_plan` and :func:`apply_warp_token_plan`, equal to
tokenizing :func:`warp`'s video, since the VQGAN encodes frame by frame).
"""

from __future__ import annotations

import math

import torch

from mmvid_tpu_torch.models.masking import _uniform

_AFFINE = dict(angle_deg=30.0, trans=0.1, scale=0.1)


def color_draws(generator, b: int, device=None) -> dict:
    """The draws of :func:`_color_shift_frame` for ``b`` samples: the
    shift c_shift ~ U(-0.5, 0.5) and which channels (0 all, 1-3 one)."""
    return {'c_shift': _uniform((b,), generator, device) - 0.5,
            'which': torch.randint(4, (b,), generator=generator,
                                   device=device)}


def warp_draws(generator, b: int, t: int,
               vid_strategy_prob=(0.25, 0.25, 0.25, 0.25),
               device=None) -> dict:
    """Every draw of :func:`warp` for ``b`` samples of ``t`` frames:
    strategy, j1, j2, i_other (another sample), perm (not the identity:
    an identity draw is rolled by one, as in JAX), the color shift's and
    the affine warp's parameters (angle in degrees, tx, ty, scale)."""
    probs = torch.as_tensor(vid_strategy_prob, dtype=torch.float32,
                            device=device)
    strategy = torch.multinomial(probs.expand(b, -1), 1,
                                 generator=generator)[:, 0]
    j1 = torch.randint(t, (b,), generator=generator, device=device)
    j2 = torch.randint(t, (b,), generator=generator, device=device)
    off = torch.randint(1, max(b, 2), (b,), generator=generator,
                        device=device)
    perm = _uniform((b, t), generator, device).argsort(-1)
    ident = (perm == torch.arange(t, device=device)).all(-1, keepdim=True)
    perm = torch.where(ident, perm.roll(1, -1), perm)
    a = _AFFINE
    return {'strategy': strategy, 'j1': j1, 'j2': j2,
            'i_other': (torch.arange(b, device=device) + off) % b,
            'perm': perm, **color_draws(generator, b, device),
            'angle': _uniform((b,), generator, device, -a['angle_deg'],
                              a['angle_deg']),
            'tx': _uniform((b,), generator, device, -a['trans'], a['trans']),
            'ty': _uniform((b,), generator, device, -a['trans'], a['trans']),
            'scale': _uniform((b,), generator, device, 1.0 - a['scale'],
                              1.0 + a['scale'])}


def _reflect(index, size: int):
    """``jax.scipy.ndimage``'s 'reflect' index fixer (half-sample
    symmetric: d c b a | a b c d | d c b a)."""
    s = 2 * size          # (2 * size + 1) - 1, the mirror's half-wave
    mirrored = ((2 * index + 1 + s) % (2 * s) - s).abs()
    return torch.div(mirrored - 1, 2, rounding_mode='floor')


def _affine_warp_frame(frames, angle, tx, ty, scale):
    """Rotate, translate and scale frames [B, H, W, 3]: angle in degrees,
    tx, ty, scale [B].  torch ``affine_grid``'s convention (output
    coordinates u, v in [-1, 1], input = theta @ [u, v, 1]), bilinear,
    reflection padding; the JAX package's arithmetic in its order."""
    b, h, w, _ = frames.shape
    dev = frames.device
    rad = angle * (math.pi / 180)
    cos, sin = torch.cos(rad)[:, None, None], torch.sin(rad)[:, None, None]
    s = scale[:, None, None]
    us = (torch.arange(w, device=dev) + 0.5) / w * 2.0 - 1.0
    vs = (torch.arange(h, device=dev) + 0.5) / h * 2.0 - 1.0
    v, u = torch.meshgrid(vs, us, indexing='ij')
    x_in = s * cos * u - s * sin * v + tx[:, None, None]
    y_in = s * sin * u + s * cos * v + ty[:, None, None]
    px = (x_in + 1.0) * 0.5 * w - 0.5
    py = (y_in + 1.0) * 0.5 * h - 0.5
    # map_coordinates, order 1: the four corners in (y, x) product order,
    # weights wy * wx, summed in that order
    y0, x0 = torch.floor(py), torch.floor(px)
    wy1, wx1 = py - y0, px - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    y0, x0 = y0.long(), x0.long()
    bi = torch.arange(b, device=dev)[:, None, None]
    out = None
    for yi, wy in ((y0, wy0), (y0 + 1, wy1)):
        for xi, wx in ((x0, wx0), (x0 + 1, wx1)):
            term = (wy * wx)[..., None] * frames[bi, _reflect(yi, h),
                                                 _reflect(xi, w)]
            out = term if out is None else out + term
    return out


def _color_shift_frame(frames, c_shift, which):
    """Additive shift of frames [B, ..., 3] on all channels (which 0) or
    on channel which - 1, clipped to [0, 1]; c_shift, which [B]."""
    ch = torch.arange(3, device=frames.device)
    on = (which[:, None] == 0) | (ch == which[:, None] - 1)     # [B, 3]
    shift = torch.where(on, c_shift[:, None], 0.0)
    shift = shift.view((frames.shape[0],) + (1,) * (frames.dim() - 2) + (3,))
    return (frames + shift).clamp(0.0, 1.0)


def warp_video_with_color(generator, video, draws=None):
    """One color shift per sample over its whole video [B, T, H, W, 3]
    (``visual_aug_mode='motion_color'``); ``draws``: :func:`color_draws`'s,
    else drawn from ``generator``."""
    if draws is None:
        draws = color_draws(generator, video.shape[0], video.device)
    return _color_shift_frame(video, draws['c_shift'], draws['which'])


def _modified_frame(video, d):
    """Frame j1 of each sample with strategy 3's affine warp, else
    strategy 2's color shift: [B, H, W, 3]."""
    frame = video[torch.arange(video.shape[0], device=video.device),
                  d['j1']]
    affine = _affine_warp_frame(frame, d['angle'], d['tx'], d['ty'],
                                d['scale'])
    color = _color_shift_frame(frame, d['c_shift'], d['which'])
    return torch.where((d['strategy'] == 3)[:, None, None, None], affine,
                       color)


def _assemble(grid, frame_j1, d):
    """grid [B, T, ...]: strategy 1 permutes the frames, the others put
    frame_j1 [B, ...] at frame j1."""
    b, t = grid.shape[:2]
    idx = torch.arange(b, device=grid.device)
    tail = (1,) * (grid.dim() - 2)
    s = d['strategy']
    permuted = grid[idx[:, None], d['perm']]
    at_j1 = ((torch.arange(t, device=grid.device) == d['j1'][:, None])
             & (s != 1)[:, None]).view(b, t, *tail)
    base = torch.where((s == 1).view(b, 1, *tail), permuted, grid)
    return torch.where(at_j1, frame_j1[:, None], base)


def warp(generator, video, vid_strategy_prob=(0.25, 0.25, 0.25, 0.25),
         draws=None, source=None):
    """VID negatives of video [B, T, H, W, 3] in [0, 1]; ``draws``:
    :func:`warp_draws`'s, else drawn from ``generator``.  ``source``: the
    videos that ``i_other`` indexes (the global batch of data-parallel
    ranks), ``video`` by default."""
    b, t = video.shape[:2]
    d = draws or warp_draws(generator, b, t, vid_strategy_prob,
                            video.device)
    stolen = (video if source is None else source)[d['i_other'], d['j2']]
    frame = torch.where((d['strategy'] == 0)[:, None, None, None], stolen,
                        _modified_frame(video, d))
    return _assemble(video, frame, d)


def warp_token_plan(generator, video,
                    vid_strategy_prob=(0.25, 0.25, 0.25, 0.25), draws=None):
    """The token-level form of :func:`warp`: strategies 0 and 1 permute
    the frames' tokens, 2 and 3 change one frame, which alone needs a
    fresh encode.  Returns (mod_frame [B, H, W, 3], frame j1 with strategy
    2's or 3's change (encoded but unused for 0 and 1), the plan: the
    draws)."""
    b, t = video.shape[:2]
    d = draws or warp_draws(generator, b, t, vid_strategy_prob,
                            video.device)
    return _modified_frame(video, d), d


def apply_warp_token_plan(target_tokens, mod_tokens, plan, source=None):
    """target_tokens [B, T*n] (the targets, encoded), mod_tokens [B, n]
    (mod_frame, encoded) -> [B, T*n], equal to tokenizing :func:`warp`'s
    video on the same draws.  ``source``: the targets' tokens that
    ``i_other`` indexes, as :func:`warp` takes them."""
    b, total = target_tokens.shape
    t = plan['perm'].shape[1]
    grid = target_tokens.reshape(b, t, total // t)
    if source is not None:
        source = source.reshape(source.shape[0], t, total // t)
    stolen = (grid if source is None else source)[plan['i_other'],
                                                  plan['j2']]
    frame = torch.where((plan['strategy'] == 0)[:, None], stolen,
                        mod_tokens)
    return _assemble(grid, frame, plan).reshape(b, total)
