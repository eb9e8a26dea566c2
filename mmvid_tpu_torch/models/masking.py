"""Visual-control token erasers and the MSM training masks in PyTorch.

Counterpart of ``mmvid_tpu/models/masking.py``: ``random_erase_codebook``
and ``erase_codebook_face`` (sampling), ``sample_msm_mask`` (training).  Random draws come from an
explicit ``torch.Generator`` on the tokens' device; they are tensor ops
throughout, so nothing is read back to the host.  The JAX package draws
from its own PRNG, so the random modes agree with it in distribution, the
fixed patterns token for token.

As in the JAX package, a box is drawn once and clamped inside the grid
(torchvision's RandomErasing retries up to 10 times instead).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from mmvid_tpu_torch.parallel.mesh import LOCAL


def _uniform(shape, generator, device, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       device=device)


def _random_box_mask(generator, b: int, t: int, h: int, w: int,
                     scale: Tuple[float, float], ratio: Tuple[float, float],
                     device=None) -> torch.Tensor:
    """[b, t, h, w] bool, True inside one random box per sample, shared
    across its t frames."""
    area = h * w
    erase_area = area * _uniform((b,), generator, device, *scale)
    aspect = torch.exp(_uniform((b,), generator, device,
                                math.log(ratio[0]), math.log(ratio[1])))
    bh = torch.round(torch.sqrt(erase_area * aspect)).clamp(1, h).long()
    bw = torch.round(torch.sqrt(erase_area / aspect)).clamp(1, w).long()
    # randint(0, n) per sample, n = h - bh + 1 >= 1: floor(u * n), clamped
    # against fp32 rounding u * n up to n
    i0 = torch.minimum((_uniform((b,), generator, device)
                        * (h - bh + 1)).long(), h - bh)
    j0 = torch.minimum((_uniform((b,), generator, device)
                        * (w - bw + 1)).long(), w - bw)
    rows = torch.arange(h, device=device)[None, :, None]
    cols = torch.arange(w, device=device)[None, None, :]
    box = ((rows >= i0[:, None, None]) & (rows < (i0 + bh)[:, None, None])
           & (cols >= j0[:, None, None]) & (cols < (j0 + bw)[:, None, None]))
    return box[:, None].expand(b, t, h, w)


def random_erase_codebook(generator, visual_tokens, cfg,
                          erase_half: bool = False, p: float = 0.95,
                          dp=LOCAL):
    """visual_tokens [B, V*n] (no SEP).  ``erase_half`` fills the bottom
    half of every frame grid with [MASK]; otherwise one random box per
    sample (torchvision's p=0.95, scale=(0.55, 0.85), ratio=(0.5, 2)),
    drawn for the global batch of the data-parallel ranks ``dp`` and kept
    for this rank's rows."""
    b = visual_tokens.shape[0]
    v, h = cfg.num_visuals, cfg.image_fmap_size
    grid = visual_tokens.reshape(b, v, h, h)
    if erase_half:
        out = grid.clone()
        out[:, :, h // 2:, :] = cfg.mask_token
        return out.reshape(b, -1)
    dev = visual_tokens.device
    n = dp.batch(b)
    box = dp.rows(_random_box_mask(generator, n, v, h, h, scale=(0.55, 0.85),
                                   ratio=(0.5, 2.0), device=dev))
    do = dp.rows(_uniform((n,), generator, dev) < p)
    out = torch.where(do[:, None, None, None] & box, cfg.mask_token, grid)
    return out.reshape(b, -1)


def _keep_window(grid, mask_token, rows, cols, frames=slice(None)):
    """[MASK] everywhere except grid[:, frames, rows, cols]."""
    out = torch.full_like(grid, mask_token)
    out[:, frames, rows, cols] = grid[:, frames, rows, cols]
    return out


def erase_codebook_face(generator, visual_tokens, cfg, vc_mode: str,
                        face_mode: Optional[str] = None):
    """Structured visual-control occlusion per ``vc_mode`` on the 8x8 (and
    4x4) token grids.  With ``face_mode`` None the random modes draw one
    pattern for the whole batch, as the JAX package does."""
    b = visual_tokens.shape[0]
    v, h = cfg.num_visuals, cfg.image_fmap_size
    grid = visual_tokens.reshape(b, v, h, h)
    mask_tok = cfg.mask_token
    dev = visual_tokens.device

    if vc_mode == 'face_8x8':
        eyes = _keep_window(grid, mask_tok, slice(2, 5), slice(1, 7))
        mouth = _keep_window(grid, mask_tok, slice(5, 7), slice(2, 6))
        if face_mode is None:
            use_eyes = _uniform((), generator, dev) < 0.5
            out = torch.where(use_eyes, eyes, mouth)
        else:
            out = eyes if face_mode == 'eyes_nose' else mouth
    elif vc_mode in ('face2_8x8', 'face3_8x8'):
        # appearance frame 0 + the centre crop of the motion frames
        # (face3: of every frame)
        first = 1 if vc_mode == 'face2_8x8' else 0
        out = _keep_window(grid, mask_tok, slice(2, 6), slice(2, 6),
                           frames=slice(first, None))
        out[:, 0] = grid[:, 0]
    elif vc_mode in ('mask_8x8', 'mask2_8x8'):
        wide = _keep_window(grid, mask_tok, slice(1, 7), slice(1, 7))
        if face_mode is None:
            center = _keep_window(grid, mask_tok, slice(2, 6), slice(2, 6))
            # one of (keep all, centre, wide) with p = (0.5, 0.25, 0.25)
            u = _uniform((), generator, dev)
            out = torch.where(u < 0.5, grid,
                              torch.where(u < 0.75, center, wide))
        else:
            out = wide
    elif vc_mode == 'shape_4x4':
        out = grid.clone()
        out[:, :, 1:3, 1:3] = mask_tok
    else:
        raise NotImplementedError(vc_mode)
    return out.reshape(b, -1)


def sample_msm_mask(generator, cfg, msm_strategy_prob,
                    msm_bernoulli_prob=(0.2, 0.5), pc_prob: float = 0.0,
                    batch: int = 1, device=None):
    """Per-sample keep masks of the MSM loss: (keep [B, target_seq_len]
    bool, True keeps the ground-truth token visible, False replaces it by
    [MASK]; not_fully_masked [B] fp32).  Each sample draws one of four
    strategies with ``msm_strategy_prob``: keep each token with p ~
    U(msm_bernoulli_prob); mask everything (not_fully_masked 0); keep
    outside one random box shared by the frames (scale (0.2, 0.8), ratio
    (0.5, 2)); keep only inside it.  With ``pc_prob`` > 0, a sample keeps
    in addition, with that probability, 1 to max(T // 2, 1) whole random
    frames (preservation control)."""
    t, h = cfg.num_targets, cfg.image_fmap_size
    n = cfg.target_seq_len
    probs = torch.as_tensor(msm_strategy_prob, dtype=torch.float32,
                            device=device)
    strategy = torch.multinomial(probs.expand(batch, -1), 1,
                                 generator=generator)[:, 0]
    p_keep = _uniform((batch, 1), generator, device, *msm_bernoulli_prob)
    m1 = _uniform((batch, n), generator, device) < p_keep
    box = _random_box_mask(generator, batch, t, h, h, scale=(0.2, 0.8),
                           ratio=(0.5, 2.0), device=device).reshape(batch, n)
    s = strategy[:, None]
    # strategy 1 (mask everything) keeps nothing
    keep = torch.where(s == 0, m1, (s == 2) & ~box | (s == 3) & box)
    nfm = (strategy != 1).float()
    if pc_prob > 0:
        use_pc = _uniform((batch,), generator, device) < pc_prob
        t_overlap = 1 + (_uniform((batch,), generator, device)
                         * max(t // 2, 1)).long().clamp_max(
                             max(t // 2, 1) - 1)
        # a random permutation's first t_overlap frames
        rank = _uniform((batch, t), generator, device).argsort(-1).argsort(-1)
        frame_keep = (rank < t_overlap[:, None]).repeat_interleave(
            cfg.image_seq_len, dim=1)
        keep = torch.where(use_pc[:, None], keep | frame_keep, keep)
    return keep, nfm
