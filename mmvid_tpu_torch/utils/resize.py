"""Image resizes as ``jax.image.resize`` computes them, in torch.

The JAX package resizes with ``jax.image.resize`` in three places that the
port carries: InceptionV3's preprocessing (``'bilinear'``), the CLIP
scorer's (``'nearest'``) and the PRD tool's pixel embedder.  Its bilinear
resize is a separable product with a triangle kernel on half-pixel
centres that is widened by the scale when it downsamples (antialiasing),
each output's weights normalised to sum 1; its nearest resize takes input
row ``floor((i + 0.5) * in / out)`` in fp32.  Neither is quite
``F.interpolate``'s default, so both are written out here (fp32 weights,
fp32 products).  Images are NHWC; a dimension whose size does not change
is left as it is, as JAX leaves it.
"""

from __future__ import annotations

import torch


def _triangle_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] fp32 weights of ``jax.image.resize``'s linear method
    with antialias (``compute_weight_mat``)."""
    f32 = torch.float32
    inv_scale = 1.0 / torch.tensor(n_out / n_in, dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = ((torch.arange(n_out, dtype=f32, device=device) + 0.5)
              * inv_scale.to(device) - 0.5)
    x = (sample[None, :] - torch.arange(n_in, dtype=f32, device=device)[
        :, None]).abs() / kernel_scale.to(device)
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(f32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bilinear(images: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, h, w, C] fp32, ``jax.image.resize(...,
    'bilinear')`` (antialiased when it downsamples)."""
    x = images.float()
    if x.shape[1] != h:
        x = torch.einsum('bhwc,hH->bHwc', x,
                         _triangle_weights(x.shape[1], h, x.device))
    if x.shape[2] != w:
        x = torch.einsum('bhwc,wW->bhWc', x,
                         _triangle_weights(x.shape[2], w, x.device))
    return x


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    offsets = ((torch.arange(n_out, dtype=torch.float32, device=device)
                + 0.5) * n_in / n_out)
    return offsets.floor().long()


def resize_nearest(images: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, h, w, C], ``jax.image.resize(..., 'nearest')``:
    the same rows as ``F.interpolate(mode='nearest-exact')``, not torch's
    default ``'nearest'``."""
    x = images
    if x.shape[1] != h:
        x = x.index_select(1, _nearest_index(x.shape[1], h, x.device))
    if x.shape[2] != w:
        x = x.index_select(2, _nearest_index(x.shape[2], w, x.device))
    return x
