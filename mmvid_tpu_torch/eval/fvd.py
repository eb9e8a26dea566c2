"""Fréchet Video Distance: preprocessing and the Gaussian Fréchet math.

The port's copy of ``mmvid_tpu/eval/fvd.py``:

* preprocess: TF1's legacy bilinear resize to 224x224, then [0, 1] ->
  [-1, 1] (frechet_video_distance.py:34-52);
* the ping-pong extension of short clips to 15 or 16 frames before the
  embedding (utils/utils_eval.py:17-28,177-183), as frame indices that
  :func:`mmvid_tpu_torch.eval.evaluate.evaluate` gathers on the device;
* FVD = |m1 - m2|^2 + tr(S1 + S2 - 2 sqrt(S1 S2)), tfgan's
  ``frechet_classifier_distance_from_activations`` (numpy, fp64).

The embedding network is :mod:`mmvid_tpu_torch.eval.i3d`.
"""

from __future__ import annotations

import numpy as np
import torch


def tf1_resize_bilinear(images: torch.Tensor, th: int, tw: int
                        ) -> torch.Tensor:
    """TF1 legacy bilinear resize of [B, H, W, C] (align_corners=False,
    half_pixel_centers=False): src = dst * (in / out), edges clamped.

    The reference's FVD graph resizes with ``tf.image.resize_bilinear``'s
    TF1 defaults (frechet_video_distance.py:47-48), which is not the
    half-pixel mapping of ``F.interpolate(align_corners=False)``; FVD is
    sensitive to exactly this, so the mapping is written as gathers."""
    b, h, w, c = images.shape
    dev = images.device
    ys = torch.arange(th, dtype=torch.float32, device=dev) * (h / th)
    xs = torch.arange(tw, dtype=torch.float32, device=dev) * (w / tw)
    y0 = ys.floor().long()
    x0 = xs.floor().long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]

    def ix(rows):
        a = rows.index_select(2, x0)
        b_ = rows.index_select(2, x1)
        return a * (1.0 - wx) + b_ * wx

    top = ix(images.index_select(1, y0))
    bot = ix(images.index_select(1, y1))
    return top * (1.0 - wy) + bot * wy


def preprocess_videos(videos: torch.Tensor,
                      target_resolution=(224, 224)) -> torch.Tensor:
    """[B, T, H, W, 3] in [0, 1] -> [B, T, 224, 224, 3] in [-1, 1] fp32
    (TF1-legacy bilinear, as the reference's graph)."""
    b, t, h, w, c = videos.shape
    th, tw = target_resolution
    flat = videos.float().reshape(b * t, h, w, c)
    resized = tf1_resize_bilinear(flat, th, tw)
    return resized.reshape(b, t, th, tw, c) * 2.0 - 1.0


def pingpong_indices(t: int, target_len: int) -> np.ndarray:
    """Frame indices that ping-pong a T-frame clip to ``target_len``
    (utils/utils_eval.py:17-28); static, so the extension is one gather
    on the device."""
    if t >= target_len:
        return np.arange(target_len)
    if t == 1:  # ping-pong of a single frame = repeat it
        return np.zeros(target_len, dtype=np.int64)
    idx = []
    direction = 1
    i = 0
    while len(idx) < target_len:
        idx.append(i)
        if i == t - 1 and direction == 1:
            direction = -1
        elif i == 0 and direction == -1:
            direction = 1
        i += direction
    return np.asarray(idx)


def extend_video_pingpong(video: np.ndarray, target_len: int = 15
                          ) -> np.ndarray:
    """Ping-pong a [T, ...] clip to ``target_len`` frames
    (utils/utils_eval.py:17-28): forward, then reversed-interior
    repeats."""
    return video[pingpong_indices(video.shape[0], target_len)]


def frechet_distance(real_activations: np.ndarray,
                     generated_activations: np.ndarray) -> float:
    """Fréchet distance between Gaussians fit to two activation sets.

    tfgan's ``frechet_classifier_distance_from_activations``: tr(sqrt(S1
    S2)) from the eigenvalues of the symmetrized S1^{1/2} S2 S1^{1/2}."""
    x = np.asarray(real_activations, np.float64)
    y = np.asarray(generated_activations, np.float64)
    mx, my = x.mean(0), y.mean(0)
    # tfgan uses the unbiased covariance estimator
    sx = np.atleast_2d(np.cov(x, rowvar=False))
    sy = np.atleast_2d(np.cov(y, rowvar=False))

    # sqrt(Sx) via symmetric eigendecomposition
    ex, vx = np.linalg.eigh(sx)
    ex = np.clip(ex, 0, None)
    sqrt_sx = (vx * np.sqrt(ex)[None, :]) @ vx.T
    prod = sqrt_sx @ sy @ sqrt_sx
    eigs = np.linalg.eigvalsh((prod + prod.T) / 2.0)
    trace_sqrt = np.sum(np.sqrt(np.clip(eigs, 0, None)))

    return float(np.sum((mx - my) ** 2) + np.trace(sx) + np.trace(sy)
                 - 2.0 * trace_sqrt)
