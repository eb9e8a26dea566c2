"""Host-side image transforms on uint8 arrays (numpy, no Pillow).

The port's copy of ``mmvid_tpu/data/transforms.py``: Resize(shorter
side), CenterCrop, RandomResizedCrop with one crop shared across a stacked
video clip, the parity targets of the torchvision transforms the reference
composes (loader.py:370-385).  Where the JAX module holds a Pillow image, this
one holds its uint8 RGB array [H, W, 3]; resizes are Pillow's
``BILINEAR`` (``png.resize``), and the crop parameters take the same
``random`` draws in the same order.  Outputs NHWC float32 in [0, 1].
"""

from __future__ import annotations

import math
import random
from typing import Optional, Sequence, Tuple

import numpy as np

from mmvid_tpu_torch.data import png


def open_rgb(path) -> np.ndarray:
    """A frame file -> uint8 RGB [H, W, 3], as Pillow's
    ``Image.open().convert('RGB')`` gives it."""
    return png.read_rgb(path)


def to_array(img: np.ndarray) -> np.ndarray:
    """uint8 -> HWC float32 [0,1]."""
    return np.asarray(img, np.float32) / 255.0


def resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    if w <= h:
        nw, nh = size, max(1, round(h * size / w))
    else:
        nw, nh = max(1, round(w * size / h)), size
    return png.resize(img, nh, nw)


def resize_exact(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    return png.resize(img, size[0], size[1])


def center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[-3:-1]
    i = max(0, (h - size) // 2)
    j = max(0, (w - size) // 2)
    return arr[..., i:i + size, j:j + size, :]


def sample_resized_crop_params(h: int, w: int, scale: Tuple[float, float],
                               ratio: Tuple[float, float],
                               rng: Optional[random.Random] = None):
    """(i, j, ch, cw) following torchvision RandomResizedCrop.get_params."""
    r = rng or random
    area = h * w
    for _ in range(10):
        target_area = area * r.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(r.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = r.randint(0, h - ch)
            j = r.randint(0, w - cw)
            return i, j, ch, cw
    # fallback: center crop at the clamped aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw = w
        ch = int(round(cw / ratio[0]))
    elif in_ratio > ratio[1]:
        ch = h
        cw = int(round(ch * ratio[1]))
    else:
        cw, ch = w, h
    i = (h - ch) // 2
    j = (w - cw) // 2
    return i, j, ch, cw


def _resize_array(arr: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize a float HWC array (or a stack of them) to size x
    size, through uint8 as the JAX module goes through Pillow."""
    if arr.ndim == 3:
        return to_array(png.resize((arr * 255).astype(np.uint8), size,
                                   size))
    return np.stack([_resize_array(a, size) for a in arr])


class VideoTransform:
    """Resize(shorter) + RandomResizedCrop / CenterCrop, one crop per clip.

    deterministic=True -> Resize + CenterCrop (reference loader.py:370-374);
    else Resize + RandomResizedCrop(scale=(resize_ratio, 1), ratio=(1, 1))
    (loader.py:376-385).
    """

    def __init__(self, image_size: int, resize_ratio: float = 1.0,
                 deterministic: bool = False,
                 rng: Optional[random.Random] = None):
        self.image_size = image_size
        self.resize_ratio = resize_ratio
        self.deterministic = deterministic
        self.rng = rng

    def __call__(self, frames: Sequence[np.ndarray]) -> np.ndarray:
        """uint8 frames -> [T, S, S, 3] float32, one shared crop."""
        size = self.image_size
        frames = [resize_shorter(f, size) for f in frames]
        arr = np.stack([to_array(f) for f in frames])
        if self.deterministic:
            return center_crop(arr, size)
        h, w = arr.shape[1:3]
        i, j, ch, cw = sample_resized_crop_params(
            h, w, (self.resize_ratio, 1.0), (1.0, 1.0), self.rng)
        crop = arr[:, i:i + ch, j:j + cw, :]
        if (ch, cw) != (size, size):
            crop = _resize_array(crop, size)
        return crop

    def one(self, frame: np.ndarray) -> np.ndarray:
        return self([frame])[0]
