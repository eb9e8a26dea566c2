"""Image, GIF and MP4 writers, grids and the HTML page (reference
utils/utils_html.py:18-242).

The port's copy of what it uses from ``mmvid_tpu/utils/html.py``, with
no Pillow, imageio or OpenCV: PNGs are written by ``data/png.py``, GIFs
by ``utils/gif.py`` (a median-cut palette a frame, LZW in the C++ core)
and MP4s by ``utils/mp4.py`` (H.264 of ``I_PCM`` macroblocks).  Same
artifact layout as the JAX module: <web_dir>/index.html +
<web_dir>/images/*.{png,gif,mp4}, one row per sample with captions, with
a pickle cache so pages survive resumes (utils_html.py:18-120); a video
is saved under the name the caller gives, as a GIF for ``.gif`` and an
MP4 otherwise, so the port's pages list the same files as JAX's.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Sequence

import numpy as np

from mmvid_tpu_torch.data import png
from mmvid_tpu_torch.utils import gif
# the writers of utils_html.py:157-190, re-exported for the callers
from mmvid_tpu_torch.utils.gif import save_gif  # noqa: F401
from mmvid_tpu_torch.utils.mp4 import save_mp4  # noqa: F401


def save_image_array(path: str, img: np.ndarray):
    """HWC float [0,1] -> PNG."""
    png.write_png(path, gif.to_uint8(img))


def tile_video_row(frames: np.ndarray) -> np.ndarray:
    """[T,H,W,3] -> [H, T*W, 3] horizontal strip."""
    return np.concatenate(list(frames), axis=1)


def tile_grid(rows: Sequence[np.ndarray], pad: int = 2) -> np.ndarray:
    """List of [H, W_i, 3] rows -> single grid image (white padding)."""
    width = max(r.shape[1] for r in rows)
    out = []
    for r in rows:
        if r.shape[1] < width:
            r = np.pad(r, ((0, 0), (0, width - r.shape[1]), (0, 0)),
                       constant_values=1.0)
        out.append(np.pad(r, ((0, pad), (0, 0), (0, 0)),
                          constant_values=1.0))
    return np.concatenate(out, axis=0)


class HTML:
    """Accumulating web page: header + (caption, media) rows."""

    def __init__(self, web_dir: str, title: str, reverse: bool = False,
                 refresh: int = 0):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, 'images')
        self.title = title
        self.reverse = reverse
        self.refresh = refresh
        os.makedirs(self.img_dir, exist_ok=True)
        self.rows: List = []
        self._cache = os.path.join(web_dir, 'page_cache.pkl')
        if os.path.exists(self._cache):
            try:
                with open(self._cache, 'rb') as f:
                    self.rows = pickle.load(f)
            except (OSError, pickle.UnpicklingError, EOFError):
                self.rows = []

    def add_header(self, text: str):
        self.rows.append(('header', text))

    def add_media_row(self, items: Sequence[tuple], height: int = 128):
        """items: (filename-under-images/, caption) pairs."""
        self.rows.append(('media', list(items), height))

    def save_media(self, name: str, array: np.ndarray, fps: int = 4) -> str:
        """Save an image ([H,W,3]) or video ([T,H,W,3]: a GIF for a .gif
        name, else an MP4) under images/; returns ``name``."""
        path = os.path.join(self.img_dir, name)
        if array.ndim == 4:
            if name.endswith('.gif'):
                save_gif(path, array, fps)
            else:
                save_mp4(path, array, fps)
        else:
            save_image_array(path, array)
        return name

    def save(self):
        rows = list(reversed(self.rows)) if self.reverse else self.rows
        parts = ['<!DOCTYPE html><html><head>',
                 f'<title>{self.title}</title>']
        if self.refresh:
            parts.append(
                f'<meta http-equiv="refresh" content="{self.refresh}">')
        parts.append('<style>td{padding:4px;text-align:center;'
                     'font-family:monospace;font-size:12px}</style>')
        parts.append(f'</head><body><h1>{self.title}</h1>')
        for row in rows:
            if row[0] == 'header':
                parts.append(f'<h3>{row[1]}</h3>')
            else:
                _, items, height = row
                parts.append('<table><tr>')
                for fname, caption in items:
                    if fname.endswith('.mp4'):
                        media = (f'<video height="{height}" controls '
                                 f'autoplay loop muted>'
                                 f'<source src="images/{fname}"></video>')
                    else:
                        media = (f'<img height="{height}" '
                                 f'src="images/{fname}">')
                    parts.append(f'<td>{media}<br>{caption}</td>')
                parts.append('</tr></table>')
        parts.append('</body></html>')
        with open(os.path.join(self.web_dir, 'index.html'), 'w') as f:
            f.write('\n'.join(parts))
        with open(self._cache, 'wb') as f:
            pickle.dump(self.rows, f)


def initialize_webpage(web_dir: str, title: str, reverse: bool = False
                       ) -> HTML:
    return HTML(web_dir, title, reverse=reverse)
