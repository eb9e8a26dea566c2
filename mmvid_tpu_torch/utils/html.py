"""Image, GIF and MP4 writers, grids and the HTML page (reference
utils/utils_html.py:18-242).

The port's copy of what it uses from ``mmvid_tpu/utils/html.py``.  PNGs
are written by ``data/png.py`` (no Pillow).  GIF and MP4 need imageio (or
OpenCV for MP4), imported inside the writer that needs them;
:func:`check_writer` asks for them before any work is done.  The page
(:class:`HTML`) shows each video as a PNG strip of its frames, so it is
written with numpy alone (a GIF writer of the port's own is queued in
ROADMAP.md).  Same artifact layout as the JAX module:
<web_dir>/index.html + <web_dir>/images/*, one row per sample with
captions, with a pickle cache so pages survive resumes
(utils_html.py:18-120).
"""

from __future__ import annotations

import os
import pickle
from typing import List, Sequence

import numpy as np

from mmvid_tpu_torch.data import png


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def save_image_array(path: str, img: np.ndarray):
    """HWC float [0,1] -> PNG."""
    png.write_png(path, _to_uint8(img))


def check_writer(fmt: str) -> None:
    """Raise ``RuntimeError`` unless the writer of ``fmt`` ('png', 'gif'
    or 'mp4') can run here."""
    if fmt == 'png':
        return
    try:
        import imageio  # noqa: F401
        return
    except ImportError:
        pass
    if fmt == 'mp4':
        try:
            import cv2  # noqa: F401
            return
        except ImportError:
            pass
    need = 'imageio' if fmt == 'gif' else 'imageio or OpenCV (cv2)'
    raise RuntimeError(f'--format {fmt} needs {need}, which is not '
                       'installed; --format png writes each video as a '
                       'PNG strip without it')


def save_gif(path: str, frames: np.ndarray, fps: int = 4):
    """[T,H,W,3] float [0,1] -> animated GIF."""
    import imageio
    imageio.mimsave(path, [_to_uint8(f) for f in frames],
                    duration=1000 / fps, loop=0)


def save_mp4(path: str, frames: np.ndarray, fps: int = 4):
    """[T,H,W,3] float [0,1] -> MP4 (imageio's ffmpeg, else OpenCV)."""
    try:
        import imageio
        writer = imageio.get_writer(path, fps=fps)
        for f in frames:
            writer.append_data(_to_uint8(f))
        writer.close()
    except (ImportError, ValueError):
        import cv2
        h, w = frames.shape[1:3]
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'), fps,
                              (w, h))
        for f in frames:
            out.write(cv2.cvtColor(_to_uint8(f), cv2.COLOR_RGB2BGR))
        out.release()


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
        """Save an image ([H,W,3]) or a video ([T,H,W,3], as the PNG strip
        of its frames, under ``name`` with a .png suffix) under images/;
        returns the file name written."""
        if array.ndim == 4:
            name = os.path.splitext(name)[0] + '.png'
            array = tile_video_row(array)
        save_image_array(os.path.join(self.img_dir, name), array)
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
                    media = f'<img height="{height}" src="images/{fname}">'
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
