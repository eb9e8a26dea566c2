"""Image, GIF and MP4 writers of ``generate.main``.

The port's copy of the writers it uses from ``mmvid_tpu/utils/html.py``.
Pillow, imageio (and OpenCV, where imageio has no ffmpeg backend) are
imported inside the writer that needs them, so importing this module
needs only numpy.
"""

from __future__ import annotations

import numpy as np


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def save_image_array(path: str, img: np.ndarray):
    """HWC float [0,1] -> PNG."""
    from PIL import Image
    Image.fromarray(_to_uint8(img)).save(path)


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
