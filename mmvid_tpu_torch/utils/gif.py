"""Animated GIF writer without Pillow or imageio: [T, H, W, 3] float in
[0, 1] -> GIF89a.

The JAX package writes ``imageio.mimsave(path, frames, duration=1000 /
fps, loop=0)``.  What this writer holds equal to it: the frame count and
size, the NETSCAPE2.0 loop count 0, and each frame's delay (25
centiseconds at fps 4, which Pillow reads as ``info['duration'] ==
250``).  The frames go through JAX's uint8 rounding
(``(clip(f, 0, 1) * 255).astype(uint8)``); each then gets a local
256-entry palette from a median cut of its own colours, each pixel the
nearest palette entry (no dithering), and the indices are LZW-coded.  The
bytes differ from imageio's, which come from Pillow's quantizer and frame
optimiser; the decoded error is what the tests compare.

The median cut, the mapping and the LZW coder run in the C++ core
(``data/_frames.cpp``, through :func:`png.library`, which releases the
GIL); :func:`palette_plain`, :func:`map_plain` and :func:`lzw_plain` are
their plain versions, held against it byte for byte by the tests.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple, Union

import numpy as np

from mmvid_tpu_torch.data import png


def to_uint8(frames: np.ndarray) -> np.ndarray:
    """JAX's rounding of [0, 1] floats to uint8."""
    return (np.clip(frames, 0, 1) * 255).astype(np.uint8)


# -- the stages ---------------------------------------------------------------

def palette(rgb: np.ndarray, native: bool = True
            ) -> Tuple[np.ndarray, int]:
    """uint8 pixels [N, 3] -> (palette [256, 3], colours used): the median
    cut of ``frames_gif_palette``."""
    rgb = np.ascontiguousarray(rgb, np.uint8).reshape(-1, 3)
    if not native:
        return palette_plain(rgb)
    pal = np.zeros((256, 3), np.uint8)
    n = png.library().frames_gif_palette(png._ptr(rgb), len(rgb),
                                         png._ptr(pal))
    return pal, n


def map_pixels(rgb: np.ndarray, pal: np.ndarray, n: int,
               native: bool = True) -> np.ndarray:
    """uint8 pixels [N, 3] -> the index of the nearest of the first ``n``
    palette entries (squared distance, the lowest index on ties)."""
    rgb = np.ascontiguousarray(rgb, np.uint8).reshape(-1, 3)
    if not native:
        return map_plain(rgb, pal, n)
    pal = np.ascontiguousarray(pal, np.uint8)
    out = np.empty(len(rgb), np.uint8)
    png.library().frames_gif_map(png._ptr(rgb), len(rgb), png._ptr(pal), n,
                                 png._ptr(out))
    return out


def lzw(indices: np.ndarray, native: bool = True) -> bytes:
    """8-bit indices -> GIF's LZW code stream at minimum code size 8."""
    idx = np.ascontiguousarray(indices, np.uint8).reshape(-1)
    if not native:
        return lzw_plain(idx)
    out = np.empty(2 * len(idx) + 64, np.uint8)
    n = png.library().frames_gif_lzw(png._ptr(idx), len(idx), png._ptr(out))
    return out[:n].tobytes()


def quantize(frame: np.ndarray, native: bool = True
             ) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 [H, W, 3] -> (palette [256, 3], indices [H, W]): the frame as
    the GIF holds it; ``palette[indices]`` is what a reader decodes."""
    h, w = frame.shape[:2]
    pal, n = palette(frame, native)
    return pal, map_pixels(frame, pal, n, native).reshape(h, w)


# -- the plain versions -------------------------------------------------------

def _stats(cols: np.ndarray, cnt: np.ndarray):
    ch = [(cols >> (16 - 8 * c)) & 255 for c in range(3)]
    n = int(cnt.sum())
    s1 = [int((x * cnt).sum()) for x in ch]
    s2 = [int((x * x * cnt).sum()) for x in ch]
    return n, s1, s2


def palette_plain(rgb: np.ndarray) -> Tuple[np.ndarray, int]:
    """The plain version of ``frames_gif_palette``: the same median cut
    on numpy arrays, the error sums in Python integers."""
    keys = (rgb[:, 0].astype(np.int64) << 16) | (rgb[:, 1].astype(
        np.int64) << 8) | rgb[:, 2]
    cols, cnt = np.unique(keys, return_counts=True)
    pal = np.zeros((256, 3), np.uint8)
    if len(cols) == 0:
        return pal, 0
    boxes = [(cols, cnt.astype(np.int64), *_stats(cols, cnt))]

    def spread(box, c):
        return box[2] * box[4][c] - box[3][c] ** 2

    while len(boxes) < 256:
        best, bnum, bn = -1, 0, 1
        for i, box in enumerate(boxes):
            if len(box[0]) < 2:
                continue
            num = sum(spread(box, c) for c in range(3))
            if best < 0 or num * bn > bnum * box[2]:
                best, bnum, bn = i, num, box[2]
        if best < 0:
            break
        bc, bcnt, n = boxes[best][:3]
        axis = max(range(3), key=lambda c: (spread(boxes[best], c), -c))
        order = np.lexsort((bc, (bc >> (16 - 8 * axis)) & 255))
        bc, bcnt = bc[order], bcnt[order]
        cum = np.cumsum(bcnt)[:-1]
        hit = np.nonzero(2 * cum >= n)[0]
        cut = int(hit[0]) + 1 if len(hit) else len(bc) - 1
        boxes[best] = (bc[:cut], bcnt[:cut], *_stats(bc[:cut], bcnt[:cut]))
        boxes.append((bc[cut:], bcnt[cut:], *_stats(bc[cut:], bcnt[cut:])))
    for i, (_, _, n, s1, _) in enumerate(boxes):
        pal[i] = [(s + n // 2) // n for s in s1]
    return pal, len(boxes)


def map_plain(rgb: np.ndarray, pal: np.ndarray, n: int) -> np.ndarray:
    """The plain version of ``frames_gif_map``: every distance computed."""
    d = ((rgb[:, None, :].astype(np.int32)
          - pal[None, :n, :].astype(np.int32)) ** 2).sum(-1)
    return np.argmin(d, axis=1).astype(np.uint8)   # first of the minima


def lzw_plain(idx: np.ndarray) -> bytes:
    """The plain version of ``frames_gif_lzw``: a dict of (prefix code,
    index) entries."""
    out, acc, nacc = bytearray(), 0, 0
    size, nxt, table = 9, 258, {}

    def emit(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    emit(256)
    data = [int(x) for x in idx]
    if data:
        w = data[0]
        for c in data[1:]:
            if (w, c) in table:
                w = table[(w, c)]
                continue
            emit(w)
            if nxt < 4096:
                table[(w, c)] = nxt
                if nxt == (1 << size) and size < 12:
                    size += 1
                nxt += 1
            else:
                emit(256)
                table, size, nxt = {}, 9, 258
            w = c
        emit(w)
        if nxt < 4096 and nxt == (1 << size) and size < 12:
            size += 1
    emit(257)
    if nacc > 0:
        out.append(acc & 255)
    return bytes(out)


# -- the file -----------------------------------------------------------------

def _sub_blocks(data: bytes) -> bytes:
    parts = [bytes([len(data[i:i + 255])]) + data[i:i + 255]
             for i in range(0, len(data), 255)]
    return b''.join(parts) + b'\x00'


def encode_gif(frames: np.ndarray, fps: float = 4, native: bool = True
               ) -> bytes:
    """uint8 [T, H, W, 3] -> the GIF89a file's bytes, looping forever."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f'encode_gif takes uint8 [T, H, W, 3], got '
                         f'{frames.dtype} {frames.shape}')
    t, h, w = frames.shape[:3]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f'GIF frames of {w}x{h} cannot be written')
    out = [b'GIF89a', struct.pack('<HHBBB', w, h, 0, 0, 0),
           b'\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00']
    delay = int(round(100 / fps))   # centiseconds: JAX's 1000 / fps ms
    for f in frames:
        pal, idx = quantize(f, native)
        out.append(struct.pack('<BBBBHBB', 0x21, 0xF9, 4, 0x04, delay, 0, 0))
        out.append(struct.pack('<BHHHHB', 0x2C, 0, 0, w, h, 0x87))
        out.append(pal.tobytes())
        out.append(b'\x08' + _sub_blocks(lzw(idx, native)))
    out.append(b'\x3b')
    return b''.join(out)


def save_gif(path: Union[str, os.PathLike], frames: np.ndarray,
             fps: float = 4) -> None:
    """[T, H, W, 3] float in [0, 1] -> an animated GIF at ``path``."""
    data = encode_gif(to_uint8(np.asarray(frames)), fps)
    with open(path, 'wb') as f:
        f.write(data)
