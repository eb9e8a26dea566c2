"""Frame files without Pillow: PNG read and write, PPM/PGM read, the
readers' dispatch (JPEG in ``data/jpeg.py``, BMP in ``data/bmp.py``), and
Pillow's bilinear resize.

The datasets of ``mmvid_tpu`` open every frame with Pillow
(``Image.open(path).convert('RGB')``, then ``resize(..., BILINEAR)``); the
port reads the same files into the same uint8 RGB arrays without it.
:func:`read_rgb` and :func:`image_size` go by the file's first bytes:

* PNG: the stream inflated by the stdlib's ``zlib``, the five row filters
  undone, bit depth 8 in colour types 0 (grey, replicated), 2 (RGB), 3
  (palette, looked up), 4 (grey + alpha) and 6 (RGBA), the alpha dropped,
  as ``convert('RGB')`` converts them.  16-bit, sub-byte and interlaced
  files raise ``ValueError`` naming the file; a damaged one raises
  ``OSError``, as Pillow's open does.
* binary PPM (P6) and PGM (P5) with maxval 255, read directly.
* JPEG (``FF D8``): baseline, extended sequential and progressive
  Huffman-coded 8-bit files, byte-equal to libjpeg-turbo's defaults
  (``data/jpeg.py``).
* BMP (``BM``): uncompressed 1, 4, 8, 16, 24 and 32 bits and 16 / 32-bit
  bitfields (``data/bmp.py``).
* Any other format raises ``ValueError`` naming the file and the formats
  read.

The row unfiltering (Average and Paeth are a recurrence along each row),
the resize (Pillow's ``BILINEAR``: a triangle filter whose support widens
with the downscale factor, in Pillow's fixed-point arithmetic) and the
JPEG and GIF stages run in a small C++ core, ``_frames.cpp``, built by
``g++`` at first use into ``mmvid_tpu_torch/_build`` and called through
ctypes, which releases the GIL so the loader's threads decode in
parallel.  There is no fallback: a failed build raises.
:func:`unfilter_plain` and :func:`resize_plain` are the plain numpy
versions the tests hold the core against, byte for byte.

:func:`write_png` writes 8-bit PNGs with a filter type chosen per row, so
tests can make files that use every filter.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
import zlib
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_SOURCE = Path(__file__).resolve().parent / '_frames.cpp'
_BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
_CXX_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC', '-ffp-contract=off')
_lib = None
_lib_lock = threading.Lock()


def _build() -> Path:
    """Compile ``_frames.cpp`` (unless built for this source) and return
    the library's path."""
    h = hashlib.sha256(' '.join(_CXX_FLAGS).encode() + _SOURCE.read_bytes())
    path = _BUILD_DIR / f'libmmvid_frames_{h.hexdigest()[:16]}.so'
    if path.exists():
        return path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        out = Path(tmp) / path.name
        proc = subprocess.run(['g++', *_CXX_FLAGS, '-o', str(out),
                               str(_SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'g++ failed ({proc.returncode}) building '
                               f'{_SOURCE}:\n{proc.stderr}')
        os.replace(out, path)
    return path


def library() -> ctypes.CDLL:
    """The frame core, built on first call."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            u8 = ctypes.POINTER(ctypes.c_uint8)
            i64 = ctypes.c_int64
            lib.frames_unfilter.argtypes = [u8, u8, i64, i64, ctypes.c_int]
            lib.frames_unfilter.restype = ctypes.c_int
            lib.frames_resize.argtypes = [u8, i64, i64, ctypes.c_int, u8,
                                          i64, i64]
            lib.frames_resize.restype = None
            p64 = ctypes.POINTER(ctypes.c_int64)
            p16 = ctypes.POINTER(ctypes.c_int16)
            lib.frames_jpeg_scan.argtypes = [u8, i64, p64, u8, p16]
            lib.frames_jpeg_scan.restype = ctypes.c_int
            lib.frames_jpeg_idct.argtypes = [
                p16, i64, i64, ctypes.POINTER(ctypes.c_uint16), u8]
            lib.frames_jpeg_idct.restype = None
            lib.frames_jpeg_color.argtypes = [u8, p64, u8]
            lib.frames_jpeg_color.restype = None
            lib.frames_gif_palette.argtypes = [u8, i64, u8]
            lib.frames_gif_palette.restype = ctypes.c_int
            lib.frames_gif_map.argtypes = [u8, i64, u8, ctypes.c_int, u8]
            lib.frames_gif_map.restype = None
            lib.frames_gif_lzw.argtypes = [u8, i64, u8]
            lib.frames_gif_lzw.restype = i64
            _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# -- unfiltering ----------------------------------------------------------

def unfilter(data: np.ndarray, h: int, stride: int, bpp: int,
             native: bool = True) -> np.ndarray:
    """Inflated PNG scanlines (``h`` rows of a filter byte and ``stride``
    bytes) -> [h, stride] uint8, by the C++ core or :func:`unfilter_plain`."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.size != h * (stride + 1):
        raise OSError(f'PNG data is {data.size} bytes, expected '
                      f'{h * (stride + 1)}')
    if not native:
        return unfilter_plain(data, h, stride, bpp)
    out = np.empty((h, stride), np.uint8)
    bad = library().frames_unfilter(_ptr(data), _ptr(out), h, stride, bpp)
    if bad:
        raise OSError(f'PNG row {bad - 1} has filter type '
                      f'{data[(bad - 1) * (stride + 1)]}')
    return out


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_plain(data: np.ndarray, h: int, stride: int,
                   bpp: int) -> np.ndarray:
    """The plain version of the C++ unfilter: one row at a time, Average
    and Paeth one pixel at a time."""
    rows = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ft, src = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ft == 0:
            row = src
        elif ft == 2:
            row = (src + prior) & 255
        elif ft in (1, 3, 4):
            row = np.zeros(stride, np.int32)
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                c = prior[x - bpp] if x >= bpp else 0
                pred = (a if ft == 1 else (a + prior[x]) >> 1 if ft == 3
                        else int(_paeth(a, prior[x], c)))
                row[x] = (src[x] + pred) & 255
        else:
            raise OSError(f'PNG row {y} has filter type {ft}')
        out[y] = row
        prior = row
    return out


# -- resize (Pillow's BILINEAR) --------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _coeffs(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for the triangle
    filter, as dense fixed-point weights [out_size, in_size] int64."""
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    xx = np.arange(out_size, dtype=np.float64)
    center = 0.0 + (xx + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    ss = 1.0 / filterscale
    k = np.zeros((out_size, ksize))
    ww = np.zeros(out_size)
    for x in range(ksize):   # the sum in Pillow's order
        arg = np.abs(((x + xmin).astype(np.float64) - center + 0.5) * ss)
        w = np.where(x < xmax, np.where(arg < 1.0, 1.0 - arg, 0.0), 0.0)
        k[:, x] = w
        ww = ww + w
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0, 1, ww)[:, None],
                 k)
    fixed = np.where(k < 0, np.trunc(-0.5 + k * (1 << _PRECISION_BITS)),
                     np.trunc(0.5 + k * (1 << _PRECISION_BITS)))
    dense = np.zeros((out_size, in_size), np.int64)
    for i in range(out_size):
        n = int(xmax[i])
        dense[i, xmin[i]:xmin[i] + n] = fixed[i, :n]
    return dense


def _clip8(ss: np.ndarray) -> np.ndarray:
    return np.clip(ss >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_plain(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """The plain version of the C++ resize: each pass one integer
    product with the dense fixed-point weights."""
    in_h, in_w = img.shape[:2]
    x = img.astype(np.int64)
    half = 1 << (_PRECISION_BITS - 1)
    if out_w != in_w:
        wh = _coeffs(in_w, out_w)
        x = _clip8(np.einsum('hwc,ow->hoc', x, wh) + half).astype(np.int64)
    if out_h != in_h:
        wv = _coeffs(in_h, out_h)
        x = _clip8(np.einsum('hwc,oh->owc', x, wv) + half).astype(np.int64)
    return x.astype(np.uint8)


def resize(img: np.ndarray, out_h: int, out_w: int,
           native: bool = True) -> np.ndarray:
    """uint8 [H, W, C] -> [out_h, out_w, C] as Pillow's
    ``Image.resize((out_w, out_h), BILINEAR)`` gives it."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if (out_h, out_w) == img.shape[:2]:
        return img.copy()
    if not native:
        return resize_plain(img, out_h, out_w)
    out = np.empty((out_h, out_w, img.shape[2]), np.uint8)
    library().frames_resize(_ptr(img), img.shape[0], img.shape[1],
                            img.shape[2], _ptr(out), out_h, out_w)
    return out


# -- reading ---------------------------------------------------------------

def _chunks(data: bytes, name):
    if not data.startswith(SIGNATURE):
        raise OSError(f'{name}: not a PNG file')
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise OSError(f'{name}: truncated {kind!r} chunk')
        if zlib.crc32(kind + body) != struct.unpack('>I', crc)[0]:
            raise OSError(f'{name}: bad CRC in {kind!r} chunk')
        yield kind, body
        if kind == b'IEND':
            return
        pos += 12 + n
    raise OSError(f'{name}: no IEND chunk')


def _header(data: bytes, name):
    if len(data) < 33 or not data.startswith(SIGNATURE) \
            or data[12:16] != b'IHDR':
        raise OSError(f'{name}: not a PNG file')
    return struct.unpack('>IIBBBBB', data[16:29])


def decode_png(data: bytes, name='<bytes>', native: bool = True
               ) -> np.ndarray:
    """PNG bytes -> uint8 RGB [H, W, 3], as
    ``Image.open(...).convert('RGB')`` gives it."""
    w, h, depth, ctype, _, _, interlace = _header(data, name)
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(f'{name}: PNG bit depth {depth}, colour type '
                         f'{ctype}: only 8-bit colour types 0, 2, 3, 4 and '
                         '6 are read')
    if interlace:
        raise ValueError(f'{name}: interlaced PNG is not read')
    idat, palette = [], None
    for kind, body in _chunks(data, name):
        if kind == b'IDAT':
            idat.append(body)
        elif kind == b'PLTE':
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
    ch = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b''.join(idat))
    except zlib.error as e:
        raise OSError(f'{name}: {e}') from e
    px = unfilter(np.frombuffer(raw, np.uint8), h, w * ch, ch,
                  native=native).reshape(h, w, ch)
    if ctype == 2:
        return px
    if ctype == 6:
        return np.ascontiguousarray(px[..., :3])
    if ctype == 3:
        if palette is None:
            raise OSError(f'{name}: palette PNG without a PLTE chunk')
        # indices past the palette read as black, as in Pillow
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    return np.repeat(px[..., :1], 3, axis=2)   # grey, grey + alpha


def _pnm_header(data: bytes, name):
    """(magic, width, height, maxval, data offset) of a binary PNM."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b'#':
            while pos < len(data) and data[pos:pos + 1] not in b'\r\n':
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise OSError(f'{name}: bad PNM header')
        fields.append(int(data[start:pos]))
    return data[:2], fields[0], fields[1], fields[2], pos + 1


def decode_pnm(data: bytes, name='<bytes>') -> np.ndarray:
    """Binary PPM (P6) / PGM (P5) bytes -> uint8 RGB [H, W, 3]."""
    magic, w, h, maxval, off = _pnm_header(data, name)
    if maxval != 255:
        raise ValueError(f'{name}: PNM maxval {maxval}: only 255 is read')
    ch = 3 if magic == b'P6' else 1
    px = np.frombuffer(data, np.uint8, w * h * ch, off) if \
        len(data) >= off + w * h * ch else None
    if px is None:
        raise OSError(f'{name}: truncated PNM data')
    px = px.reshape(h, w, ch)
    return px.copy() if ch == 3 else np.repeat(px, 3, axis=2)


FORMATS = 'PNG, PPM, PGM, JPEG and BMP'


def decode(data: bytes, name='<bytes>') -> np.ndarray:
    """A frame file's bytes -> uint8 RGB [H, W, 3], by its first bytes."""
    from mmvid_tpu_torch.data import bmp, jpeg
    if data.startswith(SIGNATURE):
        return decode_png(data, name)
    if data[:2] in (b'P5', b'P6'):
        return decode_pnm(data, name)
    if jpeg.is_jpeg(data):
        return jpeg.decode_jpeg(data, name)
    if bmp.is_bmp(data):
        return bmp.decode_bmp(data, name)
    raise ValueError(f'{name}: not a frame format the port reads '
                     f'({FORMATS})')


def read_rgb(path: Union[str, os.PathLike]) -> np.ndarray:
    """A frame file -> uint8 RGB [H, W, 3], as Pillow's
    ``Image.open(path).convert('RGB')`` gives it."""
    with open(path, 'rb') as f:
        data = f.read()
    return decode(data, str(path))


def image_size(path: Union[str, os.PathLike]) -> Tuple[int, int]:
    """(width, height) from the file's header."""
    from mmvid_tpu_torch.data import bmp, jpeg
    with open(path, 'rb') as f:
        head = f.read(64)
        if head.startswith(SIGNATURE):
            w, h = _header(head, str(path))[:2]
            return w, h
        if head[:2] in (b'P5', b'P6'):
            f.seek(0)
            _, w, h, _, _ = _pnm_header(f.read(1024), str(path))
            return w, h
        if bmp.is_bmp(head):
            return bmp.bmp_size(head, str(path))
        if jpeg.is_jpeg(head):
            f.seek(0)
            return jpeg.jpeg_size(f.read(), str(path))
    raise ValueError(f'{path}: not a frame format the port reads '
                     f'({FORMATS})')


# -- writing ---------------------------------------------------------------

def _filter_row(ft: int, row: np.ndarray, prior: np.ndarray,
                bpp: int) -> np.ndarray:
    r = row.astype(np.int32)
    p = prior.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), p[:-bpp]])
    pred = {0: 0, 1: a, 2: p, 3: (a + p) >> 1, 4: _paeth(a, p, c)}[ft]
    return ((r - pred) & 255).astype(np.uint8)


def encode_png(img: np.ndarray, filters: Union[int, Sequence[int]] = 0,
               palette: Optional[np.ndarray] = None) -> bytes:
    """uint8 [H, W] (grey, or palette indices with ``palette`` [N, 3]),
    [H, W, 2] (grey + alpha), [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> PNG
    bytes; ``filters``: one filter type (0-4) for every row, or one a
    row."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f'write_png takes uint8, got {img.dtype}')
    if img.ndim == 2:
        ctype = 0 if palette is None else 3
        img = img[..., None]
    else:
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[img.shape[2]]
    h, w, ch = img.shape
    rows = img.reshape(h, w * ch)
    fts = [filters] * h if isinstance(filters, int) else list(filters)
    if len(fts) != h or not all(0 <= f <= 4 for f in fts):
        raise ValueError(f'filters: {h} types in 0-4 expected')
    prior = np.zeros(w * ch, np.uint8)
    lines = []
    for y in range(h):
        lines.append(bytes([fts[y]]) + _filter_row(fts[y], rows[y], prior,
                                                    ch).tobytes())
        prior = rows[y]

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body)))

    out = [SIGNATURE,
           chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, ctype, 0, 0, 0))]
    if palette is not None:
        out.append(chunk(b'PLTE', np.asarray(palette, np.uint8).tobytes()))
    out += [chunk(b'IDAT', zlib.compress(b''.join(lines), 6)),
            chunk(b'IEND', b'')]
    return b''.join(out)


def write_png(path: Union[str, os.PathLike], img: np.ndarray,
              filters: Union[int, Sequence[int]] = 0,
              palette: Optional[np.ndarray] = None) -> None:
    """:func:`encode_png` into ``path``."""
    with open(path, 'wb') as f:
        f.write(encode_png(img, filters, palette))
