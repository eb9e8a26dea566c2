"""BMP frames without Pillow: bytes -> uint8 RGB [H, W, 3], as Pillow's
``Image.open(path).convert('RGB')`` reads them (``BmpImagePlugin``).

Read: the OS/2 core header (12 bytes) and the Windows headers of 40, 52,
56, 64, 108 and 124 bytes; ``BI_RGB`` at 1, 4 and 8 bits (a palette of
BGRX entries, or BGR after a core header, looked up) and at 16 (5-5-5),
24 and 32 bits (BGRX, the fourth byte ignored); ``BI_BITFIELDS`` at 16
bits (5-6-5 or 5-5-5) and at 32 bits with the byte-aligned masks Pillow
takes, the alpha dropped; bottom-up and top-down rows.  A 5- or 6-bit
channel widens as Pillow's unpackers widen it (``v * 255 // 31``).  RLE
compression and other layouts raise ``ValueError`` naming the file; a
truncated file raises ``OSError``.  numpy alone; no C++ stage.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3
_MASKS_32 = {   # Pillow's SUPPORTED 32-bit (r, g, b, a) masks
    (0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
    (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000)}
_MASKS_16 = {(0xF800, 0x7E0, 0x1F): (11, 5, 0, 31, 63, 31),
             (0x7C00, 0x3E0, 0x1F): (10, 5, 0, 31, 31, 31)}


def is_bmp(head: bytes) -> bool:
    return head[:2] == b'BM'


def _info(data: bytes, name: str) -> dict:
    if len(data) < 18 or not is_bmp(data):
        raise OSError(f'{name}: not a BMP file')
    offset = struct.unpack('<I', data[10:14])[0]
    hsize = struct.unpack('<I', data[14:18])[0]
    if len(data) < 14 + hsize:
        raise OSError(f'{name}: truncated BMP header')
    hd = data[18:14 + hsize]
    info = {'offset': offset, 'header': hsize, 'masks': None}
    if hsize == 12:
        w, h, _, bits = struct.unpack('<HHHH', hd[:8])
        info.update(width=w, height=h, top_down=False, bits=bits,
                    compression=_BI_RGB, colors=0, entry=3)
    elif hsize in (40, 52, 56, 64, 108, 124):
        w, h, _, bits, comp = struct.unpack('<iiHHI', hd[:16])
        colors = struct.unpack('<I', hd[28:32])[0]
        info.update(width=w, height=abs(h), top_down=h < 0, bits=bits,
                    compression=comp, colors=colors, entry=4)
        pos = 14 + hsize
        if comp == _BI_BITFIELDS:
            if len(hd) >= 48:
                masks = list(struct.unpack('<III', hd[36:48]))
                masks.append(struct.unpack('<I', hd[48:52])[0]
                             if len(hd) >= 52 else 0)
            else:   # 40 bytes: three masks after the header
                if len(data) < pos + 12:
                    raise OSError(f'{name}: truncated BMP masks')
                masks = list(struct.unpack('<III', data[pos:pos + 12])) + [0]
                pos += 12
            info['masks'] = tuple(masks)
        info['palette_at'] = pos
    else:
        raise ValueError(f'{name}: BMP header of {hsize} bytes is not read')
    info.setdefault('palette_at', 14 + hsize)
    if info['width'] <= 0 or info['height'] <= 0:
        raise OSError(f'{name}: BMP of size {info["width"]}x'
                      f'{info["height"]}')
    return info


def bmp_size(head: bytes, name: str = '<bytes>') -> Tuple[int, int]:
    """(width, height) from the first 26 bytes or more."""
    if len(head) < 26 or not is_bmp(head):
        raise OSError(f'{name}: not a BMP file')
    if struct.unpack('<I', head[14:18])[0] == 12:
        return struct.unpack('<HH', head[18:22])
    w, h = struct.unpack('<ii', head[18:26])
    return w, abs(h)


def _widen(v: np.ndarray, bits_max: int) -> np.ndarray:
    return (v.astype(np.int32) * 255 // bits_max).astype(np.uint8)


def decode_bmp(data: bytes, name: str = '<bytes>') -> np.ndarray:
    """BMP bytes -> uint8 RGB [H, W, 3]."""
    info = _info(data, name)
    w, h, bits, comp = (info['width'], info['height'], info['bits'],
                        info['compression'])
    if comp in (_BI_RLE8, _BI_RLE4):
        raise ValueError(f'{name}: RLE-compressed BMP is not read')
    if comp not in (_BI_RGB, _BI_BITFIELDS):
        raise ValueError(f'{name}: BMP compression {comp} is not read')
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f'{name}: {bits}-bit BMP is not read')
    masks = info['masks']
    if comp == _BI_BITFIELDS and not (
            (bits == 32 and (masks in _MASKS_32 or masks == (0, 0, 0, 0)))
            or (bits == 16 and masks[:3] in _MASKS_16)
            or (bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF))):
        raise ValueError(f'{name}: BMP bitfields {masks} are not read')
    offset = info['offset']
    palette = None
    if bits <= 8:
        colors = info['colors'] or (1 << bits)
        if not 0 < colors <= 65536:
            raise OSError(f'{name}: BMP palette of {colors} colours')
        at, entry = info['palette_at'], info['entry']
        raw = data[at:at + entry * colors]
        if len(raw) < entry * colors:
            raise OSError(f'{name}: truncated BMP palette')
        pal = np.frombuffer(raw, np.uint8).reshape(colors, entry)
        palette = np.zeros((max(256, colors), 3), np.uint8)
        palette[:colors] = pal[:, 2::-1]          # BGR(X) -> RGB
        if offset == 14 + info['header']:   # an offset that skips nothing
            offset += 4 * colors
    stride = ((w * bits + 31) >> 3) & ~3
    body = data[offset:offset + stride * h]
    if len(body) < stride * h:
        raise OSError(f'{name}: truncated BMP pixel data')
    rows = np.frombuffer(body, np.uint8).reshape(h, stride)
    if not info['top_down']:
        rows = rows[::-1]
    if bits <= 8:
        per = 8 // bits
        if bits == 8:
            idx = rows[:, :w]
        else:
            shifts = (8 - bits) - bits * np.arange(per)
            idx = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1))
            idx = idx.reshape(h, -1)[:, :w]
        return palette[idx]
    if bits == 24:
        return np.ascontiguousarray(
            rows[:, :w * 3].reshape(h, w, 3)[..., ::-1])
    if bits == 16:
        v = rows[:, :w * 2].copy().view('<u2').astype(np.int32)
        rs, gs, bs, rm, gm, bm = _MASKS_16[
            masks[:3] if comp == _BI_BITFIELDS else (0x7C00, 0x3E0, 0x1F)]
        return np.stack([_widen((v >> rs) & rm, rm),
                         _widen((v >> gs) & gm, gm),
                         _widen((v >> bs) & bm, bm)], -1)
    v = rows[:, :w * 4].copy().view('<u4')
    if comp == _BI_RGB or masks == (0, 0, 0, 0):
        masks = (0xFF0000, 0xFF00, 0xFF, 0)
    out = [((v >> (int(m).bit_length() - 8)) & 0xFF).astype(np.uint8)
           for m in masks[:3]]
    return np.stack(out, -1)
