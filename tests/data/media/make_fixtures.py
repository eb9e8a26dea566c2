#!/usr/bin/env python3
"""Write the JPEG and BMP fixtures of this folder, each with its decode by
Pillow (``Image.open(p).convert('RGB')``) as ``<name>.png`` beside it.

The port's readers (``mmvid_tpu_torch/data/jpeg.py``, ``bmp.py``) are
held byte-equal to those decodes by ``tests/test_torch_media.py`` on a
host with Pillow and by ``chip_smoke.py::phase_media`` on one without.
The JPEGs come from Pillow's encoder (libjpeg-turbo) and OpenCV's (for
4:4:0); the SOF1 file is a baseline one with its tables rewritten at
16-bit precision; the BMPs not written by Pillow come from
:func:`write_bmp`.  Run from anywhere: ``python make_fixtures.py``.
"""

import io
import os
import struct

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))


def smooth(rng, h, w):
    """A moving gradient with noise, as camera frames look."""
    y, x = np.mgrid[:h, :w]
    base = rng.randint(0, 256, 3)
    img = (x[..., None] * (1 + base % 3) + y[..., None] * 2 + base
           + rng.randint(0, 32, (h, w, 3)))
    return (img % 256).astype(np.uint8)


def jpeg_bytes(img, **kw):
    b = io.BytesIO()
    Image.fromarray(img).save(b, 'JPEG', **kw)
    return b.getvalue()


def sof1_16bit(data: bytes) -> bytes:
    """A baseline JPEG rewritten as SOF1 with 16-bit quantization
    tables (the same values)."""
    out, pos = bytearray(data[:2]), 2
    while True:
        m = data[pos + 1]
        if m == 0xDA:
            return bytes(out + data[pos:])
        n = struct.unpack('>H', data[pos + 2:pos + 4])[0]
        seg = data[pos + 4:pos + 2 + n]
        if m == 0xDB:
            new, p = bytearray(), 0
            while p < len(seg):
                new += bytes([0x10 | (seg[p] & 15)]) + b''.join(
                    struct.pack('>H', v) for v in seg[p + 1:p + 65])
                p += 65
            seg = bytes(new)
        out += bytes([0xFF, 0xC1 if m == 0xC0 else m])
        out += struct.pack('>H', len(seg) + 2) + seg
        pos += 2 + n


def write_bmp(idx_or_rgb, bits, palette=None, top_down=False, masks=None,
              core=False) -> bytes:
    """A BMP of uint8 [H, W] indices (bits <= 8, ``palette`` [N, 3] RGB),
    [H, W] uint16 values (16 bits) or [H, W, 3] RGB (24, 32 bits);
    ``masks`` (r, g, b) writes BI_BITFIELDS after a 40-byte header;
    ``core`` a 12-byte OS/2 header."""
    a = np.asarray(idx_or_rgb)
    h, w = a.shape[:2]
    if bits <= 8:
        per = 8 // bits
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = a
        g = padded.reshape(h, -1, per).astype(np.uint32)
        shifts = (8 - bits) - bits * np.arange(per)
        rows = (g << shifts).sum(-1).astype(np.uint8)
    elif bits == 16:
        rows = a.astype('<u2').view(np.uint8).reshape(h, -1)
    elif bits == 24:
        rows = a[..., ::-1].reshape(h, -1)
    else:
        x = np.zeros((h, w, 4), np.uint8)
        x[..., :3] = a[..., ::-1]
        x[..., 3] = 0x5A   # ignored
        rows = x.reshape(h, -1)
    stride = ((w * bits + 31) >> 3) & ~3
    body = np.zeros((h, stride), np.uint8)
    body[:, :rows.shape[1]] = rows
    if not top_down:
        body = body[::-1]
    if core:
        header = struct.pack('<IHHHH', 12, w, h, 1, bits)
        entry = 3
    else:
        header = struct.pack('<IiiHHIIiiII', 40, w, -h if top_down else h,
                             1, bits, 3 if masks else 0, body.size, 2835,
                             2835, 0, 0)
        entry = 4
    extra = struct.pack('<III', *masks) if masks else b''
    pal = b''
    if palette is not None:
        p = np.zeros((len(palette), entry), np.uint8)
        p[:, :3] = np.asarray(palette, np.uint8)[:, ::-1]
        pal = p.tobytes()
    offset = 14 + len(header) + len(extra) + len(pal)
    return (b'BM' + struct.pack('<IHHI', offset + body.size, 0, 0, offset)
            + header + extra + pal + body.tobytes())


def fixtures():
    rng = np.random.RandomState(19)
    big, small, odd = smooth(rng, 128, 128), smooth(rng, 48, 64), \
        smooth(rng, 37, 53)
    out = {
        'baseline_q75_420_128.jpg': jpeg_bytes(big, quality=75,
                                               subsampling=2),
        'baseline_q10_444.jpg': jpeg_bytes(small, quality=10, subsampling=0),
        'baseline_q50_422.jpg': jpeg_bytes(small, quality=50, subsampling=1),
        'baseline_q95_420_odd.jpg': jpeg_bytes(odd, quality=95,
                                               subsampling=2),
        'restart_q80_420_odd.jpg': jpeg_bytes(odd, quality=80, subsampling=2,
                                              restart_marker_blocks=3),
        'progressive_q75_420_odd.jpg': jpeg_bytes(odd, quality=75,
                                                  subsampling=2,
                                                  progressive=True),
        'progressive_restart_q90_444.jpg': jpeg_bytes(
            small, quality=90, subsampling=0, progressive=True,
            restart_marker_blocks=2),
        'grey_q75_odd.jpg': jpeg_bytes(odd[..., 1], quality=75),
        'grey_progressive_q60.jpg': jpeg_bytes(small[..., 0], quality=60,
                                               progressive=True),
        'adobe_rgb_q90.jpg': jpeg_bytes(odd, quality=90, keep_rgb=True),
        'sof1_16bit_q40_422.jpg': sof1_16bit(jpeg_bytes(small, quality=40,
                                                        subsampling=1)),
    }
    ok, enc = cv2.imencode('.jpg', odd[..., ::-1], [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
        cv2.IMWRITE_JPEG_QUALITY, 85])
    assert ok
    out['opencv_q85_440_odd.jpg'] = enc.tobytes()
    pal16 = rng.randint(0, 256, (16, 3))
    pal256 = rng.randint(0, 256, (256, 3))
    px = rng.randint(0, 65536, (21, 19)).astype(np.uint16)
    out.update({
        'bits1.bmp': write_bmp(rng.randint(0, 2, (21, 19)), 1,
                               [(10, 200, 30), (250, 5, 120)]),
        'bits4.bmp': write_bmp(rng.randint(0, 16, (21, 19)), 4, pal16),
        'bits4_core.bmp': write_bmp(rng.randint(0, 16, (21, 19)), 4, pal16,
                                    core=True),
        'bits8.bmp': write_bmp(rng.randint(0, 256, (21, 19)), 8, pal256),
        'bits8_grey_top_down.bmp': write_bmp(
            rng.randint(0, 256, (21, 19)), 8, [(i, i, i) for i in range(256)],
            top_down=True),
        'bits16_555.bmp': write_bmp(px, 16),
        'bits16_565_bitfields.bmp': write_bmp(px, 16,
                                              masks=(0xF800, 0x7E0, 0x1F)),
        'bits24.bmp': write_bmp(odd[:21, :19], 24),
        'bits24_top_down.bmp': write_bmp(odd[:21, :19], 24, top_down=True),
        'bits32.bmp': write_bmp(odd[:21, :19], 32),
        'bits32_bitfields.bmp': write_bmp(odd[:21, :19], 32,
                                          masks=(0xFF0000, 0xFF00, 0xFF)),
    })
    return out


def main():
    for name, data in fixtures().items():
        path = os.path.join(HERE, name)
        with open(path, 'wb') as f:
            f.write(data)
        rgb = np.asarray(Image.open(path).convert('RGB'))
        Image.fromarray(rgb).save(path + '.png', optimize=True)
        print(name, len(data), rgb.shape)


if __name__ == '__main__':
    main()
