"""JPEG frames without Pillow: bytes -> uint8 RGB [H, W, 3], byte-equal to
Pillow's ``Image.open(path).convert('RGB')`` on libjpeg-turbo's defaults.

Read: Huffman-coded 8-bit baseline (SOF0), extended sequential (SOF1) and
progressive (SOF2) files, the last with spectral selection and successive
approximation (DC and AC refinement); restart intervals (DRI / RSTn); one
component (grey, replicated to three channels) or three; any integer
sampling ratios (4:4:4, 4:2:2, 4:2:0, 4:4:0, ...).  Three components are
YCbCr unless an Adobe APP14 marker says transform 0, or, with neither a
JFIF nor an Adobe marker, the component ids are 'R', 'G', 'B' (libjpeg's
``default_decompress_parms``).  Arithmetic coding, 12-bit, lossless,
hierarchical, CMYK and YCCK files raise ``ValueError`` naming the file; a
truncated or damaged one raises ``OSError``, as ``png.decode_png`` does.

The stages are libjpeg-turbo's defaults, which Pillow does not change:
the ``JDCT_ISLOW`` integer IDCT (``jidctint.c``: ``CONST_BITS`` 13,
``PASS1_BITS`` 2, its range-limit table), fancy upsampling
(``jdsample.c``: h2v1 with biases 1/2, h2v2 with 8/7, libjpeg-turbo's
h1v2 with 1/2; box replication where the downsampled width is 2 or less,
or the ratio is another integer) and ``jdcolor.c``'s fixed-point
YCbCr -> RGB tables.  A progressive file is decoded whole before output,
so libjpeg's block smoothing, which fires only while coefficients are
still missing bits, does not run.

Markers are parsed here; the entropy decoding of each scan, the IDCT and
the upsampling with colour conversion run in the C++ core
(``_frames.cpp``, through :func:`png.library`).  :func:`scan_plain`,
:func:`idct_plain` and :func:`color_plain` are their plain versions, held
against the core byte for byte by the tests (``native=False`` decodes a
whole file through them).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from mmvid_tpu_torch.data import png

NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_READ = {0xC0: False, 0xC1: False, 0xC2: True}   # -> progressive
_SOF_REFUSED = {0xC3: 'lossless', 0xC5: 'hierarchical',
                0xC6: 'hierarchical', 0xC7: 'hierarchical',
                0xC9: 'arithmetic-coded', 0xCA: 'arithmetic-coded',
                0xCB: 'arithmetic-coded', 0xCD: 'arithmetic-coded',
                0xCE: 'arithmetic-coded', 0xCF: 'arithmetic-coded'}
_ERRORS = {1: 'a bad Huffman code', 2: 'entropy-coded data cut short',
           3: 'a restart marker out of sequence',
           4: 'a coefficient index past 63'}


def is_jpeg(head: bytes) -> bool:
    return head[:2] == b'\xff\xd8'


class _Comp:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.q: Optional[np.ndarray] = None   # latched at its first scan


class _Frame:
    """The frame header and the geometry of every component's blocks."""

    def __init__(self, seg: bytes, marker: int, name: str):
        if len(seg) < 6:
            raise OSError(f'{name}: truncated SOF segment')
        precision, self.height, self.width, nf = struct.unpack(
            '>BHHB', seg[:6])
        if precision != 8:
            raise ValueError(f'{name}: {precision}-bit JPEG is not read '
                             '(8-bit only)')
        if self.height == 0 or self.width == 0:
            raise ValueError(f'{name}: a JPEG without its height in the '
                             'frame header (DNL) is not read')
        if nf not in (1, 3):
            kind = 'CMYK or YCCK' if nf == 4 else f'{nf}-component'
            raise ValueError(f'{name}: {kind} JPEG is not read (grey and '
                             'three-component only)')
        if len(seg) < 6 + 3 * nf:
            raise OSError(f'{name}: truncated SOF segment')
        self.progressive = _SOF_READ[marker]
        self.comps: List[_Comp] = []
        for i in range(nf):
            cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                raise OSError(f'{name}: bad component {cid} in SOF')
            self.comps.append(_Comp(cid, h, v, tq))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        for c in self.comps:
            if self.hmax % c.h or self.vmax % c.v:
                raise ValueError(f'{name}: fractional JPEG sampling ratios '
                                 'are not read')
        self.mx = -(-self.width // (8 * self.hmax))
        self.my = -(-self.height // (8 * self.vmax))
        off = 0
        for c in self.comps:
            c.dw = -(-self.width * c.h // self.hmax)    # downsampled size
            c.dh = -(-self.height * c.v // self.vmax)
            c.cols, c.rows = -(-c.dw // 8), -(-c.dh // 8)
            c.bw, c.bh = self.mx * c.h, self.my * c.v    # buffer, blocks
            c.off = off
            off += c.bw * c.bh
        self.coef = np.zeros((off, 64), np.int16)
        self.transform = 1


def _u16(data: bytes, pos: int, name: str) -> int:
    if pos + 2 > len(data):
        raise OSError(f'{name}: truncated JPEG')
    return struct.unpack('>H', data[pos:pos + 2])[0]


def _markers(data: bytes, name: str):
    """(marker, segment payload, position after it), from SOI on; the
    caller moves ``pos`` past entropy-coded data by ``send``."""
    if not is_jpeg(data):
        raise OSError(f'{name}: not a JPEG file')
    pos = 2
    while True:
        i = data.find(b'\xff', pos)   # extraneous bytes are skipped
        if i < 0:
            raise OSError(f'{name}: truncated JPEG (no EOI)')
        pos = i
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise OSError(f'{name}: truncated JPEG (no EOI)')
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            return
        if marker == 0x00 or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue   # stray stuffing, restart markers, TEM
        n = _u16(data, pos, name)
        if n < 2 or pos + n > len(data):
            raise OSError(f'{name}: truncated JPEG segment {marker:#04x}')
        new = yield marker, data[pos + 2:pos + n], pos + n
        pos = pos + n if new is None else new


def _scan_end(data: bytes, pos: int, name: str) -> int:
    """The offset of the first marker after ``pos`` that is neither a
    stuffed 0xFF nor RSTn: where a scan's entropy-coded bytes end."""
    while True:
        i = data.find(b'\xff', pos)
        if i < 0:
            raise OSError(f'{name}: truncated JPEG (scan data cut short)')
        j = i + 1
        while j < len(data) and data[j] == 0xFF:
            j += 1
        if j >= len(data):
            raise OSError(f'{name}: truncated JPEG (scan data cut short)')
        if data[j] == 0x00 or 0xD0 <= data[j] <= 0xD7:
            pos = j + 1
            continue
        return j - 1


def _dqt(seg: bytes, qt: Dict[int, np.ndarray], name: str):
    pos = 0
    while pos < len(seg):
        pq, tq = seg[pos] >> 4, seg[pos] & 15
        n = 128 if pq else 64
        if tq > 3 or pos + 1 + n > len(seg):
            raise OSError(f'{name}: bad DQT segment')
        vals = np.frombuffer(seg[pos + 1:pos + 1 + n],
                             '>u2' if pq else np.uint8).astype(np.uint16)
        q = np.zeros(64, np.uint16)
        q[NATURAL] = vals          # zigzag -> natural order
        qt[tq] = q
        pos += 1 + n


def _dht(seg: bytes, tables: Dict[Tuple[int, int], np.ndarray], name: str):
    pos = 0
    while pos < len(seg):
        tc, th = seg[pos] >> 4, seg[pos] & 15
        if pos + 17 > len(seg) or tc > 1 or th > 3:
            raise OSError(f'{name}: bad DHT segment')
        bits = np.frombuffer(seg[pos + 1:pos + 17], np.uint8)
        n = int(bits.sum())
        if n > 256 or pos + 17 + n > len(seg):
            raise OSError(f'{name}: bad DHT segment')
        table = np.zeros(272, np.uint8)
        table[:16] = bits
        table[16:16 + n] = np.frombuffer(seg[pos + 17:pos + 17 + n],
                                         np.uint8)
        tables[(tc, th)] = table
        pos += 17 + n


def _colour_transform(frame: _Frame, jfif: bool, adobe: Optional[int]
                      ) -> int:
    """1 for YCbCr, 0 for RGB components (libjpeg's rule for three)."""
    if jfif:
        return 1
    if adobe is not None:
        return 0 if adobe == 0 else 1
    ids = tuple(c.id for c in frame.comps)
    return 0 if ids == (82, 71, 66) else 1


def decode_jpeg(data: bytes, name: str = '<bytes>', native: bool = True
                ) -> np.ndarray:
    """JPEG bytes -> uint8 RGB [H, W, 3]; ``native=False`` runs every
    stage's plain version instead of the C++ core."""
    frame = coefficients(data, name, native)
    planes, prm = idct_planes(frame, name, native)
    return color(planes, prm, frame, native)


def coefficients(data: bytes, name: str = '<bytes>', native: bool = True
                 ) -> _Frame:
    """Parse the markers and entropy-decode every scan: the frame, its
    ``coef`` ([blocks, 64] int16 in natural order) filled and its
    ``transform`` set (1 YCbCr, 0 RGB)."""
    frame: Optional[_Frame] = None
    qt: Dict[int, np.ndarray] = {}
    tables: Dict[Tuple[int, int], np.ndarray] = {}
    restart, jfif, adobe = 0, False, None
    it = _markers(data, name)
    step = None
    while True:
        try:
            marker, seg, after = it.send(step)
        except StopIteration:
            break
        step = None
        if marker == 0xE0 and seg[:5] == b'JFIF\x00':
            jfif = True
        elif marker == 0xEE and seg[:5] == b'Adobe' and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDB:
            _dqt(seg, qt, name)
        elif marker == 0xC4:
            _dht(seg, tables, name)
        elif marker == 0xDD:
            if len(seg) < 2:
                raise OSError(f'{name}: bad DRI segment')
            restart = struct.unpack('>H', seg[:2])[0]
        elif marker == 0xCC:
            raise ValueError(f'{name}: arithmetic-coded JPEG is not read')
        elif marker in _SOF_REFUSED:
            raise ValueError(f'{name}: {_SOF_REFUSED[marker]} JPEG is not '
                             'read')
        elif marker in _SOF_READ:
            if frame is not None:
                raise OSError(f'{name}: two frame headers')
            frame = _Frame(seg, marker, name)
        elif marker == 0xDA:
            if frame is None:
                raise OSError(f'{name}: a scan before the frame header')
            end = _scan_end(data, after, name)
            _decode_scan(frame, seg, data[after:end], qt, tables, restart,
                         name, native)
            step = end
    if frame is None:
        raise OSError(f'{name}: no frame header in JPEG')
    frame.transform = _colour_transform(frame, jfif, adobe)
    return frame


def _decode_scan(frame: _Frame, seg: bytes, body: bytes, qt, tables,
                 restart: int, name: str, native: bool):
    ns = seg[0] if seg else 0
    if not 1 <= ns <= 4 or len(seg) < 4 + 2 * ns:
        raise OSError(f'{name}: bad SOS segment')
    ss, se, a = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    ah, al = a >> 4, a & 15
    byid = {c.id: c for c in frame.comps}
    huff = np.zeros((8, 272), np.uint8)
    prm = [ns, ss, se, ah, al, restart, frame.mx, frame.my,
           int(frame.progressive)]
    for i in range(ns):
        cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in byid:
            raise OSError(f'{name}: scan names component {cid}, not in the '
                          'frame')
        c = byid[cid]
        td, ta = t >> 4, t & 15
        if td > 3 or ta > 3:
            raise OSError(f'{name}: bad Huffman table number in SOS')
        dc_needed = not frame.progressive or (ss == 0 and ah == 0)
        ac_needed = not frame.progressive or ss > 0
        for cls, th, need in ((0, td, dc_needed), (1, ta, ac_needed)):
            if need and (cls, th) not in tables:
                raise OSError(f'{name}: scan uses Huffman table {cls}/{th}, '
                              'which is not defined')
        if (0, td) in tables:
            huff[td] = tables[(0, td)]
        if (1, ta) in tables:
            huff[4 + ta] = tables[(1, ta)]
        if c.q is None:   # libjpeg latches the table at the first scan
            if c.tq not in qt:
                raise OSError(f'{name}: component {cid} uses quantization '
                              f'table {c.tq}, which is not defined')
            c.q = qt[c.tq].copy()
        prm += [c.off, c.bw, c.h, c.v, td, ta, c.cols, c.rows]
    if frame.progressive:
        if se > 63 or ss > se or (ss == 0 and se != 0) or (ss > 0 and
                                                            ns != 1):
            raise OSError(f'{name}: bad progressive scan parameters')
    prm = np.asarray(prm, np.int64)
    if native:
        err = png.library().frames_jpeg_scan(
            _bytes_ptr(body), len(body), _i64(prm), png._ptr(huff),
            frame.coef.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    else:
        err = scan_plain(body, prm, huff, frame.coef)
    if err:
        raise OSError(f'{name}: damaged JPEG ({_ERRORS[err]})')


def idct_planes(frame: _Frame, name: str = '<bytes>', native: bool = True
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Every component's IDCT plane, concatenated (uint8), and the
    parameters of ``frames_jpeg_color`` that locate them."""
    planes, prm = [], [len(frame.comps), frame.width, frame.height,
                       frame.hmax, frame.vmax, frame.transform]
    off = 0
    for c in frame.comps:
        if c.q is None:
            raise OSError(f'{name}: component {c.id} is in no scan')
        coef = frame.coef[c.off:c.off + c.bh * c.bw]
        if native:
            plane = np.empty((c.bh * 8, c.bw * 8), np.uint8)
            png.library().frames_jpeg_idct(
                coef.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), c.bh,
                c.bw, c.q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                png._ptr(plane))
        else:
            plane = idct_plain(coef, c.bh, c.bw, c.q)
        planes.append(plane.reshape(-1))
        prm += [off, c.bw * 8, c.h, c.v, c.dw, c.dh]
        off += plane.size
    return np.concatenate(planes), np.asarray(prm, np.int64)


def color(planes: np.ndarray, prm: np.ndarray, frame: _Frame,
          native: bool = True) -> np.ndarray:
    """Upsample and convert :func:`idct_planes`' output to RGB."""
    if not native:
        return color_plain(planes, prm)
    out = np.empty((frame.height, frame.width, 3), np.uint8)
    png.library().frames_jpeg_color(png._ptr(planes), _i64(prm),
                                    png._ptr(out))
    return out


def _bytes_ptr(b: bytes):
    return ctypes.cast(ctypes.c_char_p(b), ctypes.POINTER(ctypes.c_uint8))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def jpeg_size(data: bytes, name: str = '<bytes>') -> Tuple[int, int]:
    """(width, height) from the frame header."""
    for marker, seg, _ in _markers(data, name):
        if marker in _SOF_READ or marker in _SOF_REFUSED:
            if len(seg) < 5:
                raise OSError(f'{name}: truncated SOF segment')
            h, w = struct.unpack('>HH', seg[1:5])
            return w, h
        if marker == 0xDA:
            break
    raise OSError(f'{name}: no frame header in JPEG')


# -- plain versions ----------------------------------------------------------

class _PlainBits:
    """The core's bit reader: stuffed 0xFF and fill bytes undone, zero
    bits fed (and counted) at a marker or the end."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.p = data, pos
        self.bits: List[int] = []
        self.stop = False
        self.padded = 0

    def _byte(self):
        d = self.data
        if not self.stop:
            if self.p >= len(d):
                self.stop = True
            elif d[self.p] != 0xFF:
                self.p += 1
                return d[self.p - 1]
            else:
                q = self.p + 1
                while q < len(d) and d[q] == 0xFF:
                    q += 1
                if q < len(d) and d[q] == 0:
                    self.p = q + 1
                    return 0xFF
                self.stop = True
                self.p = q - 1
        self.padded += 8
        return 0

    def bit(self) -> int:
        if not self.bits:
            b = self._byte()
            self.bits = [(b >> (7 - i)) & 1 for i in range(8)][::-1]
        return self.bits.pop()

    def get(self, k: int) -> int:
        v = 0
        for _ in range(k):
            v = (v << 1) | self.bit()
        return v

    def overrun(self) -> bool:
        # padding is the tail: the unread bits of the current byte are the
        # last of it
        return self.padded > len(self.bits)


def _plain_table(t: np.ndarray):
    bits, vals = [int(x) for x in t[:16]], [int(x) for x in t[16:]]
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            if k < 256:
                codes[(length, code)] = vals[k]
            k += 1
            code += 1
        code <<= 1
    return codes


def _plain_decode(b: _PlainBits, codes) -> int:
    code = 0
    for length in range(1, 17):
        code = (code << 1) | b.bit()
        if (length, code) in codes:
            return codes[(length, code)]
    return -1


def _extend(r: int, s: int) -> int:
    return r - (1 << s) + 1 if r < (1 << (s - 1)) else r


def _plain_block(b, blk, dc, ac, pred, eob, prog, ss, se, ah, al):
    """One block; pred and eob are one-element lists.  Returns an error
    code as the core does."""
    if not prog:
        s = _plain_decode(b, dc)
        if s < 0:
            return 1
        pred[0] += _extend(b.get(s), s) if s else 0
        blk[0] = pred[0]
        k = 1
        while k < 64:
            rs = _plain_decode(b, ac)
            if rs < 0:
                return 1
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if k > 63:
                    return 4
                blk[NATURAL[k]] = _extend(b.get(s), s)
            elif r == 15:
                k += 15
            else:
                break
            k += 1
        return 0
    if ss == 0:
        if ah == 0:
            s = _plain_decode(b, dc)
            if s < 0:
                return 1
            pred[0] += _extend(b.get(s), s) if s else 0
            blk[0] = pred[0] * (1 << al)
        elif b.get(1):
            blk[0] = int(blk[0]) | (1 << al)
        return 0
    if ah == 0:
        if eob[0] > 0:
            eob[0] -= 1
            return 0
        k = ss
        while k <= se:
            rs = _plain_decode(b, ac)
            if rs < 0:
                return 1
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if k > 63:
                    return 4
                blk[NATURAL[k]] = _extend(b.get(s), s) * (1 << al)
            elif r == 15:
                k += 15
            else:
                eob[0] = (1 << r) - 1 + (b.get(r) if r else 0)
                break
            k += 1
        return 0
    p1, m1 = 1 << al, -(1 << al)

    def refine(pos):
        c = int(blk[pos])
        if b.get(1) and (c & p1) == 0:
            blk[pos] = c + p1 if c >= 0 else c + m1

    k = ss
    if eob[0] == 0:
        while k <= se:
            rs = _plain_decode(b, ac)
            if rs < 0:
                return 1
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if b.get(1) else m1
            elif r != 15:
                eob[0] = (1 << r) + (b.get(r) if r else 0)
                break
            while k <= se:
                pos = NATURAL[k]
                if blk[pos] != 0:
                    refine(pos)
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                if k > 63:
                    return 4
                blk[NATURAL[k]] = s
            k += 1
    if eob[0] > 0:
        while k <= se:
            if blk[NATURAL[k]] != 0:
                refine(NATURAL[k])
            k += 1
        eob[0] -= 1
    return 0


def scan_plain(body: bytes, prm: np.ndarray, huff: np.ndarray,
               coef: np.ndarray) -> int:
    """The plain version of ``frames_jpeg_scan``: the same parameters, a
    bit at a time; updates ``coef`` in place and returns the same code."""
    prm = [int(x) for x in prm]
    ns, ss, se, ah, al, interval, mx, my, prog = prm[:9]
    comps = [prm[9 + 8 * i:17 + 8 * i] for i in range(ns)]
    tabs = [_plain_table(huff[t]) for t in range(8)]
    b = _PlainBits(body)
    preds = [[0] for _ in range(ns)]
    eob, rst = [0], 0
    total = comps[0][6] * comps[0][7] if ns == 1 else mx * my
    work = coef.astype(np.int64)   # int16 arithmetic as the core's
    for m in range(total):
        if interval and m and m % interval == 0:
            if b.overrun():
                return 2
            q, d = b.p, body
            while True:
                while q < len(d) and d[q] != 0xFF:
                    q += 1
                while q < len(d) and d[q] == 0xFF:
                    q += 1
                if q >= len(d):
                    return 2
                if d[q] != 0:
                    break
                q += 1
            if d[q] != 0xD0 + rst:
                return 3
            b = _PlainBits(body, q + 1)
            rst = (rst + 1) & 7
            preds = [[0] for _ in range(ns)]
            eob = [0]
        for i, (off, bw, h, v, td, ta, cols, rows) in enumerate(comps):
            if ns == 1:
                blocks = [off + (m // cols) * bw + m % cols]
            else:
                r0, c0 = (m // mx) * v, (m % mx) * h
                blocks = [off + (r0 + y) * bw + c0 + x for y in range(v)
                          for x in range(h)]
            for blk in blocks:
                row = work[blk]
                err = _plain_block(b, row, tabs[td], tabs[4 + ta], preds[i],
                                   eob, prog, ss, se, ah, al)
                work[blk] = ((row + 32768) & 65535) - 32768
                if err:
                    coef[:] = work
                    return err
        if b.overrun():
            coef[:] = work
            return 2
    coef[:] = work
    return 2 if b.overrun() else 0


_CONST_BITS, _PASS1_BITS = 13, 2
_F = dict(f0_298=2446, f0_390=3196, f0_541=4433, f0_765=6270,
          f0_899=7373, f1_175=9633, f1_501=12299, f1_847=15137,
          f1_961=16069, f2_053=16819, f2_562=20995, f3_072=25172)


def _idct_1d(x):
    """jidctint.c's even and odd parts along the last axis, before the
    pass's descale."""
    f = _F
    z2, z3 = x[..., 2], x[..., 6]
    z1 = (z2 + z3) * f['f0_541']
    tmp2 = z1 + z3 * -f['f1_847']
    tmp3 = z1 + z2 * f['f0_765']
    tmp0 = (x[..., 0] + x[..., 4]) << _CONST_BITS
    tmp1 = (x[..., 0] - x[..., 4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f['f1_175']
    t0, t1 = t0 * f['f0_298'], t1 * f['f2_053']
    t2, t3 = t2 * f['f3_072'], t3 * f['f1_501']
    z1, z2 = z1 * -f['f0_899'], z2 * -f['f2_562']
    z3, z4 = z3 * -f['f1_961'] + z5, z4 * -f['f0_390'] + z5
    t0, t1 = t0 + z1 + z3, t1 + z2 + z4
    t2, t3 = t2 + z2 + z3, t3 + z1 + z4
    return np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                     tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], -1)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def idct_plain(coef: np.ndarray, bh: int, bw: int, q: np.ndarray
               ) -> np.ndarray:
    """The plain version of ``frames_jpeg_idct``: [bh * bw, 64] blocks ->
    the plane [bh * 8, bw * 8], every block at once."""
    x = coef.astype(np.int64).reshape(-1, 8, 8) * q.astype(
        np.int64).reshape(8, 8)
    cols = _idct_1d(np.swapaxes(x, 1, 2))            # [n, col, row]
    ws = np.swapaxes(_descale(cols, _CONST_BITS - _PASS1_BITS), 1, 2)
    ws = ws.astype(np.int32).astype(np.int64)
    rows = _descale(_idct_1d(ws), _CONST_BITS + _PASS1_BITS + 3)
    t = rows & 1023                                   # the range limit
    out = np.where(t < 128, t + 128, np.where(t < 512, 255, np.where(
        t < 896, 0, t - 896))).astype(np.uint8)
    return out.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
        bh * 8, bw * 8)


def _fix16(x: float) -> int:
    return int(x * 65536.0 + 0.5)


def _upsample_plain(src: np.ndarray, W: int, H: int, hr: int, vr: int,
                    dw: int, dh: int) -> np.ndarray:
    c = src[:dh, :dw].astype(np.int32)
    if hr == 1 and vr == 1:
        return c[:H, :W].astype(np.uint8)
    j = np.arange(W) // 2
    odd_x = (np.arange(W) & 1).astype(bool)
    i = np.arange(H) // 2
    odd_y = (np.arange(H) & 1).astype(bool)
    if hr == 2 and vr == 1 and dw > 2:
        left = c[:H, np.maximum(j - 1, 0)]
        right = c[:H, np.minimum(j + 1, dw - 1)]
        v3 = c[:H, j] * 3
        out = np.where(odd_x, (v3 + right + 2) >> 2, (v3 + left + 1) >> 2)
        return out.astype(np.uint8)
    if hr == 1 and vr == 2:
        nb = np.where(odd_y, np.minimum(i + 1, dh - 1), np.maximum(i - 1, 0))
        bias = np.where(odd_y, 2, 1)[:, None]
        return ((c[i, :W] * 3 + c[nb, :W] + bias) >> 2).astype(np.uint8)
    if hr == 2 and vr == 2 and dw > 2:
        nb = np.where(odd_y, np.minimum(i + 1, dh - 1), np.maximum(i - 1, 0))
        cs = c[i] * 3 + c[nb]                          # [H, dw]
        t3 = cs[:, j] * 3
        left = cs[:, np.maximum(j - 1, 0)]
        right = cs[:, np.minimum(j + 1, dw - 1)]
        out = np.where(odd_x, (t3 + right + 7) >> 4, (t3 + left + 8) >> 4)
        return out.astype(np.uint8)
    return c[np.arange(H) // vr][:, np.arange(W) // hr].astype(np.uint8)


def color_plain(planes: np.ndarray, prm: np.ndarray) -> np.ndarray:
    """The plain version of ``frames_jpeg_color``, with numpy."""
    prm = [int(x) for x in prm]
    n, W, H, hmax, vmax, ycc = prm[:6]
    full = []
    for ci in range(n):
        off, stride, h, v, dw, dh = prm[6 + 6 * ci:12 + 6 * ci]
        rows = -(-dh // 8) * 8
        src = planes[off:off + rows * stride].reshape(rows, stride)
        full.append(_upsample_plain(src, W, H, hmax // h, vmax // v, dw, dh)
                    .astype(np.int64))
    if n == 1:
        return np.repeat(full[0][..., None], 3, axis=2).astype(np.uint8)
    if not ycc:
        return np.stack(full, -1).astype(np.uint8)
    y, cb, cr = full
    xb, xr = cb - 128, cr - 128
    r = y + ((_fix16(1.40200) * xr + 32768) >> 16)
    g = y + ((-_fix16(0.34414) * xb + 32768 - _fix16(0.71414) * xr) >> 16)
    b = y + ((_fix16(1.77200) * xb + 32768) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)
