"""MP4 writer without imageio or OpenCV: [T, H, W, 3] float in [0, 1] ->
an H.264 MP4 that ffmpeg-based readers play.

The video is H.264 High 4:4:4 Predictive made only of ``I_PCM``
macroblocks, so no transform or entropy coder is needed and nothing is
lost but the colour conversion (a 4:2:0 file would lose the chroma of
every 2 x 2 block: a mean of about 10/255 on noisy camera-like frames):

* each frame one IDR access unit, a single slice of ``I_PCM``
  macroblocks (``mb_type`` 25, ``pcm_alignment_zero_bit``s, then 256
  samples of each of Y, Cb and Cr), deblocking off;
* BT.601 limited-range YCbCr 4:4:4, each sample the BT.601 matrix in
  16-bit fixed point rounded to the nearest integer; the SPS's VUI
  states the matrix (SMPTE 170M), ``video_full_range_flag = 0`` and the
  frame rate, so decoders convert back as written;
* emulation prevention (``00 00 0x`` -> ``00 00 03 0x``) over every NAL
  payload;
* a frame whose size is not a multiple of 16 is padded by repeating its
  edge and cropped back in the SPS (4:4:4 crops to the pixel);
* an ISO BMFF file: ``ftyp``, then ``moov`` (one track, an ``avc1``
  sample entry with its ``avcC``, ``stts`` at ``fps``, ``stsz``,
  ``stsc``, ``stco``), then ``mdat`` with 4-byte NAL lengths.

About 49 KB a 128 x 128 frame.  ffmpeg's decoder (OpenCV's, imageio's)
reads it; browsers that decode only 4:2:0 H.264 do not, as they do not
play the ``mp4v`` files of JAX's OpenCV fallback either.  numpy and the
stdlib only; numpy's array operations release the GIL.
"""

from __future__ import annotations

import os
import struct
from typing import List, Union

import numpy as np

from mmvid_tpu_torch.utils.gif import to_uint8

PROFILE_IDC = 244         # High 4:4:4 Predictive
CONSTRAINT_FLAGS = 0x10   # constraint_set3: intra pictures only
MB_TYPE_I_PCM = 25


class _Bits:
    """An RBSP under construction, a bit at a time (headers only)."""

    def __init__(self):
        self.bits: List[int] = []

    def u(self, n: int, v: int):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def ue(self, v: int):
        x = v + 1
        self.u(x.bit_length() - 1, 0)
        self.u(x.bit_length(), x)

    def se(self, v: int):
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def align(self, bit: int = 0):
        while len(self.bits) % 8:
            self.bits.append(bit)

    def trailing(self):
        self.u(1, 1)
        self.align()

    def tobytes(self) -> bytes:
        assert len(self.bits) % 8 == 0
        return np.packbits(np.asarray(self.bits, np.uint8)).tobytes()


def escape(rbsp: bytes) -> bytes:
    """Emulation prevention: a 03 after every 00 00 that precedes a byte
    of 00-03."""
    out, start, pos = [], 0, 0
    while True:
        i = rbsp.find(b'\x00\x00', pos)
        if i < 0 or i + 2 >= len(rbsp):
            break
        if rbsp[i + 2] <= 3:
            out += [rbsp[start:i + 2], b'\x03']
            start = i + 2
        pos = i + 2
    out.append(rbsp[start:])
    return b''.join(out)


def _level(mbs: int) -> int:
    """The smallest level whose MaxFS holds the frame (Table A-1)."""
    for level, max_fs in ((30, 1620), (31, 3600), (40, 8192), (50, 22080),
                          (51, 36864)):
        if mbs <= max_fs:
            return level
    return 52


def sps(width: int, height: int, fps: float) -> bytes:
    """The sequence parameter set NAL unit (header byte included)."""
    mbw, mbh = -(-width // 16), -(-height // 16)
    b = _Bits()
    b.u(8, PROFILE_IDC)
    b.u(8, CONSTRAINT_FLAGS)
    b.u(8, _level(mbw * mbh))
    b.ue(0)              # seq_parameter_set_id
    b.ue(3)              # chroma_format_idc: 4:4:4
    b.u(1, 0)            # separate_colour_plane_flag
    b.ue(0)              # bit_depth_luma_minus8
    b.ue(0)              # bit_depth_chroma_minus8
    b.u(1, 0)            # qpprime_y_zero_transform_bypass_flag
    b.u(1, 0)            # seq_scaling_matrix_present_flag
    b.ue(0)              # log2_max_frame_num_minus4
    b.ue(2)              # pic_order_cnt_type: output order = decode order
    b.ue(1)              # max_num_ref_frames
    b.u(1, 0)            # gaps_in_frame_num_value_allowed_flag
    b.ue(mbw - 1)
    b.ue(mbh - 1)
    b.u(1, 1)            # frame_mbs_only_flag
    b.u(1, 1)            # direct_8x8_inference_flag
    crop_r, crop_b = mbw * 16 - width, mbh * 16 - height   # unit 1
    b.u(1, int(bool(crop_r or crop_b)))
    if crop_r or crop_b:
        for v in (0, crop_r, 0, crop_b):   # left, right, top, bottom
            b.ue(v)
    b.u(1, 1)            # vui_parameters_present_flag
    b.u(1, 0)            # aspect_ratio_info_present_flag
    b.u(1, 0)            # overscan_info_present_flag
    b.u(1, 1)            # video_signal_type_present_flag
    b.u(3, 5)            # video_format: unspecified
    b.u(1, 0)            # video_full_range_flag: limited range
    b.u(1, 1)            # colour_description_present_flag
    b.u(8, 6)            # colour_primaries: SMPTE 170M
    b.u(8, 6)            # transfer_characteristics: SMPTE 170M
    b.u(8, 6)            # matrix_coefficients: SMPTE 170M (BT.601)
    b.u(1, 0)            # chroma_loc_info_present_flag
    b.u(1, 1)            # timing_info_present_flag
    scale = int(round(fps * 1000))
    b.u(32, 1000)        # num_units_in_tick
    b.u(32, 2 * scale)   # time_scale: two ticks a frame
    b.u(1, 1)            # fixed_frame_rate_flag
    b.u(1, 0)            # nal_hrd_parameters_present_flag
    b.u(1, 0)            # vcl_hrd_parameters_present_flag
    b.u(1, 0)            # pic_struct_present_flag
    b.u(1, 1)            # bitstream_restriction_flag
    b.u(1, 1)            # motion_vectors_over_pic_boundaries_flag
    b.ue(0)              # max_bytes_per_pic_denom
    b.ue(0)              # max_bits_per_mb_denom
    b.ue(16)             # log2_max_mv_length_horizontal
    b.ue(16)             # log2_max_mv_length_vertical
    b.ue(0)              # max_num_reorder_frames: no output delay
    b.ue(1)              # max_dec_frame_buffering
    b.trailing()
    return b'\x67' + escape(b.tobytes())


def pps() -> bytes:
    """The picture parameter set NAL unit."""
    b = _Bits()
    b.ue(0)              # pic_parameter_set_id
    b.ue(0)              # seq_parameter_set_id
    b.u(1, 0)            # entropy_coding_mode_flag: CAVLC
    b.u(1, 0)            # bottom_field_pic_order_in_frame_present_flag
    b.ue(0)              # num_slice_groups_minus1
    b.ue(0)              # num_ref_idx_l0_default_active_minus1
    b.ue(0)              # num_ref_idx_l1_default_active_minus1
    b.u(1, 0)            # weighted_pred_flag
    b.u(2, 0)            # weighted_bipred_idc
    b.se(0)              # pic_init_qp_minus26
    b.se(0)              # pic_init_qs_minus26
    b.se(0)              # chroma_qp_index_offset
    b.u(1, 1)            # deblocking_filter_control_present_flag
    b.u(1, 0)            # constrained_intra_pred_flag
    b.u(1, 0)            # redundant_pic_cnt_present_flag
    b.trailing()
    return b'\x68' + escape(b.tobytes())


# BT.601's limited-range matrix, scaled by 2^16 and rounded:
# Y = 16 + (65.481 R + 128.553 G + 24.966 B) / 255, Cb and Cr 128 + ...
_YCC = ((16829, 33039, 6416), (-9714, -19070, 28784),
        (28784, -24103, -4681))


def ycbcr444(frame: np.ndarray) -> np.ndarray:
    """uint8 RGB [H, W, 3] -> BT.601 limited-range YCbCr [3, H, W], each
    rounded to the nearest integer (int32 sums: at most 255 * 56284)."""
    r, g, b = (frame[..., c].astype(np.int32) for c in range(3))
    return np.stack([((kr * r + kg * g + kb * b + 32768) >> 16) + off
                     for (kr, kg, kb), off in zip(_YCC, (16, 128, 128))]
                    ).astype(np.uint8)


def _pad(frame: np.ndarray) -> np.ndarray:
    h, w = frame.shape[:2]
    return np.pad(frame, ((0, -h % 16), (0, -w % 16), (0, 0)), mode='edge')


def idr_slice(frame: np.ndarray, idr_pic_id: int) -> bytes:
    """uint8 RGB [H16, W16, 3] (multiples of 16) -> one IDR slice NAL
    unit of I_PCM macroblocks."""
    h, w = frame.shape[:2]
    mbh, mbw = h // 16, w // 16
    # [3, H, W] -> each macroblock's 256 Y, then 256 Cb and 256 Cr
    mbs = ycbcr444(frame).reshape(3, mbh, 16, mbw, 16).transpose(
        1, 3, 0, 2, 4).reshape(mbh * mbw, 768)
    b = _Bits()
    b.ue(0)              # first_mb_in_slice
    b.ue(7)              # slice_type: I, every slice of the picture
    b.ue(0)              # pic_parameter_set_id
    b.u(4, 0)            # frame_num
    b.ue(idr_pic_id)
    b.u(1, 0)            # no_output_of_prior_pics_flag
    b.u(1, 0)            # long_term_reference_flag
    b.se(0)              # slice_qp_delta
    b.ue(1)              # disable_deblocking_filter_idc: off
    b.ue(MB_TYPE_I_PCM)
    b.align()            # pcm_alignment_zero_bit
    head = b.tobytes()
    # every later macroblock starts byte-aligned: mb_type's 9 bits and 7
    # alignment zeros are 0x0D 0x00
    rest = np.concatenate([np.tile(np.array([0x0D, 0x00], np.uint8),
                                   (len(mbs) - 1, 1)), mbs[1:]], axis=1)
    rbsp = b''.join([head, mbs[0].tobytes(), rest.tobytes(), b'\x80'])
    return b'\x65' + escape(rbsp)


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b''.join(parts)
    return struct.pack('>I', 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack('>I', (version << 24) | flags), *parts)


_MATRIX = struct.pack('>9I', 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _moov(width, height, fps, sizes, chunk_offset, sps_nal, pps_nal):
    n = len(sizes)
    timescale = int(round(fps * 1000))
    movie_ms = int(round(n * 1000 / fps))
    avcc = _box(b'avcC', bytes([1, PROFILE_IDC, CONSTRAINT_FLAGS,
                                sps_nal[3], 0xFF, 0xE1]),
                struct.pack('>H', len(sps_nal)), sps_nal, b'\x01',
                struct.pack('>H', len(pps_nal)), pps_nal)
    avc1 = _box(b'avc1', bytes(6), struct.pack('>H', 1), bytes(16),
                struct.pack('>HHIIIH', width, height, 0x480000, 0x480000,
                            0, 1),
                bytes(32), struct.pack('>Hh', 0x18, -1), avcc)
    stbl = _box(b'stbl',
                _full(b'stsd', 0, 0, struct.pack('>I', 1), avc1),
                _full(b'stts', 0, 0, struct.pack('>III', 1, n, 1000)),
                _full(b'stsc', 0, 0, struct.pack('>IIII', 1, 1, n, 1)),
                _full(b'stsz', 0, 0, struct.pack('>II', 0, n),
                      struct.pack(f'>{n}I', *sizes)),
                _full(b'stco', 0, 0, struct.pack('>II', 1, chunk_offset)))
    minf = _box(b'minf', _full(b'vmhd', 0, 1, bytes(8)),
                _box(b'dinf', _full(b'dref', 0, 0, struct.pack('>I', 1),
                                    _full(b'url ', 0, 1))),
                stbl)
    mdia = _box(b'mdia',
                _full(b'mdhd', 0, 0, struct.pack('>IIIIHH', 0, 0, timescale,
                                                 n * 1000, 0x55C4, 0)),
                _full(b'hdlr', 0, 0, struct.pack('>I4s', 0, b'vide'),
                      bytes(12), b'VideoHandler\x00'),
                minf)
    tkhd = _full(b'tkhd', 0, 3, struct.pack('>IIIII', 0, 0, 1, 0,
                                            movie_ms),
                 bytes(8), struct.pack('>hhhH', 0, 0, 0, 0), _MATRIX,
                 struct.pack('>II', width << 16, height << 16))
    mvhd = _full(b'mvhd', 0, 0, struct.pack('>IIIIIH', 0, 0, 1000, movie_ms,
                                            0x10000, 0x100),
                 bytes(10), _MATRIX, bytes(24), struct.pack('>I', 2))
    return _box(b'moov', mvhd, _box(b'trak', tkhd, mdia))


def encode_mp4(frames: np.ndarray, fps: float = 4) -> bytes:
    """uint8 [T, H, W, 3] -> the MP4 file's bytes."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f'encode_mp4 takes uint8 [T, H, W, 3], got '
                         f'{frames.dtype} {frames.shape}')
    t, h, w = frames.shape[:3]
    if t == 0:
        raise ValueError('encode_mp4: no frames')
    sps_nal, pps_nal = sps(w, h, fps), pps()
    samples = []
    for i, f in enumerate(frames):
        nal = idr_slice(_pad(f), i & 1)
        samples.append(struct.pack('>I', len(nal)) + nal)
    ftyp = _box(b'ftyp', b'isom', struct.pack('>I', 512),
                b'isom', b'iso2', b'avc1', b'mp41')
    sizes = [len(s) for s in samples]
    size = len(_moov(w, h, fps, sizes, 0, sps_nal, pps_nal))
    moov = _moov(w, h, fps, sizes, len(ftyp) + size + 8, sps_nal, pps_nal)
    mdat = struct.pack('>I', 8 + sum(sizes)) + b'mdat'
    return b''.join([ftyp, moov, mdat] + samples)


def save_mp4(path: Union[str, os.PathLike], frames: np.ndarray,
             fps: float = 4) -> None:
    """[T, H, W, 3] float in [0, 1] -> an MP4 at ``path``."""
    data = encode_mp4(to_uint8(np.asarray(frames)), fps)
    with open(path, 'wb') as f:
        f.write(data)
