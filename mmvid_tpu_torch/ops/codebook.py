"""Nearest codebook entry (the VQ encoder's lookup): the plain PyTorch
version and the wrapper of the hand-written CUDA kernel
(``csrc/codebook_sm90.cu``: 64-row by 128-code tiles across the grid, one
launch a call).

Counterpart of ``mmvid_tpu/ops/codebook.py``.  Both versions compute, in
fp32, ``argmax_j(z . e_j - 0.5 * |e_j|^2)`` (argmin of the distance
without its row-constant ``|z|^2``), the first index on an exact tie.

Dispatch rule of :func:`nearest_codebook_indices`: a CPU tensor goes to
:func:`nearest_codebook_reference`; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from mmvid_tpu_torch.ops import _build

# Kernel launches since the last reset (read by chip_smoke.py).
launches = 0

ROWS_PER_TILE = 64      # the kernel's tile: 64 rows of z by 128 codes
CODES_PER_TILE = 128
_MAX_ROW_TILES = 65535  # the grid's second axis
_fn = None
# per (device, stream): the kernel's row-tile counters, zero between calls
_counters = {}


def nearest_codebook_reference(z, codebook):
    """z [..., D], codebook [K, D] -> [...] int64 (fp32 scores, the
    formula of mmvid_tpu/ops/codebook.py::nearest_codebook_indices)."""
    flat = z.reshape(-1, z.shape[-1]).float()
    cb = codebook.float()
    scores = flat @ cb.t() - 0.5 * (cb * cb).sum(-1)[None, :]
    return scores.argmax(-1).reshape(z.shape[:-1])


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library().mmvid_nearest_code
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_cuda_args(flat, cb):
    m, d = flat.shape
    if cb.dim() != 2 or cb.shape[1] != d:
        raise ValueError(f'codebook must be [K, D={d}], got '
                         f'{tuple(cb.shape)}')
    if cb.device != flat.device:
        raise ValueError(f'codebook on {cb.device}, z on {flat.device}')
    if m == 0 or d == 0 or cb.shape[0] == 0:
        raise ValueError(f'empty input: z [{m}, {d}], codebook '
                         f'{tuple(cb.shape)}')
    if d % 4:
        raise ValueError(f'D={d} must be a multiple of 4')
    if -(-m // ROWS_PER_TILE) > _MAX_ROW_TILES:
        raise ValueError(f'M={m} exceeds {_MAX_ROW_TILES} row tiles')
    for name, t in (('z', flat), ('codebook', cb)):
        if t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')


def _row_tile_counters(device, row_tiles):
    """The kernel's per-row-tile counters for the current stream: zeros,
    which every call leaves zero (the last block of a row tile resets
    its counter), grown as M needs."""
    key = (device, _build.stream_handle(device))
    buf = _counters.get(key)
    if buf is None or buf.numel() < row_tiles:
        buf = torch.zeros((row_tiles,), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def nearest_codebook_indices(z, codebook):
    """z [..., D] latents, codebook [K, D] -> [...] int64 code ids (fp32
    scores whatever the input dtype)."""
    global launches
    if z.device.type == 'cpu':
        return nearest_codebook_reference(z, codebook)
    if z.device.type != 'cuda':
        raise ValueError(f'no codebook path for device {z.device}')
    flat = z.reshape(-1, z.shape[-1]).float().contiguous()
    cb = codebook.float().contiguous()
    _check_cuda_args(flat, cb)
    (m, d), k = flat.shape, cb.shape[0]
    code_tiles = -(-k // CODES_PER_TILE)
    part_score = torch.empty((code_tiles, m), dtype=torch.float32,
                             device=z.device)
    part_idx = torch.empty((code_tiles, m), dtype=torch.int32,
                           device=z.device)
    counters = _row_tile_counters(z.device, -(-m // ROWS_PER_TILE))
    idx = torch.empty((m,), dtype=torch.int64, device=z.device)
    rc = _kernel()(flat.data_ptr(), cb.data_ptr(), m, d, k,
                   part_score.data_ptr(), part_idx.data_ptr(),
                   counters.data_ptr(), idx.data_ptr(),
                   _build.stream_handle(z.device))
    _build.check(rc, 'codebook kernel launch')
    launches += 1
    return idx.reshape(z.shape[:-1])
