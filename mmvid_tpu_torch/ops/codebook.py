"""Nearest codebook entry (the VQ encoder's lookup): the plain PyTorch
version and the wrapper of the hand-written CUDA kernel
(``csrc/codebook.cu``).

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

_SMEM_LIMIT = 227 * 1024
_fn = None


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
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_cuda_args(flat, cb):
    d = flat.shape[1]
    if cb.dim() != 2 or cb.shape[1] != d:
        raise ValueError(f'codebook must be [K, D={d}], got '
                         f'{tuple(cb.shape)}')
    if cb.device != flat.device:
        raise ValueError(f'codebook on {cb.device}, z on {flat.device}')
    if d % 4:
        raise ValueError(f'D={d} must be a multiple of 4')
    if 4 * (8 * d + 64 * (d + 4) + 64) > _SMEM_LIMIT:
        raise ValueError(f'D={d} exceeds the shared-memory tiles')
    for name, t in (('z', flat), ('codebook', cb)):
        if t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')


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
    m, d = flat.shape
    idx = torch.empty((m,), dtype=torch.int64, device=z.device)
    rc = _kernel()(flat.data_ptr(), cb.data_ptr(), m, d, cb.shape[0],
                   idx.data_ptr(), _build.stream_handle(z.device))
    _build.check(rc, 'codebook kernel launch')
    launches += 1
    return idx.reshape(z.shape[:-1])
