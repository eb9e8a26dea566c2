"""Fused LayerNorm + packed QKV projection: the plain PyTorch version and
the wrapper of the hand-written CUDA kernel (``csrc/fused_ln_qkv_sm90.cu``:
a statistics pass, then the product on Hopper's tensor cores with the
normalisation of each x slab in shared memory).

Counterpart of ``mmvid_tpu/ops/fused_ln_qkv.py``.  Per row of x:

    mu, var = mean(x), mean(x^2) - mu^2          (fp32, eps 1e-5)
    h       = ((x - mu) * rsqrt(var + eps) * ln_w + ln_b) in fp32, then
              rounded to x's dtype
    qkv     = h @ W^T + b   W the packed in_proj_weight [3D, D]; products
              summed in fp32, b added in fp32, then x's dtype

``models/clip.py`` takes this path when ``MMVID_FUSED_LNQKV=1`` and the
width is a multiple of 128, as the JAX package does; it is off by default.

Dispatch rule of :func:`fused_ln_qkv`: a CPU tensor goes to
:func:`ln_qkv_reference`; a CUDA tensor launches the kernel or raises.  The
kernel takes bf16, the dtype of the full-width models the gate serves;
fp32 on the card raises (fp32 runs the plain version on the CPU).  The
kernel has no backward (nor has JAX's): on the card a call with grad
enabled and an input that requires grad raises (serving only); the CPU's
plain version keeps autograd.
"""

from __future__ import annotations

import ctypes

import torch

from mmvid_tpu_torch.ops import _build
from mmvid_tpu_torch.ops.attention import refuse_grad

# Kernel launches since the last reset (read by chip_smoke.py).
launches = 0

# the kernel stages ln_w and ln_b in shared memory
MAX_D = 1024
_fn = None


def ln_qkv_reference(x, ln_w, ln_b, w, b):
    """x [..., D]; ln_w, ln_b [D]; w [3D, D]; b [3D] -> [..., 3D] in x's
    dtype (the math of mmvid_tpu/ops/fused_ln_qkv.py::_kernel)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.square().mean(-1, keepdim=True) - mu.square()
    h = (x32 - mu) * torch.rsqrt(var + 1e-5)
    h = (h * ln_w.float() + ln_b.float()).to(x.dtype)
    return (h.float() @ w.float().t() + b.float()).to(x.dtype)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library().mmvid_ln_qkv
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_cuda_args(x, ln_w, ln_b, w, b):
    d = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise ValueError(f'the LN+QKV kernel takes bf16, not {x.dtype}')
    if d % 128 or d > MAX_D:
        raise ValueError(f'D={d} must be a multiple of 128, at most '
                         f'{MAX_D}')
    for name, t, shape, dtype in (('ln_w', ln_w, (d,), torch.float32),
                                  ('ln_b', ln_b, (d,), torch.float32),
                                  ('w', w, (3 * d, d), x.dtype),
                                  ('b', b, (3 * d,), x.dtype)):
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f'{name} must be {dtype} {shape}, got '
                             f'{t.dtype} {tuple(t.shape)}')
    for name, t in (('x', x), ('ln_w', ln_w), ('ln_b', ln_b), ('w', w),
                    ('b', b)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous on {x.device}')
        if t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')


def fused_ln_qkv(x, ln_w, ln_b, w, b):
    """x [..., D] (on the card bf16 with D a multiple of 128, the model's
    gate, up to MAX_D; on the CPU fp32 or bf16); ln_w, ln_b [D] fp32; w [3D, D] and
    b [3D] in x's dtype -> packed qkv [..., 3D] in x's dtype."""
    global launches
    if x.device.type == 'cpu':
        return ln_qkv_reference(x, ln_w, ln_b, w, b)
    if x.device.type != 'cuda':
        raise ValueError(f'no LN+QKV path for device {x.device}')
    refuse_grad('fused LN+QKV', x, ln_w, ln_b, w, b)
    _check_cuda_args(x, ln_w, ln_b, w, b)
    d = x.shape[-1]
    m = x.numel() // d
    out = torch.empty(x.shape[:-1] + (3 * d,), dtype=x.dtype,
                      device=x.device)
    # per-row (mean, rstd) scratch of the kernel's statistics pass
    stats = torch.empty((m, 2), dtype=torch.float32, device=x.device)
    rc = _kernel()(x.data_ptr(), ln_w.data_ptr(),
                   ln_b.data_ptr(), w.data_ptr(), b.data_ptr(), m, d,
                   stats.data_ptr(), out.data_ptr(),
                   _build.stream_handle(x.device))
    _build.check(rc, 'LN+QKV kernel launch')
    launches += 1
    return out
