"""Fused LN -> to_logits -> Gumbel sampling head: the plain PyTorch version
and the wrapper of the hand-written CUDA kernel (``csrc/sample_head.cu``).

Counterpart of ``mmvid_tpu/ops/sample_head.py``.  Per row of x [M, D]:

    h      = LN(x) rounded to W's dtype;  logits = h @ W + b  (fp32 sums)
    noised = logits + temp * G1;          tok = argmax(noised + G2)
    Y      = exp(noised[tok] - logsumexp(noised))

Dispatch rule of :func:`fused_sample_head`: a CPU tensor draws G1 and G2
from the caller's generator and goes to :func:`sample_head_reference`; a
CUDA tensor draws one seed from the generator (on the device, no host
sync) and launches the kernel, which makes its noise with Philox, or
raises.  The kernel's bits cannot match any other generator's, so the
kernel is held against the plain version in distribution, and exactly at
temp = 0 for Y given the chosen token.
"""

from __future__ import annotations

import ctypes

import torch

from mmvid_tpu_torch.ops import _build

# Kernel launches since the last reset (read by chip_smoke.py).
launches = 0

_W_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def gumbel(shape, generator, device=None, eps: float = 1e-20):
    """Gumbel(0, 1) noise from ``generator`` (``_gumbel`` of
    mmvid_tpu/models/sampler.py: u ~ U[eps, 1), -log(-log(u) + eps))."""
    u = torch.rand(shape, generator=generator, device=device)
    u = eps + (1.0 - eps) * u
    return -torch.log(-torch.log(u) + eps)


def head_logits(x, ln_w, ln_b, w, b):
    """LN(x) rounded to w's dtype, @ w + b, summed in fp32 -> [M, V]."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    h = (x - mu) * torch.rsqrt(var + 1e-5) * ln_w.float() + ln_b.float()
    return h.to(w.dtype).float() @ w.float() + b.float()


def sample_head_reference(x, ln_w, ln_b, w, b, temp, g1, g2):
    """x [M, D] fp32; ln_w, ln_b [D]; w [D, V]; b [V]; g1, g2 [M, V] noise.
    Returns (Y [M] fp32, tok [M] int64)."""
    noised = head_logits(x, ln_w, ln_b, w, b) + temp * g1
    tok = torch.argmax(noised + g2, dim=-1)
    lse = torch.logsumexp(noised, dim=-1)
    chosen = torch.gather(noised, -1, tok[:, None])[:, 0]
    return torch.exp(chosen - lse), tok


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library().mmvid_sample_head
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_float, ctypes.c_void_p]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_cuda_args(x, ln_w, ln_b, w, b):
    m, d = x.shape
    if w.dim() != 2 or w.shape[0] != d:
        raise ValueError(f'w must be [D={d}, V], got {tuple(w.shape)}')
    v = w.shape[1]
    if x.dtype != torch.float32:
        raise ValueError(f'x must be fp32, got {x.dtype}')
    if w.dtype not in _W_DTYPE_CODES:
        raise ValueError(f'w must be fp32 or bf16, got {w.dtype}')
    if d % 4:
        raise ValueError(f'D={d} must be a multiple of 4')
    if 16 * (d + v) * 4 > 227 * 1024:
        raise ValueError(f'D + V = {d + v} exceeds the shared-memory tile')
    for name, t, shape in (('ln_w', ln_w, (d,)), ('ln_b', ln_b, (d,)),
                           ('b', b, (v,))):
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f'{name} must be fp32 {shape}, got '
                             f'{t.dtype} {tuple(t.shape)}')
    for name, t in (('x', x), ('ln_w', ln_w), ('ln_b', ln_b), ('w', w),
                    ('b', b)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous on {x.device}')


def fused_sample_head(x, ln_w, ln_b, w, b, temp: float, generator):
    """x [M, D] hidden rows (fp32); LN params [D]; w [D, V]; b [V];
    temp a float; generator a torch.Generator on x's device.
    Returns (Y [M] fp32, tok [M] int64)."""
    global launches
    m = x.shape[0]
    v = w.shape[1]
    if x.device.type == 'cpu':
        g1 = gumbel((m, v), generator)
        g2 = gumbel((m, v), generator)
        return sample_head_reference(x, ln_w, ln_b, w, b, temp, g1, g2)
    if x.device.type != 'cuda':
        raise ValueError(f'no sample-head path for device {x.device}')
    _check_cuda_args(x, ln_w, ln_b, w, b)
    seed = torch.randint(0, 2 ** 62, (1,), generator=generator,
                         device=x.device, dtype=torch.int64)
    y = torch.empty((m,), dtype=torch.float32, device=x.device)
    tok = torch.empty((m,), dtype=torch.int64, device=x.device)
    rc = _kernel()(_W_DTYPE_CODES[w.dtype], x.data_ptr(), ln_w.data_ptr(),
                   ln_b.data_ptr(), w.data_ptr(), b.data_ptr(), float(temp),
                   seed.data_ptr(), m, x.shape[1], v, y.data_ptr(),
                   tok.data_ptr(), _build.stream_handle(x.device))
    _build.check(rc, 'sample-head kernel launch')
    launches += 1
    return y, tok
