"""The grid-step probe: the plain PyTorch version and the wrapper of the
hand-written CUDA kernels (``csrc/gridstep.cu``).

Counterpart of ``scripts/probe_gridstep.py``, whose Pallas kernel measures
what one step of a sequential (12, 16) grid costs on the TPU.  One probe
call is 12 chained layers

    x <- x + (bf16(x) @ W[l, 0]) * 1e-3      x [16, 768] fp32, W bf16

and a measurement times 64 chained calls.  The port computes a call with
1, 12 or 192 launches (one persistent kernel; one a layer; one a TPU grid
step, the idle ones returning at once), so the differences between the
three times are the cost of a launch on the card.  ``chip_smoke.py``
reports it beside the ART-V decode step, which runs as one persistent
launch a token, a grid barrier between its 60 phases.

Dispatch rule of :func:`probe_call`: a CPU tensor goes to
:func:`probe_call_reference`; a CUDA tensor launches the kernels or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from mmvid_tpu_torch.ops import _build

# Kernel launches since the last reset, ``launches_per_call`` per probe
# call (read by chip_smoke.py).
launches = 0

LAYERS, PHASES, CALLS = 12, 16, 64
BATCH, DIM = 16, 768
STEP = 1e-3
LAUNCHES_PER_CALL = (1, LAYERS, LAYERS * PHASES)
_fn = None
_barriers = {}


def probe_inputs(generator, device=None):
    """The probe's x [16, 768] fp32 and W [12, 3, 768, 768] bf16 (the
    ``[in, out]`` blocks of its three phases) from ``generator``."""
    w = torch.randn((LAYERS, 3, DIM, DIM), generator=generator,
                    device=device) * 0.02
    x = torch.randn((BATCH, DIM), generator=generator, device=device)
    return x, w.bfloat16()


def prepare_weights(w):
    """[L, 3, D, D] probe weights -> [L, D, D] ``[out, in]`` copies of the
    blocks the probe computes with (W[l, 0]), once before timing."""
    return w[:, 0].transpose(1, 2).contiguous()


def probe_call_reference(x, wt):
    """One probe call: x [B, D] fp32, wt [L, D, D] bf16 from
    :func:`prepare_weights` -> x after the L chained layers."""
    for layer in wt:
        x = x + (x.to(layer.dtype).float() @ layer.float().t()) * STEP
    return x


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library().mmvid_gridstep
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_cuda_args(x, wt, launches_per_call):
    b, d = x.shape
    if x.dtype != torch.float32 or wt.dtype != torch.bfloat16:
        raise ValueError(f'x must be fp32 and W bf16, got {x.dtype}, '
                         f'{wt.dtype}')
    if wt.dim() != 3 or wt.shape[1:] != (d, d):
        raise ValueError(f'W must be [L, {d}, {d}], got {tuple(wt.shape)}')
    if not 1 <= b <= 64 or d % 32:
        raise ValueError(f'x [{b}, {d}]: B in [1, 64], D a multiple of 32')
    layers = wt.shape[0]
    if launches_per_call != 1 and launches_per_call % layers:
        raise ValueError(f'{launches_per_call} launches for {layers} '
                         f'layers')
    for name, t in (('x', x), ('W', wt)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous on {x.device}')
        if t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')


def probe_call(x, wt, launches_per_call: int = 1):
    """One probe call (see :func:`probe_call_reference`), computed on the
    card with ``launches_per_call`` kernel launches (1, L or a multiple of
    L)."""
    global launches
    if x.device.type == 'cpu':
        return probe_call_reference(x, wt)
    if x.device.type != 'cuda':
        raise ValueError(f'no probe path for device {x.device}')
    _check_cuda_args(x, wt, launches_per_call)
    b, d = x.shape
    out = torch.empty_like(x)
    scratch = torch.empty((2, b, d), dtype=torch.float32, device=x.device)
    if x.device not in _barriers:   # the persistent kernel's grid barrier
        _barriers[x.device] = torch.zeros(2, dtype=torch.int32,
                                          device=x.device)
    rc = _kernel()(x.data_ptr(), wt.data_ptr(), out.data_ptr(),
                   scratch.data_ptr(), _barriers[x.device].data_ptr(), b, d,
                   wt.shape[0], launches_per_call,
                   _build.stream_handle(x.device))
    _build.check(rc, 'grid-step probe launch')
    launches += launches_per_call
    return out


def probe(x, wt, launches_per_call: int = 1, calls: int = CALLS):
    """``calls`` chained probe calls (the measurement's unit)."""
    for _ in range(calls):
        x = probe_call(x, wt, launches_per_call)
    return x
