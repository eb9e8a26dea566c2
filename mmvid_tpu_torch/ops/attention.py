"""Full-sequence self-attention: the plain PyTorch version and the wrapper
of the hand-written CUDA kernels (``csrc/attention.cu``'s entries: bf16 on
the tensor cores in ``csrc/attention_sm90.cu``, fp32 on the CUDA cores in
``csrc/attention_fp32_sm90.cu``; their backward on the tensor cores in
``csrc/attention_bwd_sm90.cu`` and, in split TF32,
``csrc/attention_bwd_fp32_sm90.cu``).

Counterpart of ``mmvid_tpu/ops/attention.py``.  Both versions compute
``softmax(q * scale @ k^T + mask) @ v`` per (batch, head) with fp32 logits,
softmax and accumulation, in the residual stream's ``[B, L, H, D]`` layout.
``MMVID_ATTN_BF16=1``, read at every call as the JAX package reads it,
selects JAX's bf16-probability variant: the unnormalised probabilities are
rounded to bf16 before the product with V, the row sums stay fp32.

``MMVID_ATTN_INT8=1`` (read at every call, and checked first, as JAX's
kernel checks ``int8_qk`` before ``bf16_av``) selects JAX's int8 variant,
``ops/attention_int8.py``.  Its kernel reads a mask's compact form where
the caller passes an :class:`AttentionMask` (the models build theirs so).

Dispatch rule of :func:`fused_attention_blhd`: a CPU tensor goes to
:func:`attention_reference`; a CUDA tensor launches the kernel or raises.

Gradients: with grad enabled and an input that requires grad, the call
goes through :class:`FusedAttention`, the counterpart of JAX's
``custom_vjp`` (``_fused_attention_fwd`` / ``_fused_attention_bwd``).  On
the CPU its forward is the plain version, it saves only q, k, v and the
mask, and its backward, :func:`attention_backward`, recomputes the fp32
logits and softmax from them with torch ops, as JAX's backward is the XLA
VJP of ``_attention_xla``.  On the card its forward is the kernel, which
also writes each row's log-sum-exp ([B, H, L] fp32) and, for bf16, the
rest of its fp32 output (bf16, [B, L, H, D]); it saves those and its
output beside q, k, v and the mask (no [B, H, L, L] tensor), and its
backward is the backward kernels of ``csrc/attention.cu``'s
``mmvid_attention_bwd`` (:func:`attention_backward_kernel`: bf16 on the
tensor cores in ``csrc/attention_bwd_sm90.cu``, fp32 on the tensor cores
in split TF32 in ``csrc/attention_bwd_fp32_sm90.cu``), or raises; the
fp32 kernel reads the mask's compact form where the caller passed an
:class:`AttentionMask`.  The mask takes no gradient.  The quantized
variants refuse grad: the int8 one is serving
only (C1), and ``MMVID_ATTN_BF16=1`` rounds the probabilities that the
backward's fp32 softmax does not, so its gradients would not be the
forward's.
JAX refuses both flags in training only under ``MMVID_PALLAS_ATTN=1``,
the only place it reads them; the port's card path always runs the
kernel, so it refuses them whenever grad is on, on either device.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from mmvid_tpu_torch.ops import _build, attention_int8

# Kernel launches since the last reset (chip_smoke.py reads it to show the
# main path ran through the kernel).
launches = 0
# FusedAttention backward calls since the last reset, on either device
# (breakdown.measure_train reads them a training step)
backward_calls = 0
# Launches of the backward kernels since the last reset: one a backward
# call on the card (bf16: the query pass and the key pass; fp32: delta,
# the key pass, dq)
backward_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
# the fp32 kernel's entry at a given tile (csrc/attention_fp32_sm90.cu's
# mmvid_attention_fp32_at)
_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
# mmvid_attention_fwd's (csrc/attention.cu): the same with the backward's
# statistics (lse, out_lo and lse's row stride) after out
_FWD_ARGTYPES = (_ARGTYPES[:8] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                 + _ARGTYPES[8:])
# mmvid_attention_bwd's
_BWD_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3
                 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
# the row statistics' row stride is L rounded up to a whole key tile
_STAT_TILE = 64
# the fp32 backward's key pass writes dq's partials, one [B, H, L, D] a
# block of this many keys (bwd::kKeyBlock, csrc/attention_bwd.cuh)
_FP32_BWD_KEY_BLOCK = 128
_fn = None
_bwd_fn = None


class AttentionMask(NamedTuple):
    """An additive fp32 [L, L] mask of two values with its compact form
    (``attention_int8.CompactMask``, which the int8 kernel reads)."""
    dense: torch.Tensor
    compact: attention_int8.CompactMask

    def sliced(self, length: int) -> 'AttentionMask':
        """The mask of the first ``length`` rows and keys."""
        if length == self.dense.shape[0]:
            return self
        return AttentionMask(self.dense[:length, :length].contiguous(),
                             self.compact.sliced(length))


def slice_mask(mask, length: int):
    """``mask[:length, :length]`` (contiguous) of a dense mask, an
    :class:`AttentionMask` or None."""
    if isinstance(mask, AttentionMask):
        return mask.sliced(length)
    return None if mask is None else mask[:length, :length].contiguous()


def bf16_probs() -> bool:
    """``MMVID_ATTN_BF16=1``: the bf16-probability variant."""
    return os.environ.get('MMVID_ATTN_BF16') == '1'


def attention_reference(q, k, v, mask, scale, bf16_probs=False):
    """q, k, v [B, L, H, D]; mask additive fp32 [L, L] -> [B, L, H, D] in
    q's dtype (``_attention_xla``'s math, mmvid_tpu/ops/attention.py).
    ``bf16_probs``: the TPU kernel's ``bf16_av`` variant, exp(logits - max)
    rounded to bf16 for the product with V, divided by the fp32 row sum
    after it."""
    logits = torch.einsum('blhd,bmhd->bhlm', q.float() * scale, k.float())
    logits = logits + mask[None, None]
    if not bf16_probs:
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum('bhlm,bmhd->blhd', p, v.float())
        return out.to(q.dtype)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True).permute(0, 2, 1, 3)   # [B, L, H, 1]
    out = torch.einsum('bhlm,bmhd->blhd', p.bfloat16().float(), v.float())
    return (out / denom).to(q.dtype)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library().mmvid_attention_fwd
        fn.argtypes = _FWD_ARGTYPES
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.library().mmvid_attention_bwd
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def fp32_tile_rows(b: int, l: int, h: int) -> int:
    """Rows a thread of the fp32 kernel's query tile (the tile is 16 x
    that) that the route takes for ``b`` x ``h`` heads of ``l`` queries on
    the current card."""
    fn = _build.library().mmvid_attention_fp32_rows
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    rows = fn(b, l, h)
    if rows < 0:
        raise RuntimeError('fp32 attention: the card\'s SM count not read')
    return rows


def fp32_kernel_at(rows: int, q, k, v, mask, bf16_probs: bool = False):
    """The fp32 kernel at the query tile of ``rows`` rows a thread (8, 6
    or 4), with :func:`fused_attention_blhd`'s checks, for the card
    tests and the attribution script: not the route, and no launch is
    counted."""
    _check_cuda_args(q, k, v, mask)
    if q.dtype != torch.float32:
        raise ValueError('fp32_kernel_at takes fp32 q, k, v')
    b, l, h, d = q.shape
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = _build.library().mmvid_attention_fp32_at
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    rc = fn(rows, d, int(bf16_probs), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), mask.data_ptr(), out.data_ptr(), b, l, h, strides,
            float(d ** -0.5), _build.stream_handle(q.device))
    _build.check(rc, f'fp32 attention kernel launch at {rows} rows')
    return out


def _check_cuda_args(q, k, v, mask, int8=False):
    """What the bf16/fp32 kernels, or with ``int8`` the int8 kernel, take;
    anything else raises before a launch."""
    b, l, h, d = q.shape
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f'{name}: {t.device}/{t.dtype}, expected '
                             f'{q.device}/{q.dtype}')
        if t.shape != q.shape:
            raise ValueError(f'{name} shape {tuple(t.shape)} != '
                             f'{tuple(q.shape)}')
        if t.stride(-1) != 1:
            raise ValueError(f'{name} needs unit stride over the head dim')
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f'attention kernel takes fp32 or bf16, not '
                         f'{q.dtype}')
    if d not in _HEAD_DIMS:
        raise ValueError(f'attention kernel takes head dims {_HEAD_DIMS}, '
                         f'not {d}')
    if (mask.device != q.device or mask.dtype != torch.float32
            or mask.shape != (l, l) or not mask.is_contiguous()):
        raise ValueError('mask must be a contiguous fp32 [L, L] tensor on '
                         "q's device")
    if int8 and l > attention_int8.MAX_L:
        raise ValueError(f'the int8 kernel holds a head in shared memory: '
                         f'L <= {attention_int8.MAX_L}, not {l}')
    # the bf16 and fp32 kernels copy 16-byte chunks of rows and of the
    # mask (8 bf16 or 4 fp32 elements); the int8 kernel loads 8 elements
    # at a time in either dtype
    if not int8 and mask.data_ptr() % 16:
        raise ValueError('mask: the attention kernel needs a 16-byte '
                         'aligned base')
    chunk = 8 if q.dtype == torch.bfloat16 or int8 else 4
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.data_ptr() % 16 or any(st % chunk for st in t.stride()[:3]):
            raise ValueError(f'{name}: the kernel needs a 16-byte aligned '
                             'base and batch, row and head strides that '
                             f'are multiples of {chunk}')


def refuse_grad(what: str, *tensors) -> None:
    """C1: a kernel that writes through ctypes gives its output no
    autograd graph, so a call with grad enabled and an input that
    requires grad raises instead of dropping the gradient."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f'{what}: the kernel path is for serving only (it has no '
            'backward); call it under torch.no_grad()')


def needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def attention_backward(q, k, v, mask, scale, g):
    """(dq, dk, dv) in q's dtype: the VJP of :func:`attention_reference`
    (``_attention_xla``) at the cotangent ``g`` [B, L, H, D], with the fp32
    logits and softmax recomputed from q, k, v and the mask (JAX's
    ``_fused_attention_bwd``).  The [B, H, L, L] probabilities live only
    inside this call."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    logits = torch.einsum('blhd,bmhd->bhlm', qf * scale, kf)
    p = torch.softmax(logits + mask[None, None], dim=-1)
    dv = torch.einsum('bhlm,blhd->bmhd', p, gf)
    dp = torch.einsum('blhd,bmhd->bhlm', gf, vf)
    # softmax's VJP: p * (dp - sum_m p * dp)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.einsum('bhlm,bmhd->blhd', ds, kf) * scale
    dk = torch.einsum('bhlm,blhd->bmhd', ds, qf * scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def stats_stride(l: int) -> int:
    """The row stride of the kernels' [B, H, stride] row statistics: L
    rounded up to a whole 64-key tile, so that the backward's key pass
    reads a tile's statistics whole."""
    return -(-l // _STAT_TILE) * _STAT_TILE


def _fits_kernel(t, chunk: int) -> bool:
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % chunk == 0 for st in t.stride()[:3]))


def attention_backward_kernel(q, k, v, mask, scale, g, out, lse,
                              out_lo=None, compact=None):
    """(dq, dk, dv) in q's dtype, contiguous [B, L, H, D]: the backward
    kernels (``mmvid_attention_bwd``; bf16: a query pass writes each row's
    delta = g . O and dq, a key pass dk and dv; fp32: delta, then one key
    pass writes dk, dv and dq's partials a block of 128 keys, then dq their
    ordered sum) on CUDA tensors, from the forward kernel's output
    ``out``, row statistics ``lse`` ([B, H, stats_stride(L)] fp32, base 2)
    and, for bf16, ``out_lo``, the rest of its fp32 output (O = out +
    out_lo).  ``compact``: the mask's ``attention_int8.CompactMask``, which
    the fp32 kernel reads instead of the fp32 mask (the bf16 kernel reads
    the fp32 mask: faster there).  The function of
    :func:`attention_backward`, which is its plain version.  Raises on
    what the kernels do not take, before any launch."""
    global backward_launches
    _check_cuda_args(q, k, v, mask)
    b, l, h, d = q.shape
    chunk = 8 if q.dtype == torch.bfloat16 else 4
    # autograd may hand a cotangent of any strides (an expanded zero, say)
    if g.dtype != q.dtype or g.shape != q.shape or g.device != q.device:
        raise ValueError(f'cotangent {g.device}/{g.dtype}/{tuple(g.shape)} '
                         f'does not match q')
    if not _fits_kernel(g, chunk):
        g = g.contiguous()
    ld = stats_stride(l)
    if (out.dtype != q.dtype or out.shape != q.shape
            or not _fits_kernel(out, chunk)):
        raise ValueError('out: the forward kernel\'s output, [B, L, H, D] '
                         "in q's dtype")
    if (lse.dtype != torch.float32 or lse.shape != (b, h, ld)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f'lse: fp32 [B, H, {ld}] on q\'s device')
    bf16 = q.dtype == torch.bfloat16
    if bf16 != (out_lo is not None) or (bf16 and (
            out_lo.dtype != q.dtype or out_lo.stride() != out.stride()
            or out_lo.shape != out.shape or not _fits_kernel(out_lo, 8))):
        raise ValueError("out_lo: bf16 q's forward rest, in out's layout; "
                         'none for fp32')
    bits = None if compact is None or bf16 else compact.bits
    if bits is not None and (
            bits.dtype != torch.int32 or not bits.is_contiguous()
            or bits.shape != (l, attention_int8.mask_words(l))
            or bits.device != q.device or bits.data_ptr() % 16):
        raise ValueError(f'compact mask: int32 [L, '
                         f'{attention_int8.mask_words(l)}] on q\'s device, '
                         'contiguous and 16-byte aligned')
    dq, dk, dv = (torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = torch.empty_like(lse)
    scratch = None if bf16 else torch.empty(
        -(-l // _FP32_BWD_KEY_BLOCK) * b * h * l * d, dtype=torch.float32,
        device=q.device)
    ts = (q, k, v, out, g, dq, dk, dv)
    ptrs = (ctypes.c_void_p * 9)(*(t.data_ptr() for t in ts),
                                 out_lo.data_ptr() if bf16 else None)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in ts for s in t.stride()[:3]))
    rc = _bwd_kernel()(
        _DTYPE_CODES[q.dtype], d, ptrs, mask.data_ptr(),
        None if bits is None else bits.data_ptr(),
        0 if bits is None else bits.shape[1],
        0.0 if bits is None else compact.c0,
        0.0 if bits is None else compact.c1, lse.data_ptr(),
        delta.data_ptr(), None if bf16 else scratch.data_ptr(), b, l, h, ld,
        strides, float(scale), _build.stream_handle(q.device))
    _build.check(rc, 'attention backward kernel launch')
    backward_launches += 1
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """:func:`fused_attention_blhd` with a backward: on the CPU the plain
    forward and :func:`attention_backward`; on the card the forward kernel
    (with the row statistics) and :func:`attention_backward_kernel`, given
    the mask's compact form where the caller had one."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, compact=None):
        ctx.scale = scale
        ctx.compact = compact
        if q.device.type == 'cuda':
            out, lse, out_lo = _launch(q, k, v, mask, scale, False,
                                       with_lse=True)
            ctx.save_for_backward(q, k, v, mask, out, lse, out_lo)
            return out
        ctx.save_for_backward(q, k, v, mask)
        return _dispatch(q, k, v, mask, scale, None, False, False)

    @staticmethod
    def backward(ctx, g):
        global backward_calls
        backward_calls += 1
        saved = ctx.saved_tensors
        if g.device.type == 'cuda':
            grads = attention_backward_kernel(*saved[:4], ctx.scale, g,
                                              *saved[4:], ctx.compact)
        else:
            grads = attention_backward(*saved, ctx.scale, g)
        return (*grads, None, None, None)


def fused_attention_blhd(q, k, v, mask=None):
    """q, k, v [B, L, H, D] (any strides with a unit head-dim stride);
    additive mask [L, L], an :class:`AttentionMask` or None -> [B, L, H,
    D] contiguous, q's dtype.
    Logits are scaled by D ** -0.5; ``MMVID_ATTN_INT8=1`` takes the int8
    variant, else ``MMVID_ATTN_BF16=1`` the bf16-probability variant.
    With grad enabled and an input that requires grad, the result carries
    :class:`FusedAttention`'s backward (the variants raise there)."""
    b, l, h, d = q.shape
    scale = d ** -0.5
    compact = None
    if isinstance(mask, AttentionMask):
        mask, compact = mask
    if mask is None:
        mask = torch.zeros((l, l), dtype=torch.float32, device=q.device)
    int8 = attention_int8.enabled()
    bf16_p = bf16_probs()
    if needs_grad(q, k, v, mask):
        if int8:
            refuse_grad('int8 attention', q, k, v, mask)
        if bf16_p:
            raise RuntimeError(
                'MMVID_ATTN_BF16=1 is serving only: its forward rounds the '
                'probabilities, which the fp32 recompute of the backward '
                'does not; unset it to train')
        return FusedAttention.apply(q, k, v, mask, scale, compact)
    return _dispatch(q, k, v, mask, scale, compact, int8, bf16_p)


def _dispatch(q, k, v, mask, scale, compact, int8, bf16_p):
    if q.device.type == 'cpu':
        if int8:
            return attention_int8.attention_int8_reference(q, k, v, mask,
                                                           scale)
        return attention_reference(q, k, v, mask, scale, bf16_p)
    if q.device.type != 'cuda':
        raise ValueError(f'no {"int8 " if int8 else ""}attention path for '
                         f'device {q.device}')
    if int8:
        _check_cuda_args(q, k, v, mask, int8)
        return attention_int8.launch(q, k, v, mask, scale, compact)
    return _launch(q, k, v, mask, scale, bf16_p)


def _launch(q, k, v, mask, scale, bf16_p, with_lse=False):
    """The forward kernel on CUDA tensors; with ``with_lse`` (out, lse,
    out_lo): also each row's log-sum-exp in base 2, [B, H,
    stats_stride(L)] fp32, and for bf16 the rest of the fp32 output,
    bf16(O - out), in out's layout (None for fp32): the backward's row
    statistics and the O of its delta."""
    global launches
    _check_cuda_args(q, k, v, mask)
    b, l, h, d = q.shape
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, stats_stride(l)), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    out_lo = (torch.empty_like(out) if with_lse and q.dtype == torch.bfloat16
              else None)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    rc = _kernel()(_DTYPE_CODES[q.dtype], d, int(bf16_p), q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                   out.data_ptr(), None if lse is None else lse.data_ptr(),
                   None if out_lo is None else out_lo.data_ptr(),
                   0 if lse is None else lse.shape[-1], b, l, h, strides,
                   float(scale), _build.stream_handle(q.device))
    _build.check(rc, 'attention kernel launch')
    launches += 1
    return (out, lse, out_lo) if with_lse else out
