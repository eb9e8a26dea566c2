"""int8 self-attention (``MMVID_ATTN_INT8=1``, serving-only): the plain
PyTorch version, the compact form of a two-valued mask, and the wrapper of
the hand-written CUDA kernel (``csrc/attention_int8_sm90.cu``).

Counterpart of the ``int8_qk`` body of
``mmvid_tpu/ops/attention.py::_make_packed_kernel``.  Per (batch, head),
over all L rows, with q already scaled by ``scale`` in q's dtype (as JAX
scales it before its kernel):

    qs = max(max|q|, 1e-8) / 127       ks, vs likewise (fp32)
    q8 = round(q / qs)                 k8, v8 likewise (half to even)
    logits = int32(q8 . k8^T) * (qs * ks) + mask
    p = exp(logits - rowmax),  denom = sum(p)    (fp32)
    p8 = round(p * 127)
    out = int32(p8 . v8) * (vs / 127) / denom, in q's dtype

Every product is an exact integer sum, so the kernel and this version
agree but for exp's last bit, which can move ``p * 127`` across a
rounding tie (one step of p8) or the row sum in its last bits.

Every mask the models build has two values, 0 and ``NEG_INF``
(``models/clip.py::attention_mask``), and is passed down with its compact
form, a :class:`CompactMask` of one bit a key: the kernel reads 32 keys of
a row from one word instead of 32 floats.  ``logit + (bit ? c1 : c0)`` is
the same fp32 add as ``logit + mask``, so the compact form is exact.  A
call without one (any other mask) reads the fp32 mask in the same kernel.

Dispatch, and the checks of the kernel's arguments, are
``ops/attention.py::fused_attention_blhd``'s (it reads this flag before
``MMVID_ATTN_BF16``, as JAX's kernel checks ``int8_qk`` first): a CPU
tensor goes to :func:`attention_int8_reference`; a CUDA tensor launches
the kernel (:func:`launch`) or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import torch
import torch.nn.functional as F

from mmvid_tpu_torch.ops import _build

# Kernel launches since the last reset (read by chip_smoke.py): two a call,
# the operand pass and the attention.
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel keeps a head's int8 K and V in shared memory
MAX_L = 1024
_fn = None


def enabled() -> bool:
    """``MMVID_ATTN_INT8=1``: the int8 variant (read at every call)."""
    return os.environ.get('MMVID_ATTN_INT8') == '1'


def mask_words(length: int) -> int:
    """32-bit words of a compact mask row: whole 16-byte pieces, so that a
    block's rows are one bulk copy."""
    return 4 * -(-length // 128)


def pack_bits(flags: torch.Tensor) -> torch.Tensor:
    """bool [L, L] -> int32 [L, mask_words(L)], bit j % 32 of word j // 32
    of row i set where flags[i, j]; on flags' device, no host sync."""
    n = flags.shape[0]
    w = mask_words(n)
    f = F.pad(flags.to(torch.int64), (0, 32 * w - n)).view(n, w, 32)
    words = (f << torch.arange(32, device=flags.device)).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


@dataclasses.dataclass(frozen=True)
class CompactMask:
    """A two-valued additive [L, L] mask as bits: mask[i, j] is ``c1``
    where bit j of row i is set, else ``c0`` (``pack_bits``' layout)."""
    bits: torch.Tensor
    c0: float
    c1: float

    def dense(self) -> torch.Tensor:
        """The fp32 [L, L] mask it stands for."""
        n = self.bits.shape[0]
        shifts = torch.arange(32, device=self.bits.device)
        on = ((self.bits.long()[..., None] >> shifts) & 1).view(n, -1)[:, :n]
        return torch.where(on.bool(), self.c1, self.c0).float()

    def sliced(self, length: int) -> 'CompactMask':
        """The compact form of ``mask[:length, :length]``."""
        if length == self.bits.shape[0]:
            return self
        return CompactMask(
            self.bits[:length, :mask_words(length)].contiguous(), self.c0,
            self.c1)


def compact_mask(mask: torch.Tensor) -> CompactMask:
    """The compact form of an additive [L, L] mask with at most two values
    (c0 the larger); raises on a third.  Reads the values on the host:
    the models build theirs from the rule instead
    (``models/clip.py::attention_mask``)."""
    values = torch.unique(mask)
    if values.numel() > 2:
        raise ValueError(f'a compact mask holds two values, not '
                         f'{values.numel()}')
    c0, c1 = float(values.max()), float(values.min())
    return CompactMask(pack_bits((mask == c1) & (mask != c0)), c0, c1)


def _quantize(x):
    """Per-(batch, head) abs-max int8 grid of x [B, L, H, D] fp32 ->
    (int-valued fp64 x8, fp32 scale [B, 1, H, 1])."""
    s = torch.clamp_min(x.abs().amax(dim=(1, 3), keepdim=True), 1e-8) / 127.0
    return torch.round(x / s).double(), s


def attention_int8_reference(q, k, v, mask, scale):
    """q, k, v [B, L, H, D]; additive fp32 mask [L, L] -> [B, L, H, D] in
    q's dtype: the module docstring's function.  The integer products run
    in fp64, exact at every size the kernel takes."""
    qp = (q * torch.tensor(scale, dtype=q.dtype)).float()
    q8, qs = _quantize(qp)
    k8, ks = _quantize(k.float())
    v8, vs = _quantize(v.float())
    qk = (qs * ks).permute(0, 2, 1, 3)                        # [B, H, 1, 1]
    acc = torch.einsum('blhd,bmhd->bhlm', q8, k8).float()
    logits = acc * qk + mask[None, None]
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True).permute(0, 2, 1, 3)       # [B, L, H, 1]
    p8 = torch.round(p * 127.0).double()
    pv = torch.einsum('bhlm,bmhd->blhd', p8, v8).float()
    return (pv * (vs / 127.0) / denom).to(q.dtype)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library().mmvid_attention_int8_fwd
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_float]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def workspace_bytes(b: int, l: int, h: int) -> int:
    """The operand pass's output: a head's int8 Q, K and V^T, each 64
    bytes a row over L rounded up to 64 rows, and its three scales."""
    return b * h * (3 * 64 * (-(-l // 64) * 64) + 16)


def launch(q, k, v, mask, scale, compact=None):
    """The kernel on CUDA tensors that ``ops/attention.py``'s
    ``fused_attention_blhd`` has checked: q, k, v [B, L, H, D] (strided
    views allowed), mask [L, L] fp32 and, where the caller has it, its
    :class:`CompactMask` -> [B, L, H, D] contiguous in q's dtype."""
    global launches
    b, l, h, d = q.shape
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    work = torch.empty((workspace_bytes(b, l, h),), dtype=torch.uint8,
                       device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    # q is scaled in its own dtype, as JAX scales it: the kernel takes the
    # scale rounded to that dtype and rounds each product to it
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    if compact is not None:
        bits = compact.bits
        if (bits.device != q.device or bits.dtype != torch.int32
                or bits.shape != (l, mask_words(l))
                or not bits.is_contiguous()):
            raise ValueError(f'compact mask bits must be contiguous int32 '
                             f'[{l}, {mask_words(l)}] on {q.device}')
        bits_ptr, c0, c1 = bits.data_ptr(), compact.c0, compact.c1
    else:
        bits_ptr, c0, c1 = None, 0.0, 0.0
    rc = _kernel()(_DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), mask.data_ptr(), bits_ptr,
                   mask_words(l), c0, c1, work.data_ptr(), out.data_ptr(), b,
                   l, h, strides, scale_q, _build.stream_handle(q.device))
    _build.check(rc, 'int8 attention kernel launch')
    launches += 2
    return out
