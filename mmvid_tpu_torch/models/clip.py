"""CLIP-architecture transformer backbone in PyTorch.

Counterpart of ``mmvid_tpu/models/clip.py`` (sequential stack only).
Modules and parameters carry the reference ``dalle.pt`` names
(``resblocks.{i}.attn.in_proj_weight``, ``ln_1``, ``mlp.c_fc`` ...), so a
reference state_dict loads unchanged.

Precision: the stack casts x to the compute dtype on entry and back to fp32
on exit; every LayerNorm is an fp32 island whose output is cast back to the
compute dtype.  Attention goes through
:func:`mmvid_tpu_torch.ops.attention.fused_attention_blhd` (the CUDA kernel
on the card, the plain version on the CPU).  With ``MMVID_FUSED_LNQKV=1``
and a width that is a multiple of 128, ``ln_1`` and the QKV projection go
through :func:`mmvid_tpu_torch.ops.fused_ln_qkv.fused_ln_qkv` instead (the
flag is read at every block's forward; off by default).

w8a8 int8 serving (``ops/int8.py``): ``ClipStackConfig.int8_scales`` holds
per layer the static input scales (qkv_in, out_in, fc_in, proj_in), and
with them the four projections of each block run through
``quantized_dense`` (the packed in_proj with the shared qkv_in scale: its
per-output-channel weight scales make that JAX's three separate q/k/v
quantizations).  The same four sites record their inputs inside
``ops.int8.recording()``, under ``blocks_{i}/attn/qkv_in`` ...  Both
bypass the fused LN+QKV gate, as in the JAX package; a quantized stack
refuses to run with grad enabled (rounding has no gradient).

Parameter and compute dtypes: the modules make their parameters in
``param_dtype`` (the compute dtype unless given) and cast each weight to
the compute dtype where it is used, so a training build holds fp32
parameters and computes in bf16, as flax's ``nn.Dense(dtype=bf16)`` with
its default fp32 ``param_dtype`` does; a serving build (both dtypes the
same) casts nothing.  ``ClipStackConfig.remat`` checkpoints each block
under grad (``torch.utils.checkpoint``, non-reentrant), JAX's
``nn.remat``: the block's forward, the attention kernel included, runs
again in the backward.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mmvid_tpu_torch.ops import int8
from mmvid_tpu_torch.ops.attention import (
    AttentionMask,
    fused_attention_blhd,
    slice_mask,
)
from mmvid_tpu_torch.ops.attention_int8 import CompactMask, pack_bits
from mmvid_tpu_torch.ops.fused_ln_qkv import fused_ln_qkv

NEG_INF = -1e9  # finite stand-in for -inf: keeps softmax NaN-free in bf16


@dataclasses.dataclass(frozen=True)
class ClipStackConfig:
    width: int = 768
    layers: int = 12
    heads: int = 12
    remat: bool = False       # checkpoint each block (training memory)
    # w8a8 serving: per layer (qkv_in, out_in, fc_in, proj_in) activation
    # scales from ops.int8 calibration; None = the unquantized path
    int8_scales: Optional[tuple] = None

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


def build_attention_mask(context_length: int, mask_type: str = 'causal',
                         index: Optional[Sequence[int]] = None,
                         device=None) -> torch.Tensor:
    """Additive fp32 [L, L] mask.

    ``causal``: token i attends to keys <= i.
    ``mask_prev``: bidirectional except rows in ``index`` (the [ST1] and
    [VID] estimation tokens), which cannot see keys before their own
    position.
    """
    if mask_type == 'causal':
        mask = torch.full((context_length, context_length), NEG_INF,
                          dtype=torch.float32, device=device).triu(1)
    elif mask_type == 'mask_prev':
        mask = torch.zeros((context_length, context_length),
                           dtype=torch.float32, device=device)
        for i in index or ():
            mask[i, :i] = NEG_INF
    else:
        raise NotImplementedError(mask_type)
    return mask


@functools.lru_cache(maxsize=64)
def attention_mask(context_length: int, mask_type: str = 'causal',
                   index: Optional[tuple] = None,
                   length: Optional[int] = None,
                   pad_to: Optional[int] = None,
                   device=None) -> AttentionMask:
    """``build_attention_mask(context_length, ...)[:length, :length]``,
    padded with ``NEG_INF`` rows and keys up to ``pad_to`` (the JAX
    package's padded layout), with its compact form; made once per
    arguments and kept.  Every value is 0 or ``NEG_INF`` by construction,
    so the bits are the ``NEG_INF`` entries, packed on the device."""
    dense = build_attention_mask(context_length, mask_type, index, device)
    n = context_length if length is None else length
    dense = dense[:n, :n]
    if pad_to is not None and pad_to > n:
        dense = F.pad(dense, (0, pad_to - n, 0, pad_to - n), value=NEG_INF)
    dense = dense.contiguous()
    return AttentionMask(dense, CompactMask(pack_bits(dense == NEG_INF), 0.0,
                                            NEG_INF))


def layer_norm_fp32(ln: nn.LayerNorm, x, dtype):
    """fp32 LayerNorm island: statistics and affine in fp32, output cast to
    ``dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(dtype)


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class Mlp(nn.Module):
    def __init__(self, width: int, dtype=torch.float32):
        """``dtype``: the parameters' dtype; the compute dtype is the
        input's."""
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width, dtype=dtype)
        self.gelu = QuickGELU()
        self.c_proj = nn.Linear(4 * width, width, dtype=dtype)
        # int8 weights of a serving copy (ops.int8.freeze_weights), else
        # quantized at every int8 call
        self.w8 = {}

    def freeze_int8(self):
        self.w8 = {n: int8.quantize_weight(getattr(self, n).weight)
                   for n in ('c_fc', 'c_proj')}

    def forward(self, x, scales=None, site=''):
        """``scales``: (fc_in, proj_in) for the int8 path, else None."""
        int8.record(f'{site}/mlp/fc_in', x)
        h = _linear(self.c_fc, x, None if scales is None else scales[0],
                    self.w8.get('c_fc'))
        h = self.gelu(h)
        int8.record(f'{site}/mlp/proj_in', h)
        return _linear(self.c_proj, h, None if scales is None else scales[1],
                       self.w8.get('c_proj'))


def linear(layer: nn.Linear, x):
    """``layer(x)`` with the weight and bias cast to x's dtype (the compute
    dtype) at use; no cast where the parameters are in it already."""
    return _dense(x, layer.weight, layer.bias)


def _dense(x, w, b):
    return F.linear(x, *_cast(x.dtype, w, b))


def _cast(dtype, w, b):
    """(w, b) in ``dtype``; a serving build's are in it already (the
    check is cheaper on the host than a no-op cast)."""
    if w.dtype == dtype:
        return w, b
    return w.to(dtype), b.to(dtype)


def _linear(layer: nn.Linear, x, a_scale, w8=None):
    if a_scale is None:
        return linear(layer, x)
    return int8.quantized_dense(x, layer.weight, layer.bias, a_scale, w8)


class MultiHeadAttention(nn.Module):
    """Self-attention with torch ``nn.MultiheadAttention``'s parameter
    layout: one packed ``in_proj_weight`` [3D, D] and ``out_proj``."""

    def __init__(self, width: int, heads: int, dtype=torch.float32):
        """``dtype``: the parameters' dtype; the compute dtype is the
        input's."""
        super().__init__()
        self.width, self.heads = width, heads
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * width, width, dtype=dtype))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width, dtype=dtype))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = nn.Linear(width, width, dtype=dtype)
        # int8 weights of a serving copy, as in Mlp
        self.w8 = {}

    def freeze_int8(self):
        self.w8 = {'in_proj': int8.quantize_weight(self.in_proj_weight),
                   'out_proj': int8.quantize_weight(self.out_proj.weight)}

    def forward(self, x, mask=None, scales=None, site=''):
        """``scales``: (qkv_in, out_in) for the int8 path, else None."""
        int8.record(f'{site}/attn/qkv_in', x)
        if scales is None:
            qkv = _dense(x, self.in_proj_weight, self.in_proj_bias)
        else:
            qkv = int8.quantized_dense(x, self.in_proj_weight,
                                       self.in_proj_bias, scales[0],
                                       self.w8.get('in_proj'))
        return self.attend(qkv, mask, scales, site)

    def attend(self, qkv, mask=None, scales=None, site=''):
        """Attention and out_proj from the packed projection qkv
        [B, L, 3D]."""
        b, l, d3 = qkv.shape
        d = d3 // 3
        h, hd = self.heads, d // self.heads
        # q, k, v stay strided views of the packed projection: the kernel
        # takes their strides, so no copy is made
        q, k, v = (qkv[..., i * d:(i + 1) * d].view(b, l, h, hd)
                   for i in range(3))
        out = fused_attention_blhd(q, k, v, slice_mask(mask, l)).reshape(
            b, l, d)
        int8.record(f'{site}/attn/out_in', out)
        return _linear(self.out_proj, out,
                       None if scales is None else scales[1],
                       self.w8.get('out_proj'))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32,
                 param_dtype=None):
        super().__init__()
        self.dtype = dtype
        param_dtype = param_dtype or dtype
        self.attn = MultiHeadAttention(width, heads, dtype=param_dtype)
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = Mlp(width, dtype=param_dtype)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)

    def forward(self, x, mask=None, scales=None, site=''):
        """``scales``: the block's (qkv_in, out_in, fc_in, proj_in) for the
        int8 path, else None; ``site``: its calibration path prefix."""
        if (os.environ.get('MMVID_FUSED_LNQKV') == '1'
                and self.attn.width % 128 == 0 and scales is None
                and not int8.is_recording()):
            # ln_1 and the QKV projection in one kernel (the JAX package's
            # gate, mmvid_tpu/models/clip.py ResidualAttentionBlock; the
            # int8 path and calibration go through the separate sites)
            qkv = fused_ln_qkv(x, self.ln_1.weight, self.ln_1.bias,
                               *_cast(self.dtype, self.attn.in_proj_weight,
                                      self.attn.in_proj_bias))
            x = x + self.attn.attend(qkv, mask)
        else:
            x = x + self.attn(layer_norm_fp32(self.ln_1, x, self.dtype),
                              mask, None if scales is None else scales[:2],
                              site)
        return x + self.mlp(layer_norm_fp32(self.ln_2, x, self.dtype),
                            None if scales is None else scales[2:], site)


class TransformerStack(nn.Module):
    """The resblock stack of the MMVID backbone; every block gets the same
    additive [L, L] mask (a tensor, or an ``AttentionMask`` with its
    compact form)."""

    def __init__(self, cfg: ClipStackConfig, dtype=torch.float32,
                 param_dtype=None):
        """``dtype``: the compute dtype; ``param_dtype``: the parameters'
        (``dtype`` unless given)."""
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(cfg.width, cfg.heads, dtype=dtype,
                                   param_dtype=param_dtype)
            for _ in range(cfg.layers))

    def forward(self, x, mask=None):
        i8 = self.cfg.int8_scales
        if i8 is not None and self.cfg.remat:
            raise RuntimeError(
                'the int8 path is serving-only (rounding has no gradient): '
                'disable remat or int8_scales')
        if i8 is not None and torch.is_grad_enabled():
            raise RuntimeError(
                'the int8 path is serving-only (rounding has no gradient): '
                'run the quantized stack under torch.no_grad()')
        remat = self.cfg.remat and torch.is_grad_enabled()
        x = x.to(self.dtype)
        for i, block in enumerate(self.resblocks):
            if remat:
                x = checkpoint(block, x, mask, use_reentrant=False)
            else:
                x = block(x, mask, i8[i] if i8 else None, f'blocks_{i}')
        return x.float()


def load_openai_clip_stack(model_path: str,
                           which_model: str = 'openai_clip_visual'):
    """(ClipStackConfig, the stack's state_dict) of ``ViT-B-32.pt``'s
    visual or text resblocks (clip_model.py:535-543), read from the
    torch.jit archive; the state_dict loads into a
    :class:`TransformerStack` of that config as it is."""
    from mmvid_tpu_torch.utils.torch_compat import (
        clip_resblocks,
        clip_stack_dims,
        load_torchjit_state_dict,
    )
    sd = load_torchjit_state_dict(model_path)
    prefix = ('visual.transformer' if which_model == 'openai_clip_visual'
              else 'transformer')
    width, layers, heads = clip_stack_dims(sd, prefix)
    return (ClipStackConfig(width=width, layers=layers, heads=heads),
            clip_resblocks(sd, prefix))
