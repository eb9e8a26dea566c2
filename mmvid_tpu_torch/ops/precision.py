"""Full fp32 precision on the card: the one context that turns TF32 off.

The JAX package computes in fp32.  PyTorch lets cuDNN's fp32 convolutions
run in TF32 by default, and cuBLAS's products when asked to, which would
move the port's results away from JAX's (and, where integer-valued fp32
tensors are multiplied, as in ART-V's int8 attention, make sums inexact).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for cuDNN's convolutions and cuBLAS's products inside
    (cuDNN allows it by default), the flags restored after."""
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
