"""Axial positional embeddings in PyTorch.

Counterpart of ``mmvid_tpu/models/axial.py``.  Parameter names and shapes
follow the reference (``weights_0..weights_{k-1}``, each
``[1, *ones-except-axis, dim]``), so ``dalle.pt`` tensors load unreshaped.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


class AxialPositionalEmbedding(nn.Module):
    """Summed axial embedding over a static shape, cropped to seq len."""

    def __init__(self, dim: int, axial_shape: Sequence[int]):
        super().__init__()
        self.dim = dim
        self.axial_shape = tuple(axial_shape)
        for ind, ax in enumerate(self.axial_shape):
            shape = [1] + [1] * len(self.axial_shape) + [dim]
            shape[1 + ind] = ax
            self.register_parameter(f'weights_{ind}',
                                    nn.Parameter(torch.randn(shape)))

    def embedding(self, t: int) -> torch.Tensor:
        """The first ``t`` positions' embedding, [t, dim]."""
        full = tuple(self.axial_shape) + (self.dim,)
        emb = sum(getattr(self, f'weights_{i}')[0].expand(full)
                  for i in range(len(self.axial_shape)))
        return emb.reshape(math.prod(self.axial_shape), self.dim)[:t]

    def forward(self, x):
        """x [B, T, D] -> positional embedding [B, T, D]."""
        b, t = x.shape[:2]
        return self.embedding(t)[None].expand(b, t, self.dim)


class AxialPositionalEmbeddingList(nn.Module):
    """Per-visual-frame axial embeddings: input [B, num*chunk(+num if SEP),
    D]; each frame chunk gets its own AxialPositionalEmbedding and an
    inserted [SEP] column receives zeros."""

    def __init__(self, dim: int, num: int, axial_shape: Sequence[int]):
        super().__init__()
        self.dim, self.num = dim, num
        self.axial_shape = tuple(axial_shape)
        self.module_list = nn.ModuleList(
            AxialPositionalEmbedding(dim, axial_shape) for _ in range(num))

    def forward(self, emb):
        b = emb.shape[0]
        chunk = math.prod(self.axial_shape)
        has_sep = emb.shape[1] > self.num * chunk
        outs = []
        for c, mod in zip(emb.chunk(self.num, dim=1), self.module_list):
            if has_sep:
                pos = mod(c[:, :-1])
                pos = torch.cat([pos, pos.new_zeros(b, 1, self.dim)], dim=1)
            else:
                pos = mod(c)
            outs.append(pos)
        return torch.cat(outs, dim=1)
