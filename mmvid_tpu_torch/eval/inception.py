"""InceptionV3, the image embedder of the standalone PRD tool.

The port's counterpart of ``mmvid_tpu/eval/inception.py``, which replaces
the reference's frozen TF graph (precision_recall_distributions/
inception.py:12-28, inception_network.py:23-57): the TF-slim InceptionV3
(stem, 3x Inception-A at 35x35, Reduction-A, 4x Inception-B at 17x17,
Reduction-B, 2x Inception-C at 8x8), then the global average pool, the
2048-d "pool_3" embedding.

Every convolution is Conv + BatchNorm (center only, eps 1e-3) + ReLU
(``Unit2D``), as slim's inference graph.  Padding: the stride-2
convolutions and pools are VALID, the SAME ones have stride 1 and odd
kernels, so their padding is symmetric.  The 3x3 SAME average pools count
the padding in their divisor, as flax's ``avg_pool`` does (not TF's,
which does not); the port computes what JAX computes.  NCHW inside;
:meth:`InceptionV3.embed` takes the JAX package's [B, 299, 299, 3] in
[-1, 1].  Module names follow the flax tree's, so
``weights.load_conv_bn_variables`` carries JAX's variables over; TF-slim
checkpoints convert through ``convert_slim_inception``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmvid_tpu_torch.eval.i3d import CenterBatchNorm
from mmvid_tpu_torch.utils.resize import resize_bilinear


class Unit2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel=(1, 1),
                 strides=(1, 1), padding: str = 'SAME'):
        super().__init__()
        kernel = tuple(kernel)
        pad = ((kernel[0] // 2, kernel[1] // 2) if padding == 'SAME'
               else (0, 0))
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, tuple(strides), pad,
                              bias=False)
        self.batch_norm = CenterBatchNorm(out_ch)

    def forward(self, x):
        return F.relu(self.batch_norm(self.conv(x)))


def _avgpool_same(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _maxpool_valid(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.Branch_0_Conv2d_0a_1x1 = Unit2D(in_ch, 64)
        self.Branch_1_Conv2d_0a_1x1 = Unit2D(in_ch, 48)
        self.Branch_1_Conv2d_0b_5x5 = Unit2D(48, 64, (5, 5))
        self.Branch_2_Conv2d_0a_1x1 = Unit2D(in_ch, 64)
        self.Branch_2_Conv2d_0b_3x3 = Unit2D(64, 96, (3, 3))
        self.Branch_2_Conv2d_0c_3x3 = Unit2D(96, 96, (3, 3))
        self.Branch_3_Conv2d_0b_1x1 = Unit2D(in_ch, pool_features)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        b0 = self.Branch_0_Conv2d_0a_1x1(x)
        b1 = self.Branch_1_Conv2d_0b_5x5(self.Branch_1_Conv2d_0a_1x1(x))
        b2 = self.Branch_2_Conv2d_0c_3x3(self.Branch_2_Conv2d_0b_3x3(
            self.Branch_2_Conv2d_0a_1x1(x)))
        b3 = self.Branch_3_Conv2d_0b_1x1(_avgpool_same(x))
        return torch.cat([b0, b1, b2, b3], dim=1)


class ReductionA(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.Branch_0_Conv2d_1a_1x1 = Unit2D(in_ch, 384, (3, 3), (2, 2),
                                             'VALID')
        self.Branch_1_Conv2d_0a_1x1 = Unit2D(in_ch, 64)
        self.Branch_1_Conv2d_0b_3x3 = Unit2D(64, 96, (3, 3))
        self.Branch_1_Conv2d_1a_1x1 = Unit2D(96, 96, (3, 3), (2, 2),
                                             'VALID')
        self.out_channels = 384 + 96 + in_ch

    def forward(self, x):
        b0 = self.Branch_0_Conv2d_1a_1x1(x)
        b1 = self.Branch_1_Conv2d_1a_1x1(self.Branch_1_Conv2d_0b_3x3(
            self.Branch_1_Conv2d_0a_1x1(x)))
        return torch.cat([b0, b1, _maxpool_valid(x)], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.Branch_0_Conv2d_0a_1x1 = Unit2D(in_ch, 192)
        self.Branch_1_Conv2d_0a_1x1 = Unit2D(in_ch, c7)
        self.Branch_1_Conv2d_0b_1x7 = Unit2D(c7, c7, (1, 7))
        self.Branch_1_Conv2d_0c_7x1 = Unit2D(c7, 192, (7, 1))
        self.Branch_2_Conv2d_0a_1x1 = Unit2D(in_ch, c7)
        self.Branch_2_Conv2d_0b_7x1 = Unit2D(c7, c7, (7, 1))
        self.Branch_2_Conv2d_0c_1x7 = Unit2D(c7, c7, (1, 7))
        self.Branch_2_Conv2d_0d_7x1 = Unit2D(c7, c7, (7, 1))
        self.Branch_2_Conv2d_0e_1x7 = Unit2D(c7, 192, (1, 7))
        self.Branch_3_Conv2d_0b_1x1 = Unit2D(in_ch, 192)
        self.out_channels = 4 * 192

    def forward(self, x):
        b0 = self.Branch_0_Conv2d_0a_1x1(x)
        b1 = self.Branch_1_Conv2d_0a_1x1(x)
        b1 = self.Branch_1_Conv2d_0c_7x1(self.Branch_1_Conv2d_0b_1x7(b1))
        b2 = self.Branch_2_Conv2d_0a_1x1(x)
        for name in ('0b_7x1', '0c_1x7', '0d_7x1', '0e_1x7'):
            b2 = getattr(self, f'Branch_2_Conv2d_{name}')(b2)
        b3 = self.Branch_3_Conv2d_0b_1x1(_avgpool_same(x))
        return torch.cat([b0, b1, b2, b3], dim=1)


class ReductionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.Branch_0_Conv2d_0a_1x1 = Unit2D(in_ch, 192)
        self.Branch_0_Conv2d_1a_3x3 = Unit2D(192, 320, (3, 3), (2, 2),
                                             'VALID')
        self.Branch_1_Conv2d_0a_1x1 = Unit2D(in_ch, 192)
        self.Branch_1_Conv2d_0b_1x7 = Unit2D(192, 192, (1, 7))
        self.Branch_1_Conv2d_0c_7x1 = Unit2D(192, 192, (7, 1))
        self.Branch_1_Conv2d_1a_3x3 = Unit2D(192, 192, (3, 3), (2, 2),
                                             'VALID')
        self.out_channels = 320 + 192 + in_ch

    def forward(self, x):
        b0 = self.Branch_0_Conv2d_1a_3x3(self.Branch_0_Conv2d_0a_1x1(x))
        b1 = self.Branch_1_Conv2d_0a_1x1(x)
        for name in ('0b_1x7', '0c_7x1', '1a_3x3'):
            b1 = getattr(self, f'Branch_1_Conv2d_{name}')(b1)
        return torch.cat([b0, b1, _maxpool_valid(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.Branch_0_Conv2d_0a_1x1 = Unit2D(in_ch, 320)
        self.Branch_1_Conv2d_0a_1x1 = Unit2D(in_ch, 384)
        self.Branch_1_Conv2d_0b_1x3 = Unit2D(384, 384, (1, 3))
        self.Branch_1_Conv2d_0c_3x1 = Unit2D(384, 384, (3, 1))
        self.Branch_2_Conv2d_0a_1x1 = Unit2D(in_ch, 448)
        self.Branch_2_Conv2d_0b_3x3 = Unit2D(448, 384, (3, 3))
        self.Branch_2_Conv2d_0c_1x3 = Unit2D(384, 384, (1, 3))
        self.Branch_2_Conv2d_0d_3x1 = Unit2D(384, 384, (3, 1))
        self.Branch_3_Conv2d_0b_1x1 = Unit2D(in_ch, 192)
        self.out_channels = 320 + 768 + 768 + 192

    def forward(self, x):
        b0 = self.Branch_0_Conv2d_0a_1x1(x)
        b1 = self.Branch_1_Conv2d_0a_1x1(x)
        b1 = torch.cat([self.Branch_1_Conv2d_0b_1x3(b1),
                        self.Branch_1_Conv2d_0c_3x1(b1)], dim=1)
        b2 = self.Branch_2_Conv2d_0b_3x3(self.Branch_2_Conv2d_0a_1x1(x))
        b2 = torch.cat([self.Branch_2_Conv2d_0c_1x3(b2),
                        self.Branch_2_Conv2d_0d_3x1(b2)], dim=1)
        b3 = self.Branch_3_Conv2d_0b_1x1(_avgpool_same(x))
        return torch.cat([b0, b1, b2, b3], dim=1)


class InceptionV3(nn.Module):
    """[B, 3, 299, 299] in [-1, 1] -> the pool_3 embedding [B, 2048]."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = Unit2D(3, 32, (3, 3), (2, 2), 'VALID')
        self.Conv2d_2a_3x3 = Unit2D(32, 32, (3, 3), padding='VALID')
        self.Conv2d_2b_3x3 = Unit2D(32, 64, (3, 3))
        self.Conv2d_3b_1x1 = Unit2D(64, 80, padding='VALID')
        self.Conv2d_4a_3x3 = Unit2D(80, 192, (3, 3), padding='VALID')
        blocks = [('Mixed_5b', lambda c: InceptionA(c, 32)),
                  ('Mixed_5c', lambda c: InceptionA(c, 64)),
                  ('Mixed_5d', lambda c: InceptionA(c, 64)),
                  ('Mixed_6a', ReductionA),
                  ('Mixed_6b', lambda c: InceptionB(c, 128)),
                  ('Mixed_6c', lambda c: InceptionB(c, 160)),
                  ('Mixed_6d', lambda c: InceptionB(c, 160)),
                  ('Mixed_6e', lambda c: InceptionB(c, 192)),
                  ('Mixed_7a', ReductionB),
                  ('Mixed_7b', InceptionC),
                  ('Mixed_7c', InceptionC)]
        ch = 192
        self.mixed = [name for name, _ in blocks]
        for name, make in blocks:
            block = make(ch)
            setattr(self, name, block)
            ch = block.out_channels

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _maxpool_valid(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _maxpool_valid(x)
        for name in self.mixed:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))

    def embed(self, images):
        """[B, 299, 299, 3] in [-1, 1] -> [B, 2048] fp32."""
        return self(images.float().permute(0, 3, 1, 2))


def inception_preprocess(images01: torch.Tensor, size: int = 299
                         ) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> [-1, 1] at 299 px, resized as JAX's
    ``jax.image.resize(..., 'bilinear')`` (antialiased when it
    downsamples)."""
    return resize_bilinear(images01, size, size) * 2.0 - 1.0


def convert_slim_inception(var_dict: Dict[str, np.ndarray]
                           ) -> Dict[str, Any]:
    """TF-slim InceptionV3 variables -> JAX's {'params', 'batch_stats'}
    trees, which ``weights.load_conv_bn_variables`` loads.

    Names like ``InceptionV3/Mixed_5b/Branch_0/Conv2d_0a_1x1/weights`` and
    ``.../BatchNorm/{beta,moving_mean,moving_variance}``; kernels
    [kh, kw, in, out] as flax's."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def assign(tree, path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(value)

    for name, w in var_dict.items():
        parts = name.split('/')
        if parts[0] == 'InceptionV3':
            parts = parts[1:]
        if parts[0] in ('Logits', 'AuxLogits'):
            continue
        if parts[0].startswith('Mixed'):
            mod = [parts[0], f'{parts[1]}_{parts[2]}']
            rest = parts[3:]
        else:
            mod = [parts[0]]
            rest = parts[1:]
        if rest[0] == 'weights':
            assign(params, mod + ['conv', 'kernel'], w)
        elif rest[0] == 'BatchNorm':
            if rest[1] == 'beta':
                assign(params, mod + ['batch_norm', 'bias'],
                       np.asarray(w).reshape(-1))
            elif rest[1] == 'moving_mean':
                assign(stats, mod + ['batch_norm', 'mean'],
                       np.asarray(w).reshape(-1))
            elif rest[1] == 'moving_variance':
                assign(stats, mod + ['batch_norm', 'var'],
                       np.asarray(w).reshape(-1))
    return {'params': params, 'batch_stats': stats}


def load_inception_checkpoint(path: str) -> Dict[str, Any]:
    """A TF-slim InceptionV3 checkpoint (an ``.npz`` of its variables, or
    a TF checkpoint, which needs tensorflow) as JAX's trees."""
    if path.endswith('.npz'):
        with np.load(path) as f:
            var_dict = dict(f)
    else:
        import tensorflow.compat.v1 as tf
        reader = tf.train.load_checkpoint(path)
        var_dict = {n: reader.get_tensor(n)
                    for n in reader.get_variable_to_shape_map()}
    return convert_slim_inception(var_dict)
