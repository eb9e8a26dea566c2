"""I3D (Inflated 3D Inception-v1, kinetics-400), the FVD embedding network.

The port's counterpart of ``mmvid_tpu/eval/i3d.py``, which replaces the
reference's frozen TF1 graph from tfhub.dev/deepmind/i3d-kinetics-400/1
(frechet_video_distance.py:64-122).  The FVD endpoint is
``RGB/inception_i3d/Mean:0``: the logits pooled over space and averaged
over time, 400 numbers a video.

Architecture (DeepMind kinetics-i3d): Unit3D = Conv3d (no bias) +
BatchNorm (center only, eps 1e-3, running statistics) + ReLU; the
GoogLeNet channel plan; TF ``SAME`` padding everywhere.  TF pads the end
of a dimension more where the total padding is odd (the stride-2
convolutions and pools), and its max-pools pad with -inf; so each
convolution and pool pads its input explicitly where the two ends differ.
The module takes NCDHW, PyTorch's layout; :meth:`I3D.embed` takes the
JAX package's [B, T, 224, 224, 3] in [-1, 1].  Module and parameter names
follow the flax tree's (``Mixed_3b.Branch_1_Conv3d_0b_3x3.conv_3d``, BN
``bias`` and the ``mean`` / ``var`` buffers), so
``weights.flax_conv_bn_to_torch`` carries JAX's variables over.

The convolutions are XLA convolutions in JAX, so cuDNN's (``F.conv3d``)
are their port.  Eval runs them in fp32 with TF32 off, as JAX runs eval
in fp32 (:func:`mmvid_tpu_torch.ops.precision.fp32_exact`).

Weights: ``convert_tfhub_i3d`` turns a TF-Hub checkpoint's variables into
JAX's trees, ``load_i3d_checkpoint`` reads a ``.npz`` of them (a TF
checkpoint through tensorflow, imported only then).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (b0_1x1, b1_1x1, b1_3x3, b2_1x1, b2_3x3, b3_1x1) per Mixed block
_INCEPTION_PLAN = {
    'Mixed_3b': (64, 96, 128, 16, 32, 32),
    'Mixed_3c': (128, 128, 192, 32, 96, 64),
    'Mixed_4b': (192, 96, 208, 16, 48, 64),
    'Mixed_4c': (160, 112, 224, 24, 64, 64),
    'Mixed_4d': (128, 128, 256, 24, 64, 64),
    'Mixed_4e': (112, 144, 288, 32, 64, 64),
    'Mixed_4f': (256, 160, 320, 32, 128, 128),
    'Mixed_5b': (256, 160, 320, 32, 128, 128),
    'Mixed_5c': (384, 192, 384, 48, 128, 128),
}


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF ``SAME`` padding (begin, end) of one dimension."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x, kernel, strides, value=0.0):
    """(x padded where TF pads the two ends unequally, the symmetric
    padding left to the op) over the trailing ``len(kernel)`` dims."""
    n = len(kernel)
    pads = [same_pads(x.shape[-n + i], kernel[i], strides[i])
            for i in range(n)]
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    flat = []
    for lo, hi in reversed(pads):   # F.pad: the last dim first
        flat += [lo, hi]
    return F.pad(x, flat, value=value), (0,) * n


class CenterBatchNorm(nn.Module):
    """BatchNorm at inference with a shift and no scale (TF's
    ``scale=False``): (x - mean) / sqrt(var + eps) + bias over dim 1."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('mean', torch.zeros(channels))
        self.register_buffer('var', torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.mean, self.var, None, self.bias,
                            False, 0.0, self.eps)


class Unit3D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel=(1, 1, 1),
                 strides=(1, 1, 1), use_bn: bool = True,
                 activation: bool = True, use_bias: bool = False):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.activation = activation
        self.conv_3d = nn.Conv3d(in_ch, out_ch, self.kernel, self.strides,
                                 bias=use_bias)
        self.batch_norm = CenterBatchNorm(out_ch) if use_bn else None

    def forward(self, x):
        x, pad = pad_same(x, self.kernel, self.strides)
        x = F.conv3d(x, self.conv_3d.weight, self.conv_3d.bias,
                     self.strides, pad)
        if self.batch_norm is not None:
            x = self.batch_norm(x)
        return F.relu(x) if self.activation else x


def max_pool_same(x, window, strides):
    x, pad = pad_same(x, window, strides, value=float('-inf'))
    return F.max_pool3d(x, window, strides, pad)


class InceptionBlock(nn.Module):
    def __init__(self, in_ch: int, plan):
        super().__init__()
        b0, b1a, b1b, b2a, b2b, b3 = plan
        self.out_channels = b0 + b1b + b2b + b3
        self.Branch_0_Conv3d_0a_1x1 = Unit3D(in_ch, b0)
        self.Branch_1_Conv3d_0a_1x1 = Unit3D(in_ch, b1a)
        self.Branch_1_Conv3d_0b_3x3 = Unit3D(b1a, b1b, (3, 3, 3))
        self.Branch_2_Conv3d_0a_1x1 = Unit3D(in_ch, b2a)
        self.Branch_2_Conv3d_0b_3x3 = Unit3D(b2a, b2b, (3, 3, 3))
        self.Branch_3_Conv3d_0b_1x1 = Unit3D(in_ch, b3)

    def forward(self, x):
        br0 = self.Branch_0_Conv3d_0a_1x1(x)
        br1 = self.Branch_1_Conv3d_0b_3x3(self.Branch_1_Conv3d_0a_1x1(x))
        br2 = self.Branch_2_Conv3d_0b_3x3(self.Branch_2_Conv3d_0a_1x1(x))
        br3 = self.Branch_3_Conv3d_0b_1x1(
            max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([br0, br1, br2, br3], dim=1)


class I3D(nn.Module):
    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        ch = 192
        for name, plan in _INCEPTION_PLAN.items():
            block = InceptionBlock(ch, plan)
            setattr(self, name, block)
            ch = block.out_channels
        self.Logits_Conv3d_0c_1x1 = Unit3D(ch, num_classes, use_bn=False,
                                           activation=False, use_bias=True)

    def forward(self, x):
        """x [B, 3, T, 224, 224] in [-1, 1] -> logits [B, num_classes]."""
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))     # MaxPool3d_2a_3x3
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))     # MaxPool3d_3a_3x3
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))     # MaxPool3d_4a_3x3
        for name in ('Mixed_4b', 'Mixed_4c', 'Mixed_4d', 'Mixed_4e',
                     'Mixed_4f'):
            x = getattr(self, name)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))     # MaxPool3d_5a_2x2
        x = self.Mixed_5c(self.Mixed_5b(x))
        # the Logits endpoint: avg-pool (2, 7, 7) VALID, the 1x1x1 conv
        # with bias, spatial squeezed, the mean over time ('Mean:0')
        x = F.avg_pool3d(x, (2, 7, 7), (1, 1, 1))
        x = self.Logits_Conv3d_0c_1x1(x)
        return x.squeeze(4).squeeze(3).mean(dim=2)

    def embed(self, videos):
        """videos [B, T, 224, 224, 3] in [-1, 1] -> [B, 400] fp32, the FVD
        activations."""
        return self(videos.float().permute(0, 4, 1, 2, 3))


@torch.no_grad()
def init_random(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator`` (a CPU generator), for pipeline
    runs only: convolutions N(0, 2 / fan_in), biases 0, the BatchNorms'
    identity statistics."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv3d, nn.Conv2d)):
            w = mod.weight
            w.copy_(torch.randn(w.shape, generator=generator)
                    * (2.0 / w[0].numel()) ** 0.5)
            if mod.bias is not None:
                mod.bias.zero_()


# ---------------------------------------------------------------------------
# TF-Hub weight conversion (numpy; the JAX package's trees)
# ---------------------------------------------------------------------------

def convert_tfhub_i3d(var_dict: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """TF-Hub i3d-kinetics-400 variables -> JAX's {'params',
    'batch_stats'} trees (``mmvid_tpu/eval/i3d.py``), which
    ``weights.load_i3d_variables`` loads into :class:`I3D`.

    ``var_dict`` maps names like
    ``RGB/inception_i3d/Mixed_3b/Branch_0/Conv3d_0a_1x1/conv_3d/w`` (and
    ``batch_norm/{beta,moving_mean,moving_variance}``) to arrays; TF conv3d
    kernels are [kd, kh, kw, in, out], as flax's."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def assign(tree, path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(value)

    for name, w in var_dict.items():
        parts = name.split('/')
        if parts[0] == 'RGB':
            parts = parts[1:]
        if parts[0] == 'inception_i3d':
            parts = parts[1:]
        if parts[0].startswith('Mixed'):
            mod = [parts[0], f'{parts[1]}_{parts[2]}']
            rest = parts[3:]
        elif parts[0] == 'Logits':
            mod = [f'Logits_{parts[1]}']
            rest = parts[2:]
        else:
            mod = [parts[0]]
            rest = parts[1:]
        if rest[0] == 'conv_3d':
            leaf = {'w': 'kernel', 'b': 'bias'}[rest[1]]
            assign(params, mod + ['conv_3d', leaf], w)
        elif rest[0] == 'batch_norm':
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


def load_i3d_checkpoint(path: str) -> Dict[str, Any]:
    """A saved TF-Hub I3D checkpoint (an ``.npz`` of its variables, or a
    TF checkpoint, which needs tensorflow) as JAX's trees."""
    if path.endswith('.npz'):
        with np.load(path) as f:
            var_dict = dict(f)
    else:
        import tensorflow.compat.v1 as tf
        reader = tf.train.load_checkpoint(path)
        var_dict = {n: reader.get_tensor(n)
                    for n in reader.get_variable_to_shape_map()}
    return convert_tfhub_i3d(var_dict)
