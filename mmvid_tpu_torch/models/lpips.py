"""LPIPS perceptual metric (VGG16 variant) in PyTorch.

Counterpart of ``mmvid_tpu/models/lpips.py`` (taming/modules/losses/
lpips.py:11-124): inputs in [-1, 1] scaled by the LPIPS ScalingLayer,
VGG16 feature slices (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3),
features divided by max(||f||, 1e-10) over channels (as the JAX package
does, not taming's ||f|| + eps), the squared differences weighted by the
shipped 1x1 "lin" weights, averaged over space and summed over slices.

The lin weights are read from the JAX package's data file
``mmvid_tpu/data_files/vgg_lpips.pth`` (a data file, not a module).  The
VGG16 weights come from a torchvision ``vgg16`` state_dict
(:func:`vgg16_state_to_port`); without them LPIPS draws random ones from a
seeded generator (:func:`random_vgg16`), as JAX's driver runs without
``--vgg_path``.  NCHW throughout.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

LIN_WEIGHTS = (Path(__file__).resolve().parent.parent.parent / 'mmvid_tpu'
               / 'data_files' / 'vgg_lpips.pth')

# LPIPS ScalingLayer constants (lpips.py:66-76)
_SHIFT = (-.030, -.088, -.188)
_SCALE = (.458, .448, .450)

# VGG16 conv plan: (out_channels, 2x2 max-pool before)
_VGG16 = [(64, False), (64, False),
          (128, True), (128, False),
          (256, True), (256, False), (256, False),
          (512, True), (512, False), (512, False),
          (512, True), (512, False), (512, False)]
_SLICE_ENDS = (2, 4, 7, 10, 13)
CHNS = (64, 128, 256, 512, 512)
# torchvision's indices of the 13 convs in vgg16.features
TORCHVISION_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


class VGG16Features(nn.Module):
    """The 13 3x3 convs of VGG16 (``conv_0`` ... ``conv_12``, JAX's
    names), ReLU after each, a 2x2 max-pool before convs 2, 4, 7 and 10;
    returns the five slices' outputs."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (ch, _) in enumerate(_VGG16):
            setattr(self, f'conv_{i}', nn.Conv2d(cin, ch, 3, padding=1))
            cin = ch

    def forward(self, x) -> List[torch.Tensor]:
        feats = []
        for i, (_, pool) in enumerate(_VGG16):
            if pool:
                x = F.max_pool2d(x, 2)
            x = F.relu(getattr(self, f'conv_{i}')(x))
            if i + 1 in _SLICE_ENDS:
                feats.append(x)
        return feats


def load_lin_weights(path=LIN_WEIGHTS) -> List[torch.Tensor]:
    """The five lin weight vectors [C] of taming's ``vgg.pth``."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    return [sd[f'lin{i}.model.1.weight'].reshape(-1).float()
            for i in range(len(CHNS))]


def vgg16_state_to_port(sd: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """A torchvision ``vgg16`` state_dict (``features.N.weight``) -> the
    state_dict of :class:`VGG16Features` (the counterpart of JAX's
    ``convert_vgg16``)."""
    out = {}
    for i, t in enumerate(TORCHVISION_CONVS):
        for leaf in ('weight', 'bias'):
            out[f'conv_{i}.{leaf}'] = torch.as_tensor(
                sd[f'features.{t}.{leaf}']).float()
    return out


@torch.no_grad()
def random_vgg16(net: VGG16Features, seed: int = 0) -> None:
    """Kernels N(0, 1/fan_in) from a CPU generator at ``seed``, biases 0
    (``factories.init_weights``' rule): the features LPIPS runs on without
    VGG16 weights, as JAX's runs on a PRNGKey(0) init."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in net.named_parameters():
        p.copy_(torch.randn(p.shape, generator=gen) * p[0].numel() ** -0.5
                if name.endswith('weight') else torch.zeros(p.shape))


class LPIPS(nn.Module):
    """``lpips(x, y)``: [B, 3, H, W] images in [-1, 1] -> [B] distances,
    on the VGG16 weights ``vgg_state`` (:class:`VGG16Features`' state_dict)
    or else :func:`random_vgg16`'s.  Its weights are frozen; the gradient
    flows to the inputs."""

    def __init__(self, vgg_state: Dict[str, torch.Tensor] | None = None):
        super().__init__()
        self.net = VGG16Features()
        if vgg_state is None:
            random_vgg16(self.net)
        else:
            self.net.load_state_dict(vgg_state)
        self.register_buffer('shift', torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer('scale', torch.tensor(_SCALE).view(1, 3, 1, 1))
        for i, w in enumerate(load_lin_weights()):
            self.register_buffer(f'lin_{i}', w.view(1, -1, 1, 1))
        self.requires_grad_(False)

    def forward(self, x, y):
        # one VGG pass over both batches
        feats = self.net((torch.cat([x, y]) - self.shift) / self.scale)
        total = 0.0
        for k, f in enumerate(feats):
            f = f / torch.linalg.vector_norm(
                f, dim=1, keepdim=True).clamp_min(1e-10)
            a, b = f.chunk(2)
            d = ((a - b) ** 2 * getattr(self, f'lin_{k}')).sum(1)
            total = total + d.mean((1, 2))
        return total
