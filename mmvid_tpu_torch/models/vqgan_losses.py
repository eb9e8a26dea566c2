"""VQGAN finetuning: the PatchGAN discriminator, the losses and the
alternating generator / discriminator steps, in PyTorch.

Counterpart of ``mmvid_tpu/models/vqgan_losses.py`` (taming's
VQLPIPSWithDiscriminator, vqperceptual.py:33-160, and the Lightning
``training_step`` of taming/models/vqgan.py:94-204):

* :class:`NLayerDiscriminator`: Pix2Pix PatchGAN with flax's BatchNorm
  (:class:`BatchNorm`: momentum 0.9 on the running averages, the biased
  batch variance both for the normalisation and for the running update,
  which ``nn.BatchNorm2d`` keeps unbiased); modules carry the flax names
  (``conv_0``, ``conv_1``, ``bn_1`` ..., ``conv_out``; BatchNorm
  ``scale``, ``bias``, ``mean``, ``var``), so JAX's params and batch
  stats load through ``weights.flax_conv_bn_to_torch``.
* :class:`VQGanTrainer`: the generator step (L1 + LPIPS, the hinge GAN
  term on the discriminator's running averages, the adaptive weight
  ||grad nll|| / (||grad g|| + 1e-4) at ``decoder.conv_out.weight``, taken
  with ``torch.autograd.grad`` on the one forward, as taming does, where
  JAX runs the reconstruction again for each gradient), then the
  discriminator step (the generator's fresh reconstruction under
  ``no_grad``, the discriminator in train mode on the real then the fake
  batch, its running stats chained from the first call to the second).
  The GAN factor reads the step count before the discriminator step
  increments it.  Each side has its own Adam (betas (0.5, 0.9), eps 1e-8
  outside the square root, as ``optax.adam``).  Both steps run with TF32
  off, as JAX computes fp32.
* :class:`SegmentationVQModel` and :func:`make_segmentation_train_step`:
  the segmentation VQGAN (taming VQSegmentationModel) with
  :func:`bce_loss_with_quant`.

Images are NCHW in [-1, 1].
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmvid_tpu_torch.factories import init_weights
from mmvid_tpu_torch.models.lpips import LPIPS
from mmvid_tpu_torch.models.vqgan import VQGanConfig, VQModel
from mmvid_tpu_torch.ops.precision import fp32_exact


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the
    channels of NCHW: in train mode the batch mean and the biased variance
    E[x^2] - E[x]^2 (clipped at 0) in fp32 normalise x, and the running
    averages move by ``MOMENTUM * running + (1 - MOMENTUM) * batch``; else
    the running averages normalise."""
    MOMENTUM = 0.9
    EPS = 1e-5

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('mean', torch.zeros(channels))
        self.register_buffer('var', torch.ones(channels))

    def forward(self, x, train: bool):
        if train:
            x32 = x.float()
            mean = x32.mean((0, 2, 3))
            var = ((x32 * x32).mean((0, 2, 3)) - mean * mean).clamp_min(0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.EPS) * self.scale
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator: [B, 3, H, W] -> logits [B, 1, h, w]."""

    def __init__(self, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv_0 = nn.Conv2d(3, ndf, 4, 2, 1)
        cin = ndf
        for n in range(1, n_layers + 1):
            cout = ndf * min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            setattr(self, f'conv_{n}',
                    nn.Conv2d(cin, cout, 4, stride, 1, bias=False))
            setattr(self, f'bn_{n}', BatchNorm(cout))
            cin = cout
        self.conv_out = nn.Conv2d(cin, 1, 4, 1, 1)

    def forward(self, x, train: bool = True):
        x = F.leaky_relu(self.conv_0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            x = getattr(self, f'conv_{n}')(x)
            x = F.leaky_relu(getattr(self, f'bn_{n}')(x, train), 0.2)
        return self.conv_out(x)


@torch.no_grad()
def init_discriminator(disc: NLayerDiscriminator,
                       generator: torch.Generator) -> None:
    """Draw the discriminator's conv kernels N(0, 1/fan_in) from
    ``generator`` (a CPU generator), the rules of
    ``factories.init_weights``; conv biases 0, BatchNorm scale 1, bias 0,
    running mean 0 and variance 1 (flax's init)."""
    for mod in disc.modules():
        if isinstance(mod, nn.Conv2d):
            w = mod.weight
            w.copy_(torch.randn(w.shape, generator=generator)
                    * w[0].numel() ** -0.5)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            for t, v in ((mod.scale, 1.0), (mod.bias, 0.0), (mod.mean, 0.0),
                         (mod.var, 1.0)):
                t.fill_(v)


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real))
                  + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.softplus(-logits_real))
                  + torch.mean(F.softplus(logits_fake)))


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    return value if global_step < threshold else weight


def bce_loss_with_quant(qloss, target, prediction,
                        codebook_weight: float = 1.0):
    """Segmentation VQGAN loss (taming segmentation.py:11-31): BCE of the
    class-map logits + the codebook term."""
    bce = F.binary_cross_entropy_with_logits(prediction, target)
    return bce + codebook_weight * torch.mean(qloss)


@dataclasses.dataclass(frozen=True)
class VQGanLossConfig:
    disc_start: int = 0
    codebook_weight: float = 1.0
    pixelloss_weight: float = 1.0
    disc_num_layers: int = 3
    disc_factor: float = 1.0
    disc_weight: float = 0.8
    perceptual_weight: float = 1.0
    disc_ndf: int = 64
    disc_loss: str = 'hinge'
    learning_rate: float = 4.5e-6


def adam(params, lr: float) -> torch.optim.Adam:
    """taming's ``configure_optimizers``: Adam(lr, betas (0.5, 0.9)), eps
    1e-8 added to the root of the second moment, as ``optax.adam``."""
    return torch.optim.Adam(params, lr=lr, betas=(0.5, 0.9), eps=1e-8)


@contextlib.contextmanager
def _frozen(module: nn.Module):
    """``module``'s parameters take no gradient inside."""
    flags = [p.requires_grad for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(module.parameters(), flags):
            p.requires_grad_(f)


class VQGanTrainer:
    """Alternating generator / discriminator finetuning of a
    :class:`VQModel` on ``device``.  Holds the state: the VQModel
    (``model``), the discriminator (``disc``), their Adams (``g_opt``,
    ``d_opt``) and the count of discriminator steps (``step``).  Weights
    are left to the caller (:meth:`init_weights`, a checkpoint, or
    ``weights.vqgan_train_state_from_jax``)."""

    def __init__(self, cfg: VQGanConfig, loss_cfg: VQGanLossConfig,
                 lpips: Optional[LPIPS] = None, device='cuda'):
        self.cfg, self.lc = cfg, loss_cfg
        self.model = VQModel(cfg).to(device)
        self.disc = NLayerDiscriminator(loss_cfg.disc_ndf,
                                        loss_cfg.disc_num_layers).to(device)
        self.lpips = (lpips or LPIPS()).to(device)
        self.d_loss_fn = (hinge_d_loss if loss_cfg.disc_loss == 'hinge'
                          else vanilla_d_loss)
        self.g_opt = adam(self.model.parameters(), loss_cfg.learning_rate)
        self.d_opt = adam(self.disc.parameters(), loss_cfg.learning_rate)
        self.step = 0

    def init_weights(self, generator: torch.Generator) -> None:
        """The VQModel's weights by ``factories.init_weights``, then the
        discriminator's by :func:`init_discriminator`, from
        ``generator``."""
        init_weights(self.model, generator)
        init_discriminator(self.disc, generator)

    def _nll(self, x, xrec):
        rec = (x - xrec).abs()
        if self.lc.perceptual_weight > 0:
            p = self.lpips(x, xrec)
            return torch.mean(rec.mean((1, 2, 3))
                              + self.lc.perceptual_weight * p)
        return rec.mean()

    def g_step(self, x) -> Dict[str, torch.Tensor]:
        """One generator update on x [B, 3, H, W]; the metrics as 0-d
        tensors on the device (nothing is read back to the host)."""
        lc = self.lc
        with fp32_exact(), _frozen(self.disc):
            xrec, qloss = self.model(x)
            nll = self._nll(x, xrec)
            g_loss = -torch.mean(self.disc(xrec, train=False))
            last = self.model.decoder.conv_out.weight
            nll_g, = torch.autograd.grad(nll, last, retain_graph=True)
            gan_g, = torch.autograd.grad(g_loss, last, retain_graph=True)
            d_weight = (torch.linalg.vector_norm(nll_g) / (
                torch.linalg.vector_norm(gan_g) + 1e-4)).clamp(
                0.0, 1e4).detach() * lc.disc_weight
            disc_factor = adopt_weight(lc.disc_factor, self.step,
                                       lc.disc_start)
            loss = (nll + d_weight * disc_factor * g_loss
                    + lc.codebook_weight * torch.mean(qloss))
            self.g_opt.zero_grad(set_to_none=True)
            loss.backward()
            self.g_opt.step()
        return {'aeloss': loss.detach(), 'nll': nll.detach(),
                'g_loss': g_loss.detach(), 'd_weight': d_weight,
                'qloss': torch.mean(qloss).detach()}

    def d_step(self, x) -> Dict[str, torch.Tensor]:
        """One discriminator update on x and the generator's
        reconstruction of it (by the weights the generator step just
        updated); then the step count moves on."""
        lc = self.lc
        with fp32_exact():
            with torch.no_grad():
                xrec, _ = self.model(x)
            logits_real = self.disc(x, train=True)
            logits_fake = self.disc(xrec, train=True)
            disc_factor = adopt_weight(lc.disc_factor, self.step,
                                       lc.disc_start)
            loss = disc_factor * self.d_loss_fn(logits_real, logits_fake)
            self.d_opt.zero_grad(set_to_none=True)
            loss.backward()
            self.d_opt.step()
        self.step += 1
        return {'discloss': loss.detach(),
                'logits_real': torch.mean(logits_real).detach(),
                'logits_fake': torch.mean(logits_fake).detach()}


class SegmentationVQModel(nn.Module):
    """Segmentation-mask VQGAN (taming VQSegmentationModel,
    vqgan.py:233-297): the VQModel over ``n_labels`` channels in and out,
    trained with :func:`bce_loss_with_quant` and one Adam."""

    def __init__(self, cfg: VQGanConfig, n_labels: int,
                 dtype=torch.float32):
        super().__init__()
        self.model = VQModel(dataclasses.replace(
            cfg, in_channels=n_labels, out_ch=n_labels), dtype)

    def forward(self, x):
        return self.model(x)


def make_segmentation_train_step(module: SegmentationVQModel,
                                 optimizer: torch.optim.Optimizer,
                                 codebook_weight: float = 1.0
                                 ) -> Callable:
    """x_onehot [B, n_labels, H, W] -> metrics; ``optimizer`` updates
    ``module``'s parameters in place."""

    def step(x):
        with fp32_exact():
            xrec, qloss = module(x)
            loss = bce_loss_with_quant(qloss, x, xrec, codebook_weight)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
        return {'loss': loss.detach(), 'qloss': torch.mean(qloss).detach()}

    return step
