"""VQGAN image tokenizer (taming-transformers VQModel) in PyTorch.

Counterpart of ``mmvid_tpu/models/vqgan.py``:

* encode: [0, 1] images -> [-1, 1] -> Encoder -> 1x1 quant_conv -> fp32
  latents -> nearest codebook entry (``ops/codebook.py``) -> ids;
* decode: ids -> codebook lookup -> 1x1 post_quant_conv -> Decoder ->
  [0, 1] images;
* training (``models/vqgan_losses.py``): ``VQModel.forward`` through
  ``VectorQuantizer.forward`` (the nearest code, the straight-through
  estimator and the codebook loss), and :class:`GumbelQuantize`.

Modules carry taming's state_dict names (``encoder.down.{i}.block.{j}``,
``encoder.down.{i}.downsample.conv``, ``decoder.up.{i}.block.{j}``,
``quantize.embedding.weight``, ``quant_conv`` ...).

Layouts: images [B, H, W, 3] and ids [B, n] at the public methods, as in
the JAX package; NCHW inside.  GroupNorm(32, eps 1e-6) and SiLU run in fp32
whatever the compute dtype; convolutions run in the compute dtype.

w8a8 int8 serving of the decoder (``ops/int8.py``): every conv that the
JAX package's ``_conv`` covers in the decoder (``conv_in``, ``conv_out``,
the resnet blocks' ``conv1``/``conv2``/``nin_shortcut``, the attention
blocks' ``q``/``k``/``v``/``proj_out``, the upsample ``conv``) is a
:class:`SiteConv` named by its JAX path (``decoder/up_4_block_0/conv1``);
it records its input inside ``ops.int8.recording()`` and, given a scale in
``VQGanConfig.int8_scales`` (sorted (path, scale) pairs), runs
``quantized_conv``.  The encoder and ``Downsample`` are never quantized.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mmvid_tpu_torch.ops import int8
from mmvid_tpu_torch.ops.codebook import nearest_codebook_indices


@dataclasses.dataclass(frozen=True)
class VQGanConfig:
    """vqgan.1024.config.yml defaults."""
    embed_dim: int = 256
    n_embed: int = 1024
    double_z: bool = False
    z_channels: int = 256
    resolution: int = 256
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: Sequence[int] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Sequence[int] = (16,)
    dropout: float = 0.0
    # decoder int8 serving: sorted (JAX conv path, activation scale) pairs
    # from ops.int8.quantize_vae_decoder; None = the unquantized path
    int8_scales: Any = None

    @property
    def num_layers(self) -> int:
        return len(self.ch_mult) - 1

    def fmap_size(self, image_size: int) -> int:
        return image_size // (2 ** self.num_layers)


def _norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-6)


def _norm_silu(norm: nn.GroupNorm, x, dtype):
    """fp32 GroupNorm + SiLU island, output cast to ``dtype``."""
    h = F.group_norm(x.float(), norm.num_groups, norm.weight.float(),
                     norm.bias.float(), norm.eps)
    return F.silu(h).to(dtype)


class SiteConv(nn.Conv2d):
    """A stride-1 SAME conv that can be an int8 site: with a ``site`` (its
    JAX path) it records its input when calibrating, and with an
    ``a_scale`` it runs ``quantized_conv``, on ``w8``, its weight quantized
    once in a serving copy (``ops.int8.freeze_weights``), or else on its
    weight quantized at every call."""
    site: str | None = None
    a_scale: float | None = None
    w8: tuple | None = None

    def freeze_int8(self):
        self.w8 = (int8.quantize_weight(self.weight)
                   if self.a_scale is not None else None)

    def forward(self, x):
        if self.site is not None:
            int8.record(self.site, x)
        if self.a_scale is None:
            return super().forward(x)
        return int8.quantized_conv(x, self.weight, self.bias, self.a_scale,
                                   self.w8)


def _conv(cin: int, cout: int, k: int, dtype) -> SiteConv:
    return SiteConv(cin, cout, k, padding=k // 2, dtype=dtype)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = _norm(in_channels)
        self.conv1 = _conv(in_channels, out_channels, 3, dtype)
        self.norm2 = _norm(out_channels)
        self.conv2 = _conv(out_channels, out_channels, 3, dtype)
        if in_channels != out_channels:
            self.nin_shortcut = _conv(in_channels, out_channels, 1, dtype)

    def forward(self, x):
        h = self.conv1(_norm_silu(self.norm1, x, self.dtype))
        h = self.conv2(_norm_silu(self.norm2, h, self.dtype))
        if hasattr(self, 'nin_shortcut'):
            x = self.nin_shortcut(x.to(self.dtype))
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = _norm(channels)
        self.q = _conv(channels, channels, 1, dtype)
        self.k = _conv(channels, channels, 1, dtype)
        self.v = _conv(channels, channels, 1, dtype)
        self.proj_out = _conv(channels, channels, 1, dtype)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = F.group_norm(x.float(), self.norm.num_groups,
                         self.norm.weight.float(), self.norm.bias.float(),
                         self.norm.eps).to(self.dtype)
        # products of compute-dtype values summed in fp32
        q = self.q(h).reshape(b, c, hh * ww).float()
        k = self.k(h).reshape(b, c, hh * ww).float()
        v = self.v(h).reshape(b, c, hh * ww).float()
        attn = torch.bmm(q.transpose(1, 2), k) * (c ** -0.5)   # [b, i, j]
        attn = torch.softmax(attn, dim=-1).to(self.dtype).float()
        out = torch.bmm(v, attn.transpose(1, 2))               # [b, c, i]
        out = out.reshape(b, c, hh, ww).to(self.dtype)
        return x + self.proj_out(out)


class Upsample(nn.Module):
    """Nearest x2 + conv."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = _conv(channels, channels, 3, dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode='nearest'))


class Downsample(nn.Module):
    """Asymmetric (0, 1, 0, 1) padding, then a VALID stride-2 3x3 conv."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0,
                              dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _Mid(nn.Module):
    def __init__(self, ch: int, dtype):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch, dtype)
        self.attn_1 = AttnBlock(ch, dtype)
        self.block_2 = ResnetBlock(ch, ch, dtype)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class _Level(nn.Module):
    """One resolution of the encoder (``down.{i}``) or decoder
    (``up.{i}``): resnet blocks, their attention blocks, and the
    resampler.  The callers loop over its blocks inline: a call that
    takes h would keep the level's input alive through the level (one
    more full-resolution activation at the decode's peak)."""

    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class Encoder(nn.Module):
    """[B, 3, H, W] in [-1, 1] -> latents [B, z_channels, h, w]."""

    def __init__(self, cfg: VQGanConfig, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        n_res = len(cfg.ch_mult)
        in_ch_mult = (1,) + tuple(cfg.ch_mult)
        curr_res = cfg.resolution
        self.conv_in = _conv(cfg.in_channels, cfg.ch, 3, dtype)
        levels = []
        for i_level in range(n_res):
            level = _Level()
            block_in = cfg.ch * in_ch_mult[i_level]
            block_out = cfg.ch * cfg.ch_mult[i_level]
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out, dtype))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in, dtype))
            if i_level != n_res - 1:
                level.downsample = Downsample(block_in, dtype)
                curr_res //= 2
            levels.append(level)
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(block_in, dtype)
        self.norm_out = _norm(block_in)
        z_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = _conv(block_in, z_ch, 3, dtype)

    def forward(self, x):
        h = self.conv_in(x.to(self.dtype))
        for level in self.down:
            for i_block, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if hasattr(level, 'downsample'):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(_norm_silu(self.norm_out, h, self.dtype))


class Decoder(nn.Module):
    def __init__(self, cfg: VQGanConfig, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        n_res = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        curr_res = cfg.resolution // 2 ** (n_res - 1)
        self.conv_in = _conv(cfg.z_channels, block_in, 3, dtype)
        self.mid = _Mid(block_in, dtype)
        levels = [None] * n_res
        for i_level in reversed(range(n_res)):
            level = _Level()
            block_out = cfg.ch * cfg.ch_mult[i_level]
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, block_out, dtype))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in, dtype))
            if i_level != 0:
                level.upsample = Upsample(block_in, dtype)
                curr_res *= 2
            levels[i_level] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = _norm(block_in)
        self.conv_out = _conv(block_in, cfg.out_ch, 3, dtype)
        self._name_sites()
        self.set_int8_scales(cfg.int8_scales)

    def _name_sites(self):
        """Give each int8 site its JAX path (mmvid_tpu/models/vqgan.py
        Decoder: ``decoder/<block>/<conv>``)."""
        blocks = [('mid_block_1', self.mid.block_1),
                  ('mid_attn_1', self.mid.attn_1),
                  ('mid_block_2', self.mid.block_2)]
        for i, level in enumerate(self.up):
            blocks += [(f'up_{i}_block_{j}', blk)
                       for j, blk in enumerate(level.block)]
            blocks += [(f'up_{i}_attn_{j}', blk)
                       for j, blk in enumerate(level.attn)]
            if hasattr(level, 'upsample'):
                blocks.append((f'up_{i}_upsample', level.upsample))
        self.conv_in.site = 'decoder/conv_in'
        self.conv_out.site = 'decoder/conv_out'
        for name, blk in blocks:
            for conv_name, conv in blk.named_children():
                if isinstance(conv, SiteConv):
                    conv.site = f'decoder/{name}/{conv_name}'

    def set_int8_scales(self, scales):
        """Sorted (path, scale) pairs, or None: the unquantized path."""
        table = dict(scales or ())
        for mod in self.modules():
            if isinstance(mod, SiteConv) and mod.site is not None:
                mod.a_scale = table.get(mod.site)

    def forward(self, z):
        h = self.mid(self.conv_in(z.to(self.dtype)))
        for i_level in reversed(range(len(self.up))):
            level = self.up[i_level]
            for i_block, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if i_level != 0:
                h = level.upsample(h)
        return self.conv_out(_norm_silu(self.norm_out, h, self.dtype))


class VectorQuantizer(nn.Module):
    """The codebook [n_embed, embed_dim], kept in fp32; the forward is
    nearest-neighbour VQ with the straight-through gradient (taming
    quantize.py:230-358, legacy beta placement)."""

    BETA = 0.25

    def __init__(self, n_embed: int, embed_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(n_embed, embed_dim)

    def lookup(self, indices):
        return self.embedding(indices)

    def nearest(self, z):
        """z [..., embed_dim] -> [...] int64 ids of the nearest codes (fp32
        scores; the CUDA kernel on the card)."""
        return nearest_codebook_indices(z, self.embedding.weight)

    def forward(self, z):
        """z [B, C, h, w] -> (z_q [B, C, h, w] in z's dtype, the codebook
        loss, ids [B, h, w]).  The ids carry no gradient; z_q's gradient
        goes to z unchanged (straight-through), the loss's to z and to
        the codebook."""
        z32 = z.float()
        idx = nearest_codebook_indices(z32.detach().permute(0, 2, 3, 1),
                                       self.embedding.weight.detach())
        z_q = self.embedding(idx).permute(0, 3, 1, 2)
        loss = (torch.mean((z_q.detach() - z32) ** 2)
                + self.BETA * torch.mean((z_q - z32.detach()) ** 2))
        z_q = z32 + (z_q - z32).detach()
        return z_q.to(z.dtype), loss, idx


KL_WEIGHT = 5e-4   # the Gumbel quantizer's KL-to-uniform weight (taming's)


def gumbel_noise(shape, generator: torch.Generator):
    """-log(-log(u)), u uniform in [1e-20, 1) (JAX's draw in
    ``GumbelQuantize``), from ``generator`` on its device."""
    u = torch.rand(shape, generator=generator,
                   device=generator.device).clamp_min(1e-20)
    return -torch.log(-torch.log(u))


def gumbel_quantize(logits, embed, noise=None, temp: float = 1.0):
    """Gumbel-softmax quantization of code logits [B, n_embed, h, w]
    against ``embed`` [n_embed, embed_dim]: with ``noise`` (training) the
    soft one-hot softmax((logits + noise) / temp), made hard in the
    forward (straight-through); without, the arg-max one-hot.  Returns
    (z_q [B, embed_dim, h, w], KL_WEIGHT x KL to the uniform prior, ids
    [B, h, w])."""
    n_embed = logits.shape[1]
    if noise is not None:
        soft = torch.softmax((logits + noise) / temp, dim=1)
        idx = soft.argmax(1)
        hard = F.one_hot(idx, n_embed).permute(0, 3, 1, 2).to(soft.dtype)
        soft = soft + (hard - soft).detach()
    else:
        idx = logits.argmax(1)
        soft = F.one_hot(idx, n_embed).permute(0, 3, 1, 2).to(
            logits.dtype)
    z_q = torch.einsum('bnhw,nd->bdhw', soft, embed)
    probs = torch.softmax(logits, dim=1)
    kl = KL_WEIGHT * torch.mean(
        torch.sum(probs * torch.log(probs * n_embed + 1e-10), dim=1))
    return z_q, kl, idx


class GumbelQuantize(nn.Module):
    """Gumbel-softmax quantizer (taming quantize.py:113-227): a 1x1
    ``proj`` conv from ``embed_dim`` channels to code logits, a codebook
    ``embed``; :func:`gumbel_quantize` does the rest.  Training draws its
    noise from ``generator`` (on the module's device)."""

    def __init__(self, n_embed: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(embed_dim, n_embed, 1)
        self.embed = nn.Embedding(n_embed, embed_dim)

    def forward(self, z, temp: float = 1.0, train: bool = False,
                generator: torch.Generator | None = None):
        """z [B, embed_dim, h, w] -> (z_q [B, embed_dim, h, w], kl, ids
        [B, h, w])."""
        logits = self.proj(z)
        noise = gumbel_noise(logits.shape, generator) if train else None
        return gumbel_quantize(logits, self.embed.weight, noise, temp)


class VQModel(nn.Module):
    """taming's VQModel: encode to ids and decode ids (serving), and the
    training surface (``encode``, ``decode_latent``, ``forward``) that
    ``models/vqgan_losses.py`` finetunes.  The encoder is registered after
    the decode half, so the decode half's weights drawn by
    ``factories.init_weights`` do not depend on it."""

    def __init__(self, cfg: VQGanConfig, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.decoder = Decoder(cfg, dtype)
        self.quantize = VectorQuantizer(cfg.n_embed, cfg.embed_dim)
        self.post_quant_conv = _conv(cfg.embed_dim, cfg.z_channels, 1, dtype)
        self.encoder = Encoder(cfg, dtype)
        self.quant_conv = _conv(cfg.z_channels, cfg.embed_dim, 1, dtype)

    def encode_latents(self, x):
        """x [B, 3, H, W] in [-1, 1] -> fp32 latents [B, h, w, embed_dim]
        (cast to fp32 before the codebook search, as the JAX package
        does)."""
        h = self.quant_conv(self.encoder(x)).float()
        return h.permute(0, 2, 3, 1)

    def encode_indices(self, x):
        """x [B, 3, H, W] in [-1, 1] -> ids [B, h, w] int64."""
        return self.quantize.nearest(self.encode_latents(x))

    def encode(self, x):
        """x [B, C, H, W] in [-1, 1] -> (z_q [B, embed_dim, h, w], the
        codebook loss, ids [B, h, w])."""
        return self.quantize(self.quant_conv(self.encoder(x)))

    def decode_latent(self, quant):
        """quant [B, embed_dim, h, w] -> image [B, out_ch, H, W]."""
        return self.decoder(self.post_quant_conv(quant.to(self.dtype)))

    def decode_code(self, code):
        """code [B, h, w] int -> image [B, 3, H, W] in about [-1, 1]."""
        return self.decode_latent(
            self.quantize.lookup(code).permute(0, 3, 1, 2))

    def forward(self, x):
        """x [B, C, H, W] -> (reconstruction, codebook loss)."""
        quant, diff, _ = self.encode(x)
        return self.decode_latent(quant), diff


class VQGanVAE(nn.Module):
    """MMVID-facing VQGAN wrapper.  ``image_size`` overrides the config
    resolution, as in the JAX package."""

    def __init__(self, image_size: int | None = None,
                 cfg: VQGanConfig | None = None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg or VQGanConfig()
        if image_size:
            self.cfg = dataclasses.replace(self.cfg, resolution=image_size)
        self.model = VQModel(self.cfg, dtype)
        self.image_size = image_size or 256
        self.num_layers = self.cfg.num_layers
        self.num_tokens = self.cfg.n_embed
        self.fmap_size = self.image_size // (2 ** self.num_layers)
        self.image_seq_len = self.fmap_size ** 2

    def set_int8_scales(self, scales):
        """Run the decoder's convs int8 with ``scales`` (sorted (JAX path,
        scale) pairs), or unquantized with None; the config records
        them."""
        self.cfg = dataclasses.replace(self.cfg, int8_scales=scales)
        self.model.cfg = self.cfg
        self.model.decoder.cfg = self.cfg
        self.model.decoder.set_int8_scales(scales)

    @torch.no_grad()
    def get_codebook_indices(self, img):
        """img [B, H, W, 3] in [0, 1] -> ids [B, n] int64."""
        x = (2.0 * img - 1.0).permute(0, 3, 1, 2)
        idx = self.model.encode_indices(x)
        return idx.reshape(idx.shape[0], -1)

    @torch.no_grad()
    def decode(self, seq):
        """seq [B, n] ids -> images [B, H, W, 3] in [0, 1] (compute
        dtype)."""
        b, n = seq.shape
        f = int(round(n ** 0.5))
        img = self.model.decode_code(seq.reshape(b, f, f))
        return (img.permute(0, 2, 3, 1).clamp(-1.0, 1.0) + 1.0) * 0.5
