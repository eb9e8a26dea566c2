"""The full CLIP model (image and text towers) in PyTorch, for the CLIP
score and to read ``ViT-B-32.pt`` end to end.

The port's counterpart of ``mmvid_tpu/models/clip_full.py`` (the OpenAI
CLIP rebuild of mmvid_pytorch/transformers/clip_model.py:250-432): the ViT
image tower (patch conv, class token, ln_pre / ln_post, projection) and
the text tower (token embedding, causal 77-token transformer, ln_final,
the projection at the argmax token).  Used by the CLIP-score metric
(utils/utils.py:62-85, utils/utils_eval.py:226-323).

Both towers run the port's :class:`~mmvid_tpu_torch.models.clip.
TransformerStack` in fp32, as JAX's scorer runs: on the card attention
takes the fp32 route of the attention kernel
(``csrc/attention_fp32_sm90.cu``).
Modules carry OpenAI's state_dict names: :class:`CLIP`'s ``state_dict()``
has the archive's layout (the text tower at the top level, ``visual.*``,
``logit_scale``), so an archive's weights load unchanged and a traced
:class:`CLIP` is such an archive.  :class:`ClipVisual` takes NCHW, as
OpenAI's does; :class:`CLIPScorer` takes the JAX package's NHWC frames in
[0, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from mmvid_tpu_torch.models.clip import (
    ClipStackConfig,
    TransformerStack,
    attention_mask,
    layer_norm_fp32,
)
from mmvid_tpu_torch.utils.resize import resize_nearest


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_width: int = 768
    vision_layers: int = 12
    vision_patch_size: int = 32
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_layers: int = 12

    @property
    def vision_heads(self):
        return self.vision_width // 64

    @property
    def transformer_heads(self):
        return self.transformer_width // 64


class ClipVisual(nn.Module):
    """OpenAI's ``VisionTransformer``: [B, 3, H, W] (CLIP-normalized) ->
    [B, embed_dim] fp32."""

    def __init__(self, cfg: ClipConfig):
        super().__init__()
        w, p = cfg.vision_width, cfg.vision_patch_size
        grid = cfg.image_resolution // p
        self.conv1 = nn.Conv2d(3, w, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(
            torch.zeros(grid * grid + 1, w))
        self.ln_pre = nn.LayerNorm(w)
        self.transformer = TransformerStack(
            ClipStackConfig(w, cfg.vision_layers, cfg.vision_heads))
        self.ln_post = nn.LayerNorm(w)
        self.proj = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def forward(self, x):
        x = self.conv1(x.float())                 # [B, W, gh, gw]
        x = x.flatten(2).transpose(1, 2)          # [B, gh * gw, W]
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = layer_norm_fp32(self.ln_pre, x, torch.float32)
        x = self.transformer(x, None)
        x = layer_norm_fp32(self.ln_post, x[:, 0, :], torch.float32)
        return x @ self.proj


class ClipText(nn.Module):
    """OpenAI CLIP's text tower, under its top-level names: tokens
    [B, context_length] int -> [B, embed_dim] fp32, the features taken at
    the argmax token (EOT has the highest id)."""

    def __init__(self, cfg: ClipConfig):
        super().__init__()
        w = cfg.transformer_width
        self.token_embedding = nn.Embedding(cfg.vocab_size, w)
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.context_length, w))
        self.transformer = TransformerStack(
            ClipStackConfig(w, cfg.transformer_layers,
                            cfg.transformer_heads))
        self.ln_final = nn.LayerNorm(w)
        self.text_projection = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def encode_text(self, text):
        text = text.long()
        l = text.shape[1]
        x = self.token_embedding(text) + self.positional_embedding[:l]
        x = self.transformer(x, attention_mask(l, 'causal',
                                               device=text.device))
        x = layer_norm_fp32(self.ln_final, x, torch.float32)
        eot = text.argmax(dim=-1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return x @ self.text_projection

    def forward(self, text):
        return self.encode_text(text)


class CLIP(ClipText):
    """The whole OpenAI CLIP: the text tower at the top level (its
    state_dict names are the archive's), ``visual`` and ``logit_scale``.
    ``forward(image, text)`` returns OpenAI's (logits_per_image,
    logits_per_text), so ``torch.jit.trace`` of it makes a
    ``ViT-B-32.pt``-format archive."""

    def __init__(self, cfg: ClipConfig):
        super().__init__(cfg)
        self.cfg = cfg
        self.visual = ClipVisual(cfg)
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07))))

    def encode_image(self, image):
        return self.visual(image)

    def forward(self, image, text):
        a = self.encode_image(image)
        b = self.encode_text(text)
        a = a / a.norm(dim=-1, keepdim=True)
        b = b / b.norm(dim=-1, keepdim=True)
        logits = self.logit_scale.exp() * a @ b.t()
        return logits, logits.t()


@torch.no_grad()
def init_random(model: CLIP, generator: torch.Generator) -> None:
    """OpenAI's initialization (clip_model.py ``initialize_parameters``)
    drawn from ``generator`` (a CPU generator): embeddings N(0, 0.02) and
    N(0, 0.01), the ViT's tables and projection N(0, width^-0.5), each
    stack's attention and MLP weights at its widths' scales, conv1
    N(0, 1 / fan_in), LayerNorms ones and zeros, biases zeros; for
    archives made from a seed."""
    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    cfg = model.cfg
    normal(model.token_embedding.weight, 0.02)
    normal(model.positional_embedding, 0.01)
    normal(model.text_projection, cfg.transformer_width ** -0.5)
    vis = model.visual
    vw = cfg.vision_width
    for p in (vis.class_embedding, vis.positional_embedding, vis.proj):
        normal(p, vw ** -0.5)
    normal(vis.conv1.weight, vis.conv1.weight[0].numel() ** -0.5)
    for stack in (model.transformer, vis.transformer):
        w, n = stack.cfg.width, stack.cfg.layers
        for block in stack.resblocks:
            normal(block.attn.in_proj_weight, w ** -0.5)
            normal(block.attn.out_proj.weight, w ** -0.5 * (2 * n) ** -0.5)
            normal(block.mlp.c_fc.weight, (2 * w) ** -0.5)
            normal(block.mlp.c_proj.weight, w ** -0.5 * (2 * n) ** -0.5)
    for name, p in model.named_parameters():
        if name.endswith('bias'):
            p.zero_()
        elif '.ln_' in name or name.startswith('ln_'):
            p.fill_(1.0)


# CLIP image normalization constants (OpenAI)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(images: torch.Tensor, resolution: int = 224
                    ) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> CLIP-normalized [B, res, res, 3] fp32.

    The JAX package resizes with ``jax.image.resize(..., 'nearest')``
    (input row floor((i + 0.5) * in / out)), and the port matches it; the
    reference's clip_similarity upsampled with ``F.interpolate``'s default
    ``'nearest'`` (floor(i * in / out), utils/utils.py:66-67), which takes
    other rows (ROADMAP.md queue C)."""
    x = resize_nearest(images.float(), resolution, resolution)
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


class CLIPScorer:
    """``encode_image`` / ``encode_text`` of a CLIP archive's weights, fp32,
    on ``device``."""

    def __init__(self, cfg: ClipConfig, visual_sd, text_sd, device='cuda'):
        self.cfg = cfg
        self.device = torch.device(device)
        self.visual = ClipVisual(cfg)
        self.text = ClipText(cfg)
        self.visual.load_state_dict(visual_sd)
        self.text.load_state_dict(text_sd)
        self.visual.to(self.device).eval()
        self.text.to(self.device).eval()

    @torch.no_grad()
    def encode_image(self, images01):
        """[B, H, W, 3] in [0, 1] -> [B, embed_dim]."""
        x = torch.as_tensor(images01, device=self.device)
        x = clip_preprocess(x, self.cfg.image_resolution)
        return self.visual(x.permute(0, 3, 1, 2))

    @torch.no_grad()
    def encode_text(self, tokens):
        """[B, context_length] int -> [B, embed_dim]."""
        return self.text(torch.as_tensor(np.asarray(tokens),
                                         device=self.device))

    def similarity(self, tokens, images01):
        a = self.encode_text(tokens)
        b = self.encode_image(images01)
        a = a / a.norm(dim=-1, keepdim=True)
        b = b / b.norm(dim=-1, keepdim=True)
        return (a * b).sum(-1)


def _n_blocks(sd, prefix: str) -> int:
    return len({k[len(prefix):].split('.')[0] for k in sd
                if k.startswith(prefix)})


def convert_clip_full(sd: Dict[str, torch.Tensor]
                      ) -> Tuple[ClipConfig, Dict, Dict]:
    """A CLIP state_dict (OpenAI's names) -> (config, the visual tower's
    state_dict, the text tower's), fp32; the config read off the shapes as
    JAX's ``convert_clip_full`` reads it."""
    vision_width = sd['visual.conv1.weight'].shape[0]
    vision_patch = sd['visual.conv1.weight'].shape[-1]
    grid = int(round((sd['visual.positional_embedding'].shape[0] - 1)
                     ** 0.5))
    cfg = ClipConfig(
        embed_dim=sd['text_projection'].shape[1],
        image_resolution=vision_patch * grid,
        vision_width=vision_width,
        vision_layers=_n_blocks(sd, 'visual.transformer.resblocks.'),
        vision_patch_size=vision_patch,
        context_length=sd['positional_embedding'].shape[0],
        vocab_size=sd['token_embedding.weight'].shape[0],
        transformer_width=sd['ln_final.weight'].shape[0],
        transformer_layers=_n_blocks(sd, 'transformer.resblocks.'))
    f32 = {k: torch.as_tensor(v).float() for k, v in sd.items()}
    visual = {k[len('visual.'):]: v for k, v in f32.items()
              if k.startswith('visual.')}
    text = {k: v for k, v in f32.items()
            if not k.startswith('visual.') and k != 'logit_scale'}
    return cfg, visual, text


def load_clip_scorer(model_path: str, device='cuda') -> CLIPScorer:
    """The scorer of a ``ViT-B-32.pt``-format torch.jit archive."""
    from mmvid_tpu_torch.utils.torch_compat import load_torchjit_state_dict
    cfg, visual, text = convert_clip_full(load_torchjit_state_dict(
        model_path))
    return CLIPScorer(cfg, visual, text, device=device)
