"""Top-level MMVID model in PyTorch: BertCore + VQGAN decoder, with batched
mask-predict generation.

Counterpart of ``mmvid_tpu/models/mmvid.py`` (the generation surface).
PyTorch runs eagerly, so there is no trace cache.
"""

from __future__ import annotations

import torch
from torch import nn

from mmvid_tpu_torch.models.bert import BertConfig, BertCore
from mmvid_tpu_torch.models.sampler import (
    arrange_preserve_tokens,
    build_spec,
    mask_predict,
    preserve_layout,
)
from mmvid_tpu_torch.models.vqgan import VQGanVAE

DEFAULT_MP_CONFIG = {
    'T1_n': 10, 'T2_n': 10, 'T3_n': 30, 'N1_n': 0.9, 'N2_n': 0.1,
    'N3_n': 0.125, 'N4_n': 0.0625,
    'T1_t': 10, 'T2_t': 5, 'T3_t': 35, 'N1_t': 0.0, 'N2_t': 0.0,
    'N3_t': 0.0, 'N4_t': 0.0,
    'T': 20, 'B': 1,
}


class MMVIDBert(nn.Module):
    """Holds ``core`` (BertCore) and ``vae`` (its ``model`` is the VQGAN).

    ``core``'s submodules are registered on this module directly (the same
    objects, so ``core`` sees every load and device move), which makes
    ``state_dict()`` the reference ``dalle.pt`` ``weights`` payload:
    ``transformer.*``, ``to_logits.*``, ``image_emb.weight`` ...,
    ``vae.model.*``."""

    def __init__(self, cfg: BertConfig, vae: VQGanVAE, dtype=torch.float32):
        super().__init__()
        core = BertCore(cfg, dtype=dtype)
        for name, child in core.named_children():
            self.add_module(name, child)
        object.__setattr__(self, 'core', core)  # not a second registration
        self.vae = vae
        self.cfg = cfg

    @torch.no_grad()
    def generate_images(self, generator, text, *, visual=None,
                        mask_predict_steps=0, preserve=None, t_overlap=1,
                        long_mode='long', dynamic=True, mp_config=None,
                        decode=True):
        """text [B, text_seq_len] int -> (videos [B, T, H, W, 3] in [0, 1]
        or None when ``decode`` is False, img_seq [B, T*n] int64).
        ``generator`` is a torch.Generator on the model's device."""
        if visual is not None:
            raise NotImplementedError(
                'visual controls need the VQGAN encoder and the cvae, not '
                'ported yet (ROADMAP.md queue A, items 5-6)')
        cfg = self.cfg
        mp_config = mp_config or DEFAULT_MP_CONFIG
        pmask, N = preserve_layout(cfg, long_mode, t_overlap,
                                   preserve is not None)
        spec = build_spec(mp_config, N, steps=mask_predict_steps,
                          dynamic=dynamic)
        visual_tokens = None
        if cfg.num_visuals > 0:  # no visual control: all [MASK]
            visual_tokens = torch.full(
                (text.shape[0], cfg.visual_seq_len), cfg.mask_token,
                dtype=torch.long, device=text.device)
        control_emb = self.core.control_embedding(text, visual_tokens)
        ptoks = None
        if preserve is not None:
            ptoks = arrange_preserve_tokens(cfg, preserve, long_mode,
                                            t_overlap)
        img_seq = mask_predict(self.core, control_emb, generator, spec,
                               pmask, ptoks)
        if not decode:
            return None, img_seq
        return self.decode_video(img_seq), img_seq

    @torch.no_grad()
    def decode_video(self, img_seq):
        cfg = self.cfg
        b = img_seq.shape[0]
        frames = img_seq.reshape(b * cfg.num_targets, cfg.image_seq_len)
        imgs = self.vae.decode(frames)
        return imgs.reshape((b, cfg.num_targets) + imgs.shape[1:])
