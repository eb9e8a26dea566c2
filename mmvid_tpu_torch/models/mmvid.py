"""Top-level MMVID model in PyTorch: BertCore + the VQGAN tokenizers (vae
for the targets, an optional cvae for visual controls), with the training
loss and batched mask-predict generation.

Counterpart of ``mmvid_tpu/models/mmvid.py``: tokenization, the
visual-control pipeline, ``loss`` (MSM / REL / VID, with the frozen VQGANs
tokenizing targets and VID negatives inside it), ``generate_images`` (with
the long-video modes' preserved slots) and ``generate_images_debug``.
PyTorch runs eagerly, so there is no trace cache.
"""

from __future__ import annotations

import dataclasses
import os

import torch
from torch import nn

from mmvid_tpu_torch.models.bert import BertConfig, BertCore, bert_losses
from mmvid_tpu_torch.models.masking import (
    erase_codebook_face,
    random_erase_codebook,
    sample_msm_mask,
)
from mmvid_tpu_torch.models.sampler import (
    arrange_preserve_tokens,
    build_spec,
    mask_predict,
    mask_predict_trace,
    preserve_layout,
)
from mmvid_tpu_torch.models.vqgan import VQGanVAE
from mmvid_tpu_torch.models.warp import (
    apply_warp_token_plan,
    color_draws,
    warp,
    warp_draws,
    warp_token_plan,
    warp_video_with_color,
)
from mmvid_tpu_torch.parallel.mesh import LOCAL

DEFAULT_MP_CONFIG = {
    'T1_n': 10, 'T2_n': 10, 'T3_n': 30, 'N1_n': 0.9, 'N2_n': 0.1,
    'N3_n': 0.125, 'N4_n': 0.0625,
    'T1_t': 10, 'T2_t': 5, 'T3_t': 35, 'N1_t': 0.0, 'N2_t': 0.0,
    'N3_t': 0.0, 'N4_t': 0.0,
    'T': 20, 'B': 1,
}


class MMVIDBert(nn.Module):
    """Holds ``core`` (BertCore), ``vae`` and, for visual controls, ``cvae``
    (each VQGanVAE's ``model`` is the VQGAN).  Given a cvae, the config's
    ``use_separate_visual_emb`` is forced on, as in the JAX package.

    ``core``'s submodules are registered on this module directly (the same
    objects, so ``core`` sees every load and device move), which makes
    ``state_dict()`` the reference ``dalle.pt`` ``weights`` payload:
    ``transformer.*``, ``to_logits.*``, ``image_emb.weight`` ...,
    ``vae.model.*``, ``cvae.model.*``.  The trainable parameters are
    ``core``'s; the VQGANs stay frozen.  ``dtype`` is the compute dtype,
    ``param_dtype`` the core's dense parameters' (``dtype`` unless given:
    a training build holds fp32 parameters and computes in bf16)."""

    def __init__(self, cfg: BertConfig, vae: VQGanVAE,
                 cvae: VQGanVAE | None = None, dtype=torch.float32,
                 param_dtype=None):
        super().__init__()
        if cvae is not None:
            cfg = dataclasses.replace(cfg, use_separate_visual_emb=True)
        core = BertCore(cfg, dtype=dtype, param_dtype=param_dtype)
        for name, child in core.named_children():
            self.add_module(name, child)
        object.__setattr__(self, 'core', core)  # not a second registration
        self.vae = vae
        self.cvae = cvae
        self.cfg = cfg

    def set_int8_scales(self, scales):
        """Run the backbone w8a8 with ``scales`` (per layer (qkv_in,
        out_in, fc_in, proj_in)), or unquantized with None; the configs
        record them.  ``ops.int8.quantize_for_serving`` calibrates them
        and applies them to a copy that shares the parameters."""
        self.cfg = dataclasses.replace(self.cfg, clip=dataclasses.replace(
            self.cfg.clip, int8_scales=scales))
        self.core.cfg = self.cfg
        self.transformer['transformer'].cfg = self.cfg.clip

    # -- tokenization --------------------------------------------------

    def _tokenizer(self, which_vae: str) -> VQGanVAE:
        if which_vae == 'cvae' and self.cvae is not None:
            return self.cvae
        return self.vae

    @torch.no_grad()
    def get_image_tokens(self, images, which_vae='vae', insert_sep=False):
        """images [B, T, H, W, 3] (or [B, H, W, 3]) in [0, 1] -> ids
        [B, T*n (+T)] int64."""
        if images.dim() == 4:
            images = images[:, None]
        b, t = images.shape[:2]
        flat = images.reshape((b * t,) + images.shape[2:])
        toks = self._tokenizer(which_vae).get_codebook_indices(flat)
        toks = toks.reshape(b, t, -1)
        if insert_sep:
            sep = torch.full((b, t, 1), self.cfg.sep_token,
                             dtype=toks.dtype, device=toks.device)
            toks = torch.cat([toks, sep], dim=2)
        return toks.reshape(b, -1)

    @torch.no_grad()
    def prepare_visual_tokens(self, generator, visual, *, erase_visual=False,
                              erase_visual_half=False, vc_mode=None,
                              face_mode=None, visual_aug_mode=None,
                              dp=LOCAL):
        """Visual-control pipeline: frames [B, V, H, W, 3] in [0, 1] (or
        token ids [B, visual_seq_len]) -> tokenized through the cvae ->
        optional random erase (``erase_visual``) -> structured erase per
        ``vc_mode``.  ``generator`` draws the random erasers, for the
        global batch of the data-parallel ranks ``dp``."""
        cfg = self.cfg
        if visual is None:
            return None
        if visual.dim() >= 4 and visual.is_floating_point():
            if visual_aug_mode == 'motion_color':
                # with p 0.9, one color shift a sample over the frames
                # after the first
                do = torch.rand((), generator=generator,
                                device=visual.device) < 0.9
                colors = color_draws(generator, dp.batch(visual.shape[0]),
                                     visual.device)
                shifted = torch.cat([visual[:, :1], warp_video_with_color(
                    generator, visual[:, 1:],
                    {k: dp.rows(v) for k, v in colors.items()})], dim=1)
                visual = torch.where(do, shifted, visual)
            tokens = self.get_image_tokens(visual, which_vae='cvae',
                                           insert_sep=cfg.insert_sep)
        else:
            tokens = visual  # already token ids
        if cfg.insert_sep:
            if erase_visual or vc_mode is not None:
                raise NotImplementedError(
                    'erase_visual/vc_mode with insert_sep: unsupported in '
                    'the JAX package too (ROADMAP.md queue A, item A3)')
            return tokens
        if erase_visual:
            tokens = random_erase_codebook(generator, tokens, cfg,
                                           erase_half=erase_visual_half,
                                           dp=dp)
        if vc_mode is not None:
            tokens = erase_codebook_face(generator, tokens, cfg, vc_mode,
                                         face_mode)
        return tokens

    def fully_masked_visual(self, batch: int, device=None):
        """[batch, visual_seq_len] of [MASK]: no visual control."""
        return torch.full((batch, self.cfg.visual_seq_len),
                          self.cfg.mask_token, dtype=torch.long,
                          device=device)

    @torch.no_grad()
    def recon_images(self, images, which_vae='vae'):
        """Tokenize and decode (a round trip, for visualisation): any frame
        count -> [B, T, H, W, 3] in [0, 1]."""
        toks = self.get_image_tokens(images, which_vae=which_vae)
        b = toks.shape[0]
        t = toks.shape[1] // self.cfg.image_seq_len
        imgs = self._tokenizer(which_vae).decode(
            toks.reshape(b * t, self.cfg.image_seq_len))
        return imgs.reshape((b, t) + imgs.shape[1:])

    # -- training loss -------------------------------------------------

    def loss(self, generator, *, text, visual=None, target=None,
             rel=False, vid=False, msm_strategy_prob=(0.7, 0.1, 0.1, 0.1),
             msm_bernoulli_prob=(0.2, 0.5), rel_no_fully_masked=False,
             vid_strategy_prob=(0.25, 0.25, 0.25, 0.25), pc_prob=0.0,
             erase_visual=False, erase_visual_half=False, vc_mode=None,
             face_mode=None, visual_aug_mode=None, negvc=False,
             visual_neg=None, text_neg=None, visual_drop=None, draws=None,
             dp=LOCAL):
        """(loss_msm, loss_rel, loss_vid), the JAX package's
        ``MMVIDBert.loss``.  text: as ``generate_images`` takes it.
        target: frames [B, T, H, W, 3] in [0, 1] or
        ids [B, target_seq_len]; the frozen VQGANs tokenize targets,
        visual controls and the VID negatives under no_grad.
        ``visual_drop``: a bool (or 0-d tensor), True replaces the visual
        control by a fully [MASK] row (the dropout_vc path).
        ``generator`` draws the MSM masks, the VID warps and the visual
        erasers.  ``draws``, the deterministic hook: a dict that may carry
        ``keep`` and ``nfm`` (:func:`sample_msm_mask`'s outputs), ``warp``
        (:func:`models.warp.warp_draws`'s) and ``visual_drop``, used in
        place of the generator's draws.

        ``dp``: the data-parallel ranks (:mod:`parallel.mesh`); the batch
        is this rank's rows of the global batch.  Every draw, and every
        hook's draw, is of the global batch's shape, and each rank keeps
        its rows; the losses are this rank's shares (:func:`bert_losses`).
        So the ranks take exactly the draws of one process at the global
        batch."""
        cfg = self.cfg
        draws = draws or {}
        b, dev = text.shape[0], text.device
        n = dp.batch(b)
        visual_drop = draws.get('visual_drop', visual_drop)
        visual_tokens = None
        if cfg.num_visuals > 0:
            if visual is not None:
                visual_tokens = self.prepare_visual_tokens(
                    generator, visual, erase_visual=erase_visual,
                    erase_visual_half=erase_visual_half, vc_mode=vc_mode,
                    face_mode=face_mode, visual_aug_mode=visual_aug_mode,
                    dp=dp)
                if visual_drop is not None:
                    visual_tokens = torch.where(
                        torch.as_tensor(visual_drop, device=dev),
                        self.fully_masked_visual(b, dev), visual_tokens)
            else:
                visual_tokens = self.fully_masked_visual(b, dev)

        target_frames = None
        if target.dim() >= 4:
            target_frames = target
            target = self.get_image_tokens(target)
        if 'keep' in draws:
            keep, nfm = draws['keep'], draws['nfm']
        else:
            keep, nfm = sample_msm_mask(generator, cfg, msm_strategy_prob,
                                        msm_bernoulli_prob, pc_prob,
                                        batch=n, device=dev)
        keep, nfm = dp.rows(keep), dp.rows(nfm)

        target_warp = None
        if vid and cfg.num_targets > 1 and target_frames is not None:
            wd = draws.get('warp') or warp_draws(
                generator, n, target_frames.shape[1], vid_strategy_prob, dev)
            # i_other stays a global row: the frame it steals may live on
            # another rank
            wd = {k: dp.rows(v) for k, v in wd.items()}
            if os.environ.get('MMVID_TOKEN_WARP', '1') == '1':
                # only the modified frame is encoded again
                mod_frame, plan = warp_token_plan(
                    generator, target_frames, vid_strategy_prob, wd)
                target_warp = apply_warp_token_plan(
                    target, self.get_image_tokens(mod_frame[:, None]), plan,
                    source=dp.gather(target))
            else:
                target_warp = self.get_image_tokens(warp(
                    generator, target_frames, vid_strategy_prob, wd,
                    source=dp.gather(target_frames)))

        # negvc: the negative control drops the visual segment;
        # visual_neg is taken and unused, as in the reference
        control_neg = text_neg if negvc and text_neg is not None else None
        return bert_losses(
            self.core, text=text, visual_tokens=visual_tokens,
            target_tokens=target, target_tokens_warp=target_warp,
            keep_gt_mask=keep, not_fully_masked=nfm, rel=rel, vid=vid,
            rel_no_fully_masked=rel_no_fully_masked,
            control_neg=control_neg, dp=dp)

    # -- generation ----------------------------------------------------

    @torch.no_grad()
    def generate_images(self, generator, text, *, visual=None,
                        erase_visual=False, vc_mode=None, face_mode=None,
                        mask_predict_steps=0, preserve=None, t_overlap=1,
                        long_mode='long', dynamic=True, mp_config=None,
                        decode=True):
        """text [B, text_seq_len] int, or with a fixed language model its
        [B, text_feature_dim] float features; visual: control frames
        [B, V, H, W, 3] in [0, 1] or ids, used when cfg.num_visuals > 0
        (none: a fully [MASK] control) -> (videos [B, T, H, W, 3] in [0, 1]
        or None when ``decode`` is False, img_seq [B, T*n] int64).
        ``generator`` is a torch.Generator on the model's device; it draws
        the random erasers first, then the sampler's noise."""
        cfg = self.cfg
        mp_config = mp_config or DEFAULT_MP_CONFIG
        pmask, N = preserve_layout(cfg, long_mode, t_overlap,
                                   preserve is not None)
        spec = build_spec(mp_config, N, steps=mask_predict_steps,
                          dynamic=dynamic)
        control_emb = self._control(generator, text, visual, erase_visual,
                                    vc_mode, face_mode)
        ptoks = None
        if preserve is not None:
            ptoks = arrange_preserve_tokens(cfg, preserve, long_mode,
                                            t_overlap)
        img_seq = mask_predict(self.core, control_emb, generator, spec,
                               pmask, ptoks)
        if not decode:
            return None, img_seq
        return self.decode_video(img_seq), img_seq

    def _control(self, generator, text, visual, erase_visual, vc_mode,
                 face_mode):
        """The control embedding of the sampling calls: the visual control
        through :meth:`prepare_visual_tokens` (a fully [MASK] one without
        ``visual``)."""
        visual_tokens = None
        if self.cfg.num_visuals > 0:
            if visual is not None:
                visual_tokens = self.prepare_visual_tokens(
                    generator, visual, erase_visual=erase_visual,
                    erase_visual_half=True, vc_mode=vc_mode,
                    face_mode=face_mode)
            else:
                visual_tokens = self.fully_masked_visual(text.shape[0],
                                                         text.device)
        return self.core.control_embedding(text, visual_tokens)

    @torch.no_grad()
    def generate_images_debug(self, generator, text, *, visual=None,
                              erase_visual=False, vc_mode=None,
                              face_mode=None, mask_predict_steps=0,
                              mp_config=None):
        """PNAG debug sampling: the fixed-length trace sampler
        (:func:`mask_predict_trace`) -> (videos [B, T, H, W, 3], img_seq
        [B, T*n], step_decodes [S, B, T, H, W, 3], step_keeps [S, B, T*n]
        bool), one decoded video and keep mask a round.  Each round's
        frames decode in a call of their own: all S rounds' at once (2560
        frames at the flagship's batch 16) do not fit on the card, and
        each frame decodes alone, so the frames are the same."""
        cfg = self.cfg
        mp_config = mp_config or DEFAULT_MP_CONFIG
        pmask, N = preserve_layout(cfg, 'long', 1, False)
        spec = build_spec(mp_config, N, steps=mask_predict_steps,
                          dynamic=False)
        control_emb = self._control(generator, text, visual, erase_visual,
                                    vc_mode, face_mode)
        trace, keeps, final = mask_predict_trace(self.core, control_emb,
                                                 generator, spec, pmask)
        step_decodes = torch.stack([self.decode_video(t) for t in trace])
        return step_decodes[-1], final, step_decodes, keeps

    @torch.no_grad()
    def decode_video(self, img_seq):
        cfg = self.cfg
        b = img_seq.shape[0]
        frames = img_seq.reshape(b * cfg.num_targets, cfg.image_seq_len)
        imgs = self.vae.decode(frames)
        return imgs.reshape((b, cfg.num_targets) + imgs.shape[1:])
