"""BERT-style non-autoregressive multimodal video transformer in PyTorch.

Counterpart of ``mmvid_tpu/models/bert.py``: config, embeddings,
transformer forward and heads, and the training losses (``bert_losses``:
MSM cross-entropy, REL and VID binary cross-entropies).

Sequence layout:
  [REL](1) | text(text_seq_len) | visual(num_visuals*n (+SEP)) |
  [ST1],[VID](2) | target(num_targets*n)          n = fmap^2 (64 for 128px)
With a fixed language model the text segment is one token, its pooled
features through ``text_feature_mapping``.

Submodule and parameter names are the reference ``dalle.pt`` ``weights``
names (``text_emb``, ``transformer.transformer.resblocks.{i}``,
``to_logits.{0,1}`` ...), so ``state_dict()`` is a reference-format payload.

The sequence runs at its true length (565 for the flagship): the JAX
package pads it to a multiple of 64 for the TPU's tiling, while the CUDA
attention kernels mask their own ragged edge, so serving needs no padding.
Calibration pads as JAX does (``transformer_forward``): its sites record
the pad rows too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmvid_tpu_torch.models.axial import (
    AxialPositionalEmbedding,
    AxialPositionalEmbeddingList,
)
from mmvid_tpu_torch.models.clip import (
    ClipStackConfig,
    TransformerStack,
    attention_mask,
    layer_norm_fp32,
    linear,
)
from mmvid_tpu_torch.ops import int8
from mmvid_tpu_torch.parallel.mesh import LOCAL


@dataclasses.dataclass(frozen=True)
class BertConfig:
    dim: int = 768
    num_text_tokens: int = 10000       # raw vocab; padding ids appended below
    text_seq_len: int = 50
    num_visuals: int = 0
    num_targets: int = 8
    num_image_tokens: int = 1024
    image_fmap_size: int = 8
    image_size: int = 128
    insert_sep: bool = False
    use_separate_visual_emb: bool = False
    fixed_language_model: Optional[str] = None
    text_feature_dim: int = 0
    text_emb_bottleneck: Optional[int] = None
    stable: bool = False
    clip: ClipStackConfig = ClipStackConfig()

    @property
    def effective_text_seq_len(self) -> int:
        return 1 if self.fixed_language_model else self.text_seq_len

    @property
    def effective_num_text_tokens(self) -> int:
        # one unique padding token per text position
        if self.fixed_language_model:
            return 1
        return self.num_text_tokens + self.text_seq_len

    @property
    def image_seq_len(self) -> int:
        return self.image_fmap_size ** 2

    @property
    def visual_seq_len(self) -> int:
        return (self.num_visuals * self.image_seq_len
                + self.num_visuals * int(self.insert_sep))

    @property
    def target_seq_len(self) -> int:
        return self.num_targets * self.image_seq_len

    @property
    def before_control_seq_len(self) -> int:
        return 1  # [REL]

    @property
    def after_control_seq_len(self) -> int:
        return 2  # [ST1], [VID]

    @property
    def control_seq_len(self) -> int:
        return (self.before_control_seq_len + self.effective_text_seq_len
                + self.visual_seq_len + self.after_control_seq_len)

    @property
    def total_seq_len(self) -> int:
        return self.control_seq_len + self.target_seq_len

    @property
    def rel_tok_index(self) -> int:
        return 0

    @property
    def st1_tok_index(self) -> int:
        return (self.before_control_seq_len + self.effective_text_seq_len
                + self.visual_seq_len)

    @property
    def vid_tok_index(self) -> int:
        return self.st1_tok_index + 1

    @property
    def txt_tok_index(self) -> int:
        return self.before_control_seq_len

    @property
    def mask_token(self) -> int:
        return self.num_image_tokens      # [MASK]

    @property
    def sep_token(self) -> int:
        return self.num_image_tokens + 1  # [SEP]


def _head(dim: int, out: int, dtype) -> nn.Sequential:
    """Sequential(LayerNorm, Linear): the reference's to_logits* layout."""
    return nn.Sequential(nn.LayerNorm(dim, eps=1e-5),
                         nn.Linear(dim, out, dtype=dtype))


class BertCore(nn.Module):
    """All learned parameters of the BERT plus its forward passes.
    ``dtype`` is the compute dtype, ``param_dtype`` the dense layers'
    parameters' (``dtype`` unless given; embeddings and norms are fp32)."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32,
                 param_dtype=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        param_dtype = param_dtype or dtype
        d = cfg.dim
        if cfg.fixed_language_model is None:
            self.text_emb = nn.Embedding(cfg.effective_num_text_tokens, d)
            self.text_pos_emb = nn.Embedding(cfg.effective_text_seq_len, d)
        elif cfg.text_emb_bottleneck is not None:
            # LN -> Linear -> LN -> Linear -> LN
            f, nf = cfg.text_feature_dim, int(cfg.text_emb_bottleneck)
            self.text_feature_mapping = nn.Sequential(
                nn.LayerNorm(f, eps=1e-5),
                nn.Linear(f, nf, dtype=param_dtype),
                nn.LayerNorm(nf, eps=1e-5),
                nn.Linear(nf, d, dtype=param_dtype),
                nn.LayerNorm(d, eps=1e-5))
        else:
            self.text_feature_mapping = nn.Linear(
                cfg.text_feature_dim, d, dtype=param_dtype)
        self.image_emb = nn.Embedding(cfg.num_image_tokens + 2, d)
        self.target_pos_emb = AxialPositionalEmbedding(
            d, (cfg.num_targets, cfg.image_fmap_size, cfg.image_fmap_size))
        if cfg.num_visuals > 0:
            if cfg.use_separate_visual_emb:
                self.visual_emb = nn.Embedding(cfg.num_image_tokens + 2, d)
            self.visual_pos_emb = AxialPositionalEmbeddingList(
                d, cfg.num_visuals,
                (cfg.image_fmap_size, cfg.image_fmap_size))
        self.special_emb = nn.Embedding(5, d)
        self.special_pos_emb = nn.Embedding(5, d)
        # the reference nests the resblock stack one level deeper
        # (OpenAICLIPTransformer.transformer), hence transformer.transformer
        self.transformer = nn.ModuleDict(
            {'transformer': TransformerStack(cfg.clip, dtype=dtype,
                                             param_dtype=param_dtype)})
        self.to_logits = _head(d, cfg.num_image_tokens, param_dtype)
        self.to_logits_rel = _head(d, 1, param_dtype)
        self.to_logits_vid = _head(d, 1, param_dtype)

    def text_feature_embedding(self, feat):
        """[B, text_feature_dim] features -> [B, D] through
        ``text_feature_mapping``: its norms in fp32, its dense layers in
        the compute dtype."""
        m = self.text_feature_mapping
        if isinstance(m, nn.Linear):
            return linear(m, feat.to(self.dtype))
        h = linear(m[1], layer_norm_fp32(m[0], feat, self.dtype))
        h = linear(m[3], layer_norm_fp32(m[2], h, self.dtype))
        return layer_norm_fp32(m[4], h, torch.float32)

    def control_embedding(self, text, visual_tokens=None, drop_visual=False):
        """[REL] | text | visual | [ST1][VID] -> [B, control_seq_len, D]
        fp32.  text: [B, text_seq_len] int tokens, padding id 0 remapped to
        a unique id per position; with ``cfg.fixed_language_model``, the
        fixed LM's [B, text_feature_dim] float features instead, one token
        through :meth:`text_feature_embedding`.  visual_tokens:
        [B, visual_seq_len] int tokens when cfg.num_visuals > 0.
        ``drop_visual``: negvc's negative control, [REL] | text |
        [ST1][VID] with no visual segment (shorter than control_seq_len
        when cfg.num_visuals > 0)."""
        cfg = self.cfg
        b, dev = text.shape[0], text.device
        features = cfg.fixed_language_model is not None
        if text.is_floating_point() != features:
            raise ValueError(
                f'text of dtype {text.dtype}: the model takes '
                + ('[B, text_feature_dim] float features of its fixed '
                   'language model' if features else '[B, text_seq_len] '
                   'int token ids'))
        before_tok = torch.zeros((b, 1), dtype=torch.long, device=dev)
        parts = [self.special_emb(before_tok)
                 + self.special_pos_emb(before_tok)]

        if features:
            parts.append(self.text_feature_embedding(text)[:, None, :])
        else:
            pos = torch.arange(cfg.text_seq_len, device=dev)
            text_range = pos + (cfg.effective_num_text_tokens
                                - cfg.text_seq_len)
            text = torch.where(text == 0, text_range[None, :], text)
            parts.append(self.text_emb(text) + self.text_pos_emb(pos)[None])

        if cfg.num_visuals > 0 and not drop_visual:
            if visual_tokens is None:
                raise ValueError('num_visuals > 0 needs visual_tokens')
            emb = (self.visual_emb if cfg.use_separate_visual_emb
                   else self.image_emb)(visual_tokens)
            parts.append(emb + self.visual_pos_emb(emb))

        after_tok = torch.tensor([1, 2], device=dev).expand(b, 2)
        parts.append(self.special_emb(after_tok)
                     + self.special_pos_emb(after_tok))
        return torch.cat([p.float() for p in parts], dim=1)

    def target_embedding(self, target_tokens):
        """image_emb(tokens) + axial target positional embedding."""
        emb = self.image_emb(target_tokens)
        return emb + self.target_pos_emb(emb)

    def transformer_forward(self, tokens_emb):
        """Full-sequence forward under the mask_prev mask; a shorter
        sequence gets the full-layout mask sliced [:L, :L].  While
        ``ops.int8.recording()`` is open, the sequence is padded as the
        JAX package's BertCore pads it: zero embeddings up to a multiple
        of 64, ``NEG_INF`` on the mask's pad rows and pad keys, the output
        sliced back to L; so the calibration sites record JAX's pad rows
        too and percentile scales agree.  Other forwards run at L."""
        cfg = self.cfg
        L = tokens_emb.shape[1]
        lp = -(-L // 64) * 64 if int8.is_recording() else L
        mask = attention_mask(
            cfg.total_seq_len, 'mask_prev',
            index=(cfg.st1_tok_index, cfg.vid_tok_index), length=L,
            pad_to=lp, device=tokens_emb.device)
        if lp != L:
            tokens_emb = F.pad(tokens_emb, (0, 0, 0, lp - L))
        out = self.transformer['transformer'](tokens_emb, mask)[:, :L]
        if self.cfg.stable:
            out = out / out.amax(dim=-1, keepdim=True)
        return out

    def _apply_head(self, head: nn.Sequential, h):
        return linear(head[1], layer_norm_fp32(head[0], h, self.dtype)
                      ).float()

    def to_logits_msm(self, h):
        return self._apply_head(self.to_logits, h)

    def to_logits_rel_vid(self, out):
        """(REL logit [B], VID logit [B]) from the full hidden sequence."""
        cfg = self.cfg
        rel = self._apply_head(self.to_logits_rel, out[:, cfg.rel_tok_index])
        vid = self._apply_head(self.to_logits_vid, out[:, cfg.vid_tok_index])
        return rel[..., 0], vid[..., 0]

    def _forward_tokens(self, control_emb, target_emb):
        tokens = torch.cat([control_emb, target_emb.float()], dim=1)
        return self.transformer_forward(tokens)

    def forward_full(self, control_emb, target_emb):
        """control | target -> (msm_logits, rel_logit, vid_logit, hidden)."""
        out = self._forward_tokens(control_emb, target_emb)
        rel, vid = self.to_logits_rel_vid(out)
        logits = self.to_logits_msm(out[:, self.cfg.control_seq_len:])
        return logits, rel, vid, out

    def forward_hidden(self, control_emb, target_emb):
        """Like forward_full, but the RAW target hidden rows in place of the
        MSM logits: the fused sample head applies to_logits itself."""
        out = self._forward_tokens(control_emb, target_emb)
        rel, vid = self.to_logits_rel_vid(out)
        return out[:, self.cfg.control_seq_len:], rel, vid

    def forward_rel_logit(self, control_emb, target_emb):
        """The REL logit [B] alone: negvc's negative forward, whose control
        may be shorter than control_seq_len (the mask sliced [:L, :L])."""
        out = self._forward_tokens(control_emb, target_emb)
        return self._apply_head(self.to_logits_rel,
                                out[:, self.cfg.rel_tok_index])[..., 0]

    def forward(self, text, visual_tokens, target_tokens):
        control = self.control_embedding(text, visual_tokens)
        return self.forward_full(control,
                                 self.target_embedding(target_tokens))


# ---------------------------------------------------------------------------
# Losses (all random inputs drawn by the caller: models/masking.py and
# models/warp.py)
# ---------------------------------------------------------------------------

def cross_entropy_masked(logits, labels, keep_gt_mask, dp=LOCAL):
    """MSM loss: the mean CE over the positions whose ground truth was
    replaced by [MASK] (keep_gt_mask False); over data-parallel ranks
    (``dp``), this rank's sum over the global count."""
    nll = -torch.log_softmax(logits, dim=-1).gather(
        -1, labels[..., None])[..., 0]
    w = (~keep_gt_mask.bool()).float()
    return (nll * w).sum() / dp.total(w.sum()).clamp_min(1.0)


def bce_logits_none(logit, label):
    """Binary cross-entropy with logits, per element."""
    return (logit.clamp_min(0) - logit * label
            + torch.log1p(torch.exp(-logit.abs())))


def bce_logits(logit, label, dp=LOCAL):
    """Binary cross-entropy with logits, mean reduction (over ranks: this
    rank's sum over the global batch)."""
    return bce_logits_none(logit, label).sum() / dp.batch(logit.shape[0])


def swap_halves(x, dp=LOCAL):
    """REL's negative control: the batch's two halves swapped (an odd batch
    rolls by one).  Over ranks, the global batch's: the partner of a row
    lives on another rank, and its gradient goes back there."""
    x = dp.exchange(x)
    b = x.shape[0]
    if b % 2 == 0:
        x = torch.cat([x[b // 2:], x[:b // 2]], dim=0)
    else:
        x = torch.roll(x, 1, dims=0)
    return dp.rows(x)


def bert_losses(core: BertCore, *, text, visual_tokens, target_tokens,
                target_tokens_warp=None, keep_gt_mask=None,
                not_fully_masked=None, rel=False, vid=False,
                rel_no_fully_masked=False, control_neg=None, dp=LOCAL):
    """(loss_msm, loss_rel, loss_vid), the JAX package's ``bert_losses``.

    keep_gt_mask [B, target_seq_len] bool: True keeps the ground-truth
    token visible.  target_tokens_warp: the VID negatives, tokenized.
    control_neg: text_neg ids for negvc, whose negative control is
    [REL] | text_neg | [ST1][VID] with the visual segment dropped.
    ``rel_no_fully_masked``: REL and VID weighted by not_fully_masked [B]
    (the samples whose MSM strategy kept some ground truth).  ``dp``: the
    data-parallel ranks (:mod:`parallel.mesh`); each returns its share of
    the global batch's losses (this rank's sums over the global counts),
    which sum over the ranks to the one-process losses at that batch."""
    cfg = core.cfg
    control_emb = core.control_embedding(text, visual_tokens)
    masked_target = torch.where(keep_gt_mask, target_tokens,
                                cfg.mask_token)
    target_emb = core.target_embedding(masked_target)
    logits_msm, logit_rel_pos, logit_vid_pos, _ = core.forward_full(
        control_emb, target_emb)
    loss_msm = cross_entropy_masked(logits_msm, target_tokens, keep_gt_mask,
                                    dp)

    b, dev = text.shape[0], logits_msm.device
    ones = torch.ones((b,), device=dev)
    zeros = torch.zeros((b,), device=dev)
    zero = torch.zeros((), device=dev)
    if rel:
        if control_neg is not None:
            control_neg_emb = core.control_embedding(control_neg, None,
                                                     drop_visual=True)
        else:
            control_neg_emb = swap_halves(control_emb, dp)
        logit_rel_neg = core.forward_rel_logit(control_neg_emb, target_emb)
        if rel_no_fully_masked:
            nfm = not_fully_masked.float()
            loss_rel = (((bce_logits_none(logit_rel_pos, ones)
                          + bce_logits_none(logit_rel_neg, zeros)) * nfm
                         ).sum() / dp.total(nfm.sum()).clamp_min(1.0))
        else:
            loss_rel = (bce_logits(logit_rel_pos, ones, dp)
                        + bce_logits(logit_rel_neg, zeros, dp))
    else:
        loss_rel = zero

    if vid and cfg.num_targets > 1 and target_tokens_warp is not None:
        warp_masked = torch.where(keep_gt_mask, target_tokens_warp,
                                  cfg.mask_token)
        _, _, logit_vid_neg, _ = core.forward_full(
            control_emb, core.target_embedding(warp_masked))
        if rel_no_fully_masked:
            # as in the JAX package: the sums over the whole batch, each
            # divided by the count of not-fully-masked samples
            nfm_sum = dp.total(not_fully_masked.float().sum()).clamp_min(
                1.0)
            loss_vid = (bce_logits_none(logit_vid_pos, ones).sum() / nfm_sum
                        + bce_logits_none(logit_vid_neg, zeros).sum()
                        / nfm_sum)
        else:
            loss_vid = (bce_logits(logit_vid_pos, ones, dp)
                        + bce_logits(logit_vid_neg, zeros, dp))
    else:
        loss_vid = zero
    return loss_msm, loss_rel, loss_vid
