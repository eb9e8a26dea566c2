"""ART-V, the autoregressive baseline, in PyTorch, with its KV-cached
sampler.

Counterpart of ``mmvid_tpu/models/artv.py``: config, embeddings, the
causal training forward, ``logits_block_mask``, the training loss
(``artv_loss``: the weighted segment cross-entropy), ``ar_sample`` and the
``ArtvModel`` wrapper.

Sequence: <bos>+text (text_seq_len+1) | visual (num_visuals*n) | target
(num_targets*n) under a causal mask, with disjoint vocabulary ranges (text
with its per-position padding ids, visual with its pad ids, image).

Submodule names are the reference ``dalle.pt`` names (``text_emb``,
``image_pos_emb.weights_{i}``, ``visual_pos_emb.module_list.{i}``,
``transformer.transformer.resblocks.{i}``, ``to_logits.{0,1}`` ...).
``special_emb`` and ``estimation_pos_emb`` are the reference's too; no
forward reads them, so the JAX package never creates their params and
:data:`ArtvModel.optional_keys` lets a JAX param tree load without them.

``ar_sample`` encodes the control prefix once (the prefill, plain torch),
then decodes one token per step against per-layer K/V caches that grow
per frame (``MMVID_ARTV_WINDOW``, default on).  The step runs as one call
of :func:`mmvid_tpu_torch.ops.artv_decode.decode_token_step` over stacked
[n_layers, B, W, D] caches (the CUDA kernel) on the card, and as plain
torch ops over per-layer [B, W, D] caches (the JAX package's default
layout) on the CPU; ``MMVID_ARTV_FUSED=1`` or ``=0`` chooses the stacked
or the per-layer step on any device (:func:`fused_decode`).  Both flags
are read at every call.  Products take bf16 (the compute dtype) operands with
fp32 sums and outputs, as the JAX package's ``preferred_element_type``
does: the plain ops multiply fp32 copies of the rounded operands.

``MMVID_ARTV_SPEC=k`` (read at every call, as in JAX) sends a call without
``int8`` to the exact speculative decode of ``models/artv_spec.py``.

``ar_sample(..., int8=True)`` is the JAX package's int8 decode (serving,
beyond the reference): the blocks' and the head's weights quantized per
output channel (``quant_weight``), every product of the step an int8
product with one dynamic activation scale over the whole [B, D] input
(``dot8``: x is divided by its scale), and the K/V caches stored int8 with
per-(layer, head) scales at 1.5x the prefill's range, unless
``MMVID_ARTV_INT8_WEIGHTS_ONLY=1`` keeps them in the compute dtype.  As in
JAX, no kernel runs there (``fused = not int8``): the per-layer step in
plain torch ops on every device, the weight products through
``ops.int8.int_mm``, the per-head int8 attention products as fp32 products
of integer-valued tensors (exact: D * 127^2 and W * 127^2 stay below
2^24), with TF32 off.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmvid_tpu_torch.models.axial import (
    AxialPositionalEmbedding,
    AxialPositionalEmbeddingList,
)
from mmvid_tpu_torch.models.clip import (
    NEG_INF,
    ClipStackConfig,
    TransformerStack,
    attention_mask,
    layer_norm_fp32,
    linear,
)
from mmvid_tpu_torch.models.vqgan import VQGanVAE
from mmvid_tpu_torch.ops import int8 as int8_ops
from mmvid_tpu_torch.ops.artv_decode import (
    DecodeWorkspace,
    decode_token_step,
    stack_decode_params,
)
from mmvid_tpu_torch.ops.precision import fp32_exact
from mmvid_tpu_torch.ops.sample_head import gumbel
from mmvid_tpu_torch.parallel.mesh import LOCAL


@dataclasses.dataclass(frozen=True)
class ArtvConfig:
    dim: int = 768
    num_text_tokens: int = 10000      # raw; padding ids appended
    text_seq_len: int = 50
    num_visuals: int = 1
    num_targets: int = 8
    num_image_tokens: int = 1024
    image_fmap_size: int = 8
    image_size: int = 128
    loss_img_weight: float = 7.0
    loss_vis_weight: float = 1.0
    stable: bool = False
    clip: ClipStackConfig = ClipStackConfig()

    @property
    def image_seq_len(self) -> int:
        return self.image_fmap_size ** 2

    @property
    def visual_seq_len(self) -> int:
        return self.num_visuals * self.image_seq_len

    @property
    def target_seq_len(self) -> int:
        return self.num_targets * self.image_seq_len

    @property
    def effective_num_text_tokens(self) -> int:
        return self.num_text_tokens + self.text_seq_len

    @property
    def num_visual_tokens(self) -> int:
        return self.num_image_tokens + self.visual_seq_len

    @property
    def num_control_tokens(self) -> int:
        return self.effective_num_text_tokens + self.num_visual_tokens

    @property
    def total_tokens(self) -> int:
        return self.num_control_tokens + self.num_image_tokens

    @property
    def control_seq_len(self) -> int:
        return self.text_seq_len + self.visual_seq_len

    @property
    def total_seq_len(self) -> int:
        # <bos>+text gives text_seq_len+1 embeddings and the last target
        # token is never fed, so the transformer sees this many positions
        return self.text_seq_len + self.visual_seq_len + self.target_seq_len


class ArtvCore(nn.Module):
    """All learned parameters of ART-V plus the causal training forward.
    ``dtype`` is the compute dtype, ``param_dtype`` the dense layers'
    parameters' (``dtype`` unless given)."""

    def __init__(self, cfg: ArtvConfig, dtype=torch.float32,
                 param_dtype=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        param_dtype = param_dtype or dtype
        d, f = cfg.dim, cfg.image_fmap_size
        self.text_emb = nn.Embedding(cfg.effective_num_text_tokens, d)
        self.image_emb = nn.Embedding(cfg.num_image_tokens, d)
        self.text_pos_emb = nn.Embedding(cfg.text_seq_len + 1, d)  # +<bos>
        self.image_pos_emb = AxialPositionalEmbedding(
            d, (f, f) if cfg.num_targets == 1 else (cfg.num_targets, f, f))
        if cfg.num_visuals > 0:
            self.visual_emb = nn.Embedding(cfg.num_visual_tokens, d)
            self.visual_pos_emb = AxialPositionalEmbeddingList(
                d, cfg.num_visuals, (f, f))
        self.special_emb = nn.Embedding(4, d)
        self.estimation_pos_emb = nn.Embedding(2, d)
        self.transformer = nn.ModuleDict(
            {'transformer': TransformerStack(cfg.clip, dtype=dtype,
                                             param_dtype=param_dtype)})
        self.to_logits = nn.Sequential(
            nn.LayerNorm(d, eps=1e-5),
            nn.Linear(d, cfg.total_tokens, dtype=param_dtype))

    def control_tokens_embedding(self, text, visual_tokens=None):
        """<bos>+text+visual embeddings [B, 1+text+visual, D] fp32.  text
        [B, text_seq_len] raw ids (0 = padding); visual_tokens
        [B, visual_seq_len] image-codebook ids, -1 (or None) for absent."""
        cfg = self.cfg
        b, dev = text.shape[0], text.device
        text_range = (torch.arange(cfg.text_seq_len, device=dev)
                      + (cfg.effective_num_text_tokens - cfg.text_seq_len))
        text = torch.where(text == 0, text_range[None], text)
        text = torch.cat([text.new_zeros((b, 1)), text], dim=1)  # <bos>=0
        parts = [self.text_emb(text) + self.text_pos_emb.weight[None]]
        if cfg.num_visuals > 0:
            if visual_tokens is None:
                visual_tokens = torch.full((b, cfg.visual_seq_len), -1,
                                           dtype=torch.long, device=dev)
            visual_range = (torch.arange(cfg.visual_seq_len, device=dev)
                            + (cfg.num_visual_tokens - cfg.visual_seq_len))
            visual_tokens = torch.where(visual_tokens == -1,
                                        visual_range[None], visual_tokens)
            emb = self.visual_emb(visual_tokens)
            parts.append(emb + self.visual_pos_emb(emb))
        return torch.cat([p.float() for p in parts], dim=1)

    def target_embedding(self, image_tokens):
        emb = self.image_emb(image_tokens)
        return emb + self.image_pos_emb(emb)

    def logits(self, h):
        """to_logits: fp32 LayerNorm, then the head in the compute dtype,
        fp32 out."""
        head = self.to_logits
        return linear(head[1], layer_norm_fp32(head[0], h, self.dtype)
                      ).float()

    def forward(self, text, visual_tokens, image_tokens):
        """Training forward -> logits [B, total_seq_len, total_tokens]
        (causal; the last target position is dropped)."""
        cfg = self.cfg
        tokens = torch.cat([self.control_tokens_embedding(text,
                                                          visual_tokens),
                            self.target_embedding(image_tokens).float()],
                           dim=1)[:, :-1]
        mask = attention_mask(cfg.total_seq_len, 'causal',
                              device=tokens.device)
        out = self.transformer['transformer'](tokens, mask)
        if cfg.stable:
            out = out / out.amax(dim=-1, keepdim=True)
        return self.logits(out)


def logits_block_mask(cfg: ArtvConfig) -> np.ndarray:
    """[total_seq_len, total_tokens] bool, True = forbidden: each segment
    predicts only its own vocabulary range."""
    m = np.ones((cfg.total_seq_len, cfg.total_tokens), bool)
    t, v = cfg.text_seq_len, cfg.visual_seq_len
    m[:t, :cfg.effective_num_text_tokens] = False
    m[t:t + v, cfg.effective_num_text_tokens:cfg.num_control_tokens] = False
    m[t + v:, cfg.num_control_tokens:] = False
    return m


@functools.lru_cache(maxsize=8)
def _block_mask(cfg: ArtvConfig, device) -> torch.Tensor:
    """:func:`logits_block_mask` on ``device``, made once (it is [626,
    51570] at full width)."""
    return torch.as_tensor(logits_block_mask(cfg), device=device)


def artv_loss(core: ArtvCore, text, visual_tokens, image_tokens, dp=LOCAL):
    """(loss, 0, 0): the weighted segment cross-entropy of the causal
    forward, text + loss_vis_weight * visual + loss_img_weight * image
    over their sum, each segment's logits restricted to its vocabulary
    range (:func:`logits_block_mask`).  text [B, text_seq_len] raw ids
    (0 = padding), visual_tokens [B, visual_seq_len] (-1 = absent),
    image_tokens [B, target_seq_len].  Over data-parallel ranks (``dp``)
    each segment's mean is this rank's sum over the global count."""
    cfg = core.cfg
    dev = text.device
    logits = core(text, visual_tokens, image_tokens)
    logits = logits.masked_fill(_block_mask(cfg, dev)[None], float('-inf'))
    # labels: text (without <bos>) | visual + text offset | image + the
    # control offset, padding and absent ids remapped as the embeddings do
    text_range = (torch.arange(cfg.text_seq_len, device=dev)
                  + (cfg.effective_num_text_tokens - cfg.text_seq_len))
    labels = [torch.where(text == 0, text_range[None], text)]
    if cfg.num_visuals > 0:
        visual_range = (torch.arange(cfg.visual_seq_len, device=dev)
                        + (cfg.num_visual_tokens - cfg.visual_seq_len))
        labels.append(torch.where(visual_tokens == -1, visual_range[None],
                                  visual_tokens)
                      + cfg.effective_num_text_tokens)
    labels.append(image_tokens + cfg.num_control_tokens)
    labels = torch.cat(labels, dim=1)
    nll = -torch.log_softmax(logits, dim=-1).gather(
        -1, labels[..., None])[..., 0]
    t, c = cfg.text_seq_len, cfg.control_seq_len
    n = dp.batch(nll.shape[0])

    def mean(seg):
        return seg.sum() / (n * seg.shape[1])

    zero = torch.zeros((), device=dev)
    loss_vis = mean(nll[:, t:c]) if cfg.num_visuals > 0 else zero
    loss = (mean(nll[:, :t]) + cfg.loss_vis_weight * loss_vis
            + cfg.loss_img_weight * mean(nll[:, c:])) / (
                cfg.loss_img_weight + cfg.loss_vis_weight + 1.0)
    return loss, zero, zero


# ---------------------------------------------------------------------------
# KV-cached autoregressive sampling
# ---------------------------------------------------------------------------

def _dense(x, w32t, b32, dt):
    """x rounded to the compute dtype, times the fp32 copy of a rounded
    weight [in, out], fp32 sums, plus the fp32 bias."""
    return torch.addmm(b32, x.to(dt).float().flatten(0, -2), w32t
                       ).view(*x.shape[:-1], -1)


def _ln(x, ln: nn.LayerNorm):
    return F.layer_norm(x, ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps)


def _block_params(block):
    """One resblock's decode operands, cast once per call: the weights
    rounded to the compute dtype (JAX's ``cast_block``; a no-op on a
    serving build's), then as fp32 copies [in, out]; fp32 biases."""
    dt = block.dtype

    def lin(w, b):
        return w.to(dt).float().t(), b.float()
    return {'ln_1': block.ln_1, 'ln_2': block.ln_2,
            'qkv': lin(block.attn.in_proj_weight, block.attn.in_proj_bias),
            'out': lin(block.attn.out_proj.weight, block.attn.out_proj.bias),
            'fc': lin(block.mlp.c_fc.weight, block.mlp.c_fc.bias),
            'proj': lin(block.mlp.c_proj.weight, block.mlp.c_proj.bias)}


def _mlp_residual(p, x, dt):
    h = _dense(_ln(x, p['ln_2']), *p['fc'], dt)
    h = h * torch.sigmoid(1.702 * h)
    return x + _dense(h, *p['proj'], dt)


def _prefill_block(p, x, heads, dt):
    """The control prefix through one block (causal, plain torch) ->
    (x, k, v), k and v [B, lp, D] fp32."""
    b, lp, d = x.shape
    hd = d // heads
    q, k, v = _dense(_ln(x, p['ln_1']), *p['qkv'], dt).split(d, dim=-1)
    logits = torch.einsum('bqhd,bkhd->bhqk',
                          q.to(dt).float().view(b, lp, heads, hd),
                          k.to(dt).float().view(b, lp, heads, hd))
    logits = logits * (hd ** -0.5)
    causal = torch.ones((lp, lp), dtype=torch.bool, device=x.device).tril()
    logits = logits.masked_fill(~causal, NEG_INF)
    attn = torch.softmax(logits, dim=-1)
    o = torch.einsum('bhqk,bkhd->bqhd', attn.to(dt).float(),
                     v.to(dt).float().view(b, lp, heads, hd))
    x = x + _dense(o.reshape(b, lp, d), *p['out'], dt)
    return _mlp_residual(p, x, dt), k, v


def _decode_block(p, x, ck, cv, pos, invalid, heads, dt):
    """One token through one block over its own [B, W, D] caches, which
    take this token's k and v at ``pos`` (written in place)."""
    b, d = x.shape
    w, hd = ck.shape[1], d // heads
    q, k, v = _dense(_ln(x, p['ln_1']), *p['qkv'], dt).split(d, dim=-1)
    ck[:, pos] = k
    cv[:, pos] = v
    logits = torch.einsum('bhd,bwhd->bhw',
                          q.to(dt).float().view(b, heads, hd),
                          ck.float().view(b, w, heads, hd))
    logits = (logits * (hd ** -0.5)).masked_fill(invalid, NEG_INF)
    attn = torch.softmax(logits, dim=-1)
    o = torch.einsum('bhw,bwhd->bhd', attn.to(dt).float(),
                     cv.float().view(b, w, heads, hd)).reshape(b, d)
    return _mlp_residual(p, x + _dense(o, *p['out'], dt), dt)


def _quant_weight(weight):
    """JAX ar_sample's ``quant_weight`` of a torch-layout weight [out, in]:
    (int8 [out, in], fp32 per-output-channel scales max(max|W|, 1e-8) /
    127; ops.int8's dense weights floor after dividing instead)."""
    w = weight.float()
    w_s = torch.clamp_min(w.abs().amax(dim=1), 1e-8) / 127.0
    return torch.round(w / w_s[:, None]).to(torch.int8), w_s


def _dot8(x, w_q, w_s, bias):
    """JAX ar_sample's ``dot8``: x [..., in] fp32 quantized with one
    dynamic scale over all of x (x divided by it), an int8 product, fp32
    out plus the fp32 bias."""
    a_s = torch.clamp_min(x.abs().amax(), 1e-6) / 127.0
    x_q = torch.round(x.float() / a_s).to(torch.int8)
    acc = int8_ops.int_mm(x_q.reshape(-1, x.shape[-1]), w_q)
    return (acc.float() * (a_s * w_s) + bias).view(*x.shape[:-1], -1)


def _block_params8(block):
    """One resblock's int8 decode operands: (int8 weight [out, in],
    scales, fp32 bias) per product."""
    def lin(w, b):
        return _quant_weight(w) + (b.float(),)
    return {'ln_1': block.ln_1, 'ln_2': block.ln_2,
            'qkv': lin(block.attn.in_proj_weight, block.attn.in_proj_bias),
            'out': lin(block.attn.out_proj.weight, block.attn.out_proj.bias),
            'fc': lin(block.mlp.c_fc.weight, block.mlp.c_fc.bias),
            'proj': lin(block.mlp.c_proj.weight, block.mlp.c_proj.bias)}


def _q8(vals, s):
    """[..., heads, hd] -> int8 on per-head scales s [heads] (clipped to
    +-127)."""
    return torch.round(torch.clamp(vals.float() / s[:, None], -127.0,
                                   127.0)).to(torch.int8)


def _cache_scales(pre):
    """[n_layers, heads] int8 cache scales: each head's abs-max over the
    prefill (floored at 1e-6), with 1.5x headroom for later tokens."""
    return torch.stack([torch.clamp_min(t.abs().amax(dim=(0, 1, 3)), 1e-6)
                        for t in pre]) * 1.5 / 127.0


def _decode_block8(p, x, ck, cv, pos, invalid, heads, dt, kv_scales):
    """JAX ar_sample's ``block_step8``: one token through one block with
    int8 weight products, over its own [B, W, D] caches (int8 with
    ``kv_scales`` (k_s, v_s) [heads], else in the compute dtype)."""
    b, d = x.shape
    w, hd = ck.shape[1], d // heads
    q, k, v = _dot8(_ln(x, p['ln_1']), *p['qkv']).split(d, dim=-1)
    q = q.view(b, heads, hd)
    if kv_scales is not None:
        k_s, v_s = kv_scales
        ck[:, pos] = _q8(k.view(b, heads, hd), k_s).view(b, d)
        cv[:, pos] = _q8(v.view(b, heads, hd), v_s).view(b, d)
        q_s = torch.clamp_min(q.abs().amax(-1), 1e-6) / 127.0   # [b, heads]
        q_q = torch.round(q / q_s[..., None])
        acc = torch.einsum('bhd,bwhd->bhw', q_q,
                           ck.float().view(b, w, heads, hd))
        logits = (acc * (q_s[:, :, None] * k_s[None, :, None])
                  * (hd ** -0.5))
    else:
        ck[:, pos] = k
        cv[:, pos] = v
        logits = torch.einsum('bhd,bwhd->bhw', q.to(dt).float(),
                              ck.float().view(b, w, heads, hd)) * (hd ** -0.5)
    attn = torch.softmax(logits.masked_fill(invalid, NEG_INF), dim=-1)
    if kv_scales is not None:
        acc = torch.einsum('bhw,bwhd->bhd', torch.round(attn * 127.0),
                           cv.float().view(b, w, heads, hd))
        o = (acc * (v_s[None, :, None] / 127.0)).reshape(b, d)
    else:
        o = torch.einsum('bhw,bwhd->bhd', attn.to(dt).float(),
                         cv.float().view(b, w, heads, hd)).reshape(b, d)
    x = x + _dot8(o, *p['out'])
    h = _dot8(_ln(x, p['ln_2']), *p['fc'])
    h = h * torch.sigmoid(1.702 * h)
    return x + _dot8(h, *p['proj'])


def ar_prefill(core: ArtvCore, text, visual_tokens=None):
    """The control prefix (<bos>+text+visual) once through the stack:
    (hidden of its last position [B, D] fp32, per-layer k and v
    [B, ctrl_len, D] fp32)."""
    dt = core.dtype
    heads = core.cfg.clip.heads
    x = core.control_tokens_embedding(text, visual_tokens)
    pre_k, pre_v = [], []
    for block in core.transformer['transformer'].resblocks:
        x, k, v = _prefill_block(_block_params(block), x, heads, dt)
        pre_k.append(k)
        pre_v.append(v)
    return x[:, -1], pre_k, pre_v


def sample_tok(generator, logits, k_img: int, temperature: float):
    """Top-k filter (k_img of the image columns) then a categorical draw
    at ``temperature`` as Gumbel-argmax, noise from ``generator``."""
    if k_img < logits.shape[-1]:
        thresh = torch.topk(logits, k_img, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < thresh, float('-inf'))
    noise = gumbel(logits.shape, generator, logits.device)
    return torch.argmax(logits / temperature + noise, dim=-1)


def fused_decode(device) -> bool:
    """Whether ART-V's decode step runs stacked through
    ``decode_token_step`` on ``device``: ``MMVID_ARTV_FUSED=1`` yes, ``=0``
    no (the per-layer step), unset by the device: the kernel for CUDA, the
    per-layer step (the JAX package's default) elsewhere."""
    flag = os.environ.get('MMVID_ARTV_FUSED')
    if flag is None:
        return torch.device(device).type == 'cuda'
    if flag not in ('0', '1'):
        raise ValueError(f'MMVID_ARTV_FUSED={flag!r}: expected 0 or 1')
    return flag == '1'


def _grow(cache, width):
    """Zero-pad the cache's width axis (second to last) to ``width``."""
    return F.pad(cache, (0, 0, 0, width - cache.shape[-2]))


@torch.no_grad()
@fp32_exact()
def ar_sample(core: ArtvCore, text, visual_tokens, generator,
              filter_thres: float = 0.5, temperature: float = 1.0,
              int8: bool = False, return_steps: bool = False):
    """KV-cached sampling of all target tokens -> [B, target_seq_len]
    int64 in [0, num_image_tokens).  ``generator`` (on the model's device)
    draws each step's noise.  ``int8``: the int8 decode of the module
    docstring.  ``MMVID_ARTV_SPEC=k`` (read at every call, as in JAX)
    routes a call without ``int8`` to the exact speculative decode
    (``models/artv_spec.ar_sample_spec``).  ``return_steps`` also returns
    the forwards each lane ran [B] (target_seq_len - 1 here; the chunk
    count on the speculative path)."""
    spec_k = int(os.environ.get('MMVID_ARTV_SPEC', '0') or 0)
    if spec_k > 0 and not int8:
        from mmvid_tpu_torch.models.artv_spec import ar_sample_spec
        toks, steps = ar_sample_spec(core, text, visual_tokens, generator,
                                     spec_k, filter_thres=filter_thres,
                                     temperature=temperature)
        return (toks, steps) if return_steps else toks
    cfg = core.cfg
    heads, n_layers = cfg.clip.heads, cfg.clip.layers
    dt, dim = core.dtype, cfg.dim
    b = text.shape[0]
    L = cfg.total_seq_len
    ctrl_len = cfg.control_seq_len + 1  # +<bos>
    fused = fused_decode(text.device) and not int8
    int8_caches = int8 and os.environ.get(
        'MMVID_ARTV_INT8_WEIGHTS_ONLY') != '1'
    window = os.environ.get('MMVID_ARTV_WINDOW', '1') == '1'

    prefix_last, pre_k, pre_v = ar_prefill(core, text, visual_tokens)
    # per-token operands cast once per call
    pos_emb = core.image_pos_emb.embedding(cfg.target_seq_len).float()
    tok_emb = core.image_emb.weight.float()
    blocks = core.transformer['transformer'].resblocks
    workspace = None
    if fused:
        stacked = stack_decode_params(blocks)
        if text.device.type == 'cuda':   # checked and allocated once
            workspace = DecodeWorkspace(stacked, b, heads)
    elif int8:
        dec = [_block_params8(block) for block in blocks]
    else:
        dec = [_block_params(block) for block in blocks]

    # the head sliced once to the image columns: the others never survive
    # the sampler
    ln_head, fc = core.to_logits
    ln_w, ln_b = ln_head.weight.float(), ln_head.bias.float()
    fc_w = fc.weight[cfg.num_control_tokens:].to(dt).float().t()
    fc_b = fc.bias[cfg.num_control_tokens:].float()

    head8 = (_quant_weight(fc.weight[cfg.num_control_tokens:]) if int8
             else None)

    def image_logits(hidden):
        h = F.layer_norm(hidden, ln_head.normalized_shape, ln_w, ln_b,
                         ln_head.eps)
        if int8:
            return _dot8(h, *head8, fc_b)
        return _dense(h, fc_w, fc_b, dt)

    k_img = min(max(int((1 - filter_thres) * cfg.total_tokens), 1),
                cfg.num_image_tokens)
    n_steps = cfg.target_seq_len - 1
    seg_len = cfg.image_seq_len if window else n_steps
    w0 = min(ctrl_len + seg_len, L)
    kv_scales = [None] * n_layers
    if fused:   # stacked [n_layers, B, W, D]
        cache_k = _grow(torch.stack(pre_k).to(dt), w0)
        cache_v = _grow(torch.stack(pre_v).to(dt), w0)
    elif int8_caches:   # per-layer int8 [B, W, D], per-(layer, head) scales
        pre_k = [k.view(b, ctrl_len, heads, -1) for k in pre_k]
        pre_v = [v.view(b, ctrl_len, heads, -1) for v in pre_v]
        k_s, v_s = _cache_scales(pre_k), _cache_scales(pre_v)
        kv_scales = list(zip(k_s, v_s))
        cache_k = [_grow(_q8(k, s).view(b, ctrl_len, dim), w0)
                   for k, s in zip(pre_k, k_s)]
        cache_v = [_grow(_q8(v, s).view(b, ctrl_len, dim), w0)
                   for v, s in zip(pre_v, v_s)]
    else:       # per-layer [B, W, D]
        cache_k = [_grow(k.to(dt), w0) for k in pre_k]
        cache_v = [_grow(v.to(dt), w0) for v in pre_v]

    tok = sample_tok(generator, image_logits(prefix_last), k_img,
                     temperature)
    fed = []
    # token i is fed at step i (cache position ctrl_len + i) and token i+1
    # sampled; the last token is never fed.  The caches grow per segment.
    for start in range(0, n_steps, seg_len):
        stop = min(start + seg_len, n_steps)
        width = min(ctrl_len + stop, L)
        if fused:
            cache_k, cache_v = _grow(cache_k, width), _grow(cache_v, width)
        else:
            cache_k = [_grow(c, width) for c in cache_k]
            cache_v = [_grow(c, width) for c in cache_v]
        cols = torch.arange(width, device=text.device)
        for step_i in range(start, stop):
            pos = ctrl_len + step_i
            x = tok_emb[tok] + pos_emb[step_i]
            if fused:
                x, k_new, v_new = decode_token_step(x, stacked, cache_k,
                                                    cache_v, pos, heads,
                                                    workspace)
                # one write per token for all layers
                cache_k[:, :, pos] = k_new
                cache_v[:, :, pos] = v_new
            else:
                invalid = cols > pos
                for i in range(n_layers):
                    if int8:
                        x = _decode_block8(dec[i], x, cache_k[i], cache_v[i],
                                           pos, invalid, heads, dt,
                                           kv_scales[i])
                    else:
                        x = _decode_block(dec[i], x, cache_k[i], cache_v[i],
                                          pos, invalid, heads, dt)
            fed.append(tok)
            tok = sample_tok(generator, image_logits(x), k_img,
                             temperature)
    toks = torch.stack(fed + [tok], dim=1)
    if return_steps:
        return toks, torch.full((b,), n_steps, dtype=torch.long,
                                device=text.device)
    return toks


class ArtvModel(nn.Module):
    """Holds ``core`` (ArtvCore), ``vae`` and optionally ``cvae`` (which
    tokenizes visual control frames), with MMVIDBert's generation surface.

    ``core``'s submodules are registered on this module directly (the same
    objects), which makes ``state_dict()`` the reference ``dalle.pt``
    ``weights`` payload."""

    # reference names the JAX package has no params for (no forward reads
    # them): a JAX param tree loads without them
    optional_keys = ('special_emb.weight', 'estimation_pos_emb.weight')

    def __init__(self, cfg: ArtvConfig, vae: VQGanVAE,
                 cvae: VQGanVAE | None = None, dtype=torch.float32,
                 param_dtype=None):
        super().__init__()
        core = ArtvCore(cfg, dtype=dtype, param_dtype=param_dtype)
        for name, child in core.named_children():
            self.add_module(name, child)
        object.__setattr__(self, 'core', core)  # not a second registration
        self.vae = vae
        self.cvae = cvae
        self.cfg = cfg

    def _tokenizer(self, which_vae: str) -> VQGanVAE:
        if which_vae == 'cvae' and self.cvae is not None:
            return self.cvae
        return self.vae

    @torch.no_grad()
    def get_image_tokens(self, images, which_vae='vae'):
        """images [B, T, H, W, 3] (or [B, H, W, 3]) in [0, 1] -> ids
        [B, T*n] int64."""
        if images.dim() == 4:
            images = images[:, None]
        b, t = images.shape[:2]
        flat = images.reshape((b * t,) + images.shape[2:])
        return self._tokenizer(which_vae).get_codebook_indices(
            flat).reshape(b, -1)

    def visual_tokens(self, visual, batch: int, device=None):
        """Control frames [B, V, H, W, 3] (tokenized through the cvae),
        ids, or None (every visual position absent, -1)."""
        if visual is not None and visual.dim() >= 4:
            return self.get_image_tokens(visual, which_vae='cvae')
        if visual is not None:
            return visual
        return torch.full((batch, self.cfg.visual_seq_len), -1,
                          dtype=torch.long, device=device)

    def loss(self, generator, *, text, visual=None, target=None, dp=LOCAL,
             **unused):
        """(loss, 0, 0), :func:`artv_loss` on the tokenized control and
        targets (frames through the frozen VQGANs, or ids); the step's
        beta_msm scales it (1 in AR mode, as JAX's config forces).  The
        mask-predict keywords and ``generator`` are taken and unused;
        ``dp``: the data-parallel ranks, as :meth:`MMVIDBert.loss`."""
        b = text.shape[0]
        visual_tokens = self.visual_tokens(visual, b, text.device)
        if target.dim() >= 4:
            target = self.get_image_tokens(target)
        return artv_loss(self.core, text, visual_tokens, target, dp)

    @torch.no_grad()
    def prefill(self, text, visual=None):
        """The visual tokens and the control prefix through the stack (the
        first part of :meth:`generate_images`)."""
        return ar_prefill(self.core, text, self.visual_tokens(
            visual, text.shape[0], text.device))

    @torch.no_grad()
    def generate_images(self, generator, text, *, visual=None,
                        filter_thres=0.5, temperature=1.0, decode=True,
                        int8=False, spec_stats=False, **unused):
        """text [B, text_seq_len] int -> (videos [B, T, H, W, 3] in [0, 1]
        or None when ``decode`` is False, img_seq [B, T*n] int64), and with
        ``spec_stats`` a third, the forwards each lane ran [B]: with
        ``MMVID_ARTV_SPEC=k`` (target_seq_len - 1) / steps is the tokens a
        chunk (the speculation's gain), on the baseline path steps is
        target_seq_len - 1.  ``int8``: the int8 decode of ``ar_sample``.
        The mask-predict keywords (``mask_predict_steps``, ``dynamic``,
        ``mp_config``) are taken and ignored, so
        ``generate.generate_videos`` serves both models."""
        vtok = self.visual_tokens(visual, text.shape[0], text.device)
        seq, steps = ar_sample(self.core, text, vtok, generator,
                               filter_thres=filter_thres,
                               temperature=temperature, int8=int8,
                               return_steps=True)
        videos = self.decode_video(seq) if decode else None
        return (videos, seq, steps) if spec_stats else (videos, seq)

    @torch.no_grad()
    def decode_video(self, img_seq):
        cfg = self.cfg
        b = img_seq.shape[0]
        frames = img_seq.reshape(b * cfg.num_targets, cfg.image_seq_len)
        imgs = self.vae.decode(frames)
        return imgs.reshape((b, cfg.num_targets) + imgs.shape[1:])

    @torch.no_grad()
    def recon_images(self, images, which_vae='vae'):
        """Tokenize and decode (a round trip): any frame count ->
        [B, T, H, W, 3] in [0, 1]."""
        toks = self.get_image_tokens(images, which_vae)
        b = toks.shape[0]
        t = toks.shape[1] // self.cfg.image_seq_len
        imgs = self._tokenizer(which_vae).decode(
            toks.reshape(b * t, self.cfg.image_seq_len))
        return imgs.reshape((b, t) + imgs.shape[1:])
