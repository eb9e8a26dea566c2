"""Exact speculative multi-token decode for ART-V (``MMVID_ARTV_SPEC=k``).

Counterpart of ``mmvid_tpu/models/artv_spec.py::ar_sample_spec``:

* **Draft**: position p's draft is the same spatial token one frame
  earlier, ``out[p - seg]`` (``seg`` tokens a frame), or for frame 0 the
  visual-control token, clamped into the image vocabulary (zeros without
  one).  A draft costs no model evaluation.
* **Verify**: one chunk forward of m = k + 1 rows (the last committed
  token and k drafts) against the per-layer K/V caches replaces up to
  k + 1 single-token steps.  Row j of lane b sees cache positions <=
  base[b] + j.  Each row goes through the numerics of the per-layer step
  of :func:`mmvid_tpu_torch.models.artv.ar_sample` (operands rounded to
  the compute dtype, fp32 products, fp32 logits and softmax).
* **Exactness**: point-mass rejection sampling.  Draft i is accepted with
  probability p_i(d_i); at the first rejection the token is drawn from
  p with the draft masked out, and on full acceptance from the bonus row.
  That reproduces the model's distribution exactly, so greedy decoding
  gives ``ar_sample``'s tokens token for token.
* **Lanes in lockstep**: one loop for the batch, an ``active`` mask and a
  per-lane ``base``; a lane that has reached its segment's stop idles
  (commits nothing) until the others arrive.  The caches carry m spare
  rows past the live width W: an idle lane writes its chunk's K/V there,
  where no attention reads, so no committed row of a finished lane ever
  changes, with no host sync to find the active lanes.
* **Windowed segments** (``MMVID_SPEC_WINDOW``, default on, ``=0`` off):
  one segment a frame, each over caches of width ctrl_len + stop + k.
* ``MMVID_ARTV_SPEC_FORCE=1`` accepts every draft: a benchmark's ceiling,
  whose output is garbage by design (``generate.py`` refuses it without
  ``--bench_unsafe``).

Randomness comes from the explicit ``torch.Generator``, in a fixed order
each chunk: a uniform [B, k] for acceptance (none when forced), then one
Gumbel draw [B, V] for the categorical (Gumbel-argmax, as ``sample_tok``).
The loop's condition, any lane before its stop, is one host read a chunk:
the host waits for each chunk before it queues the next.

No kernel runs here, as in JAX (its chunk forward is XLA): the products
are torch matmuls.  ``MMVID_SPEC_SCATTER`` is JAX's TPU cache-write
strategy and changes no token; the port does not read it.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from mmvid_tpu_torch.models.artv import (
    ArtvCore,
    _block_params,
    _dense,
    _grow,
    _ln,
    _mlp_residual,
    ar_prefill,
)
from mmvid_tpu_torch.models.clip import NEG_INF
from mmvid_tpu_torch.ops.int8 import exact_fp32_products
from mmvid_tpu_torch.ops.sample_head import gumbel


def _chunk_block(p, x, ck, cv, lanes, rows_w, valid, heads, dt):
    """m rows of every lane through one block.  x [B, m, D] fp32; ck, cv
    [B, W + m, D] take the chunk's k and v at (``lanes`` [B, 1],
    ``rows_w`` [B, m]) (written in place); attention over the first W rows
    under ``valid`` [B, 1, m, W]."""
    b, m, d = x.shape
    w, hd = valid.shape[-1], d // heads
    q, k, v = _dense(_ln(x, p['ln_1']), *p['qkv'], dt).split(d, dim=-1)
    ck[lanes, rows_w] = k.to(ck.dtype)
    cv[lanes, rows_w] = v.to(cv.dtype)
    logits = torch.einsum('bmhd,bwhd->bhmw',
                          q.to(dt).float().view(b, m, heads, hd),
                          ck[:, :w].float().view(b, w, heads, hd))
    logits = (logits * (hd ** -0.5)).masked_fill(~valid, NEG_INF)
    attn = torch.softmax(logits, dim=-1)
    o = torch.einsum('bhmw,bwhd->bmhd', attn.to(dt).float(),
                     cv[:, :w].float().view(b, w, heads, hd))
    x = x + _dense(o.reshape(b, m, d), *p['out'], dt)
    return _mlp_residual(p, x, dt)


@torch.no_grad()
@exact_fp32_products()
def ar_sample_spec(core: ArtvCore, text, visual_tokens, generator,
                   spec_k: int, filter_thres: float = 0.5,
                   temperature: float = 1.0):
    """Speculative KV-cached sampling of all target tokens -> (tokens [B,
    target_seq_len] int64 in [0, num_image_tokens), steps [B] int64, the
    chunk forwards each lane ran: target_seq_len - 1 at no acceptance)."""
    cfg = core.cfg
    heads, n_layers = cfg.clip.heads, cfg.clip.layers
    dt = core.dtype
    b, dev = text.shape[0], text.device
    ctrl_len = cfg.control_seq_len + 1   # +<bos>
    seg = cfg.image_seq_len              # tokens a frame
    n_gen = cfg.target_seq_len
    k_spec = int(spec_k)
    if not 0 < k_spec <= seg:
        raise ValueError(f'spec_k={k_spec} must be in (0, tokens/frame='
                         f'{seg}]: drafts may only reference committed '
                         f'previous-frame tokens')
    force = os.environ.get('MMVID_ARTV_SPEC_FORCE') == '1'
    window = os.environ.get('MMVID_SPEC_WINDOW', '1') == '1'
    m = k_spec + 1                       # chunk rows: prev + k drafts

    prefix_last, pre_k, pre_v = ar_prefill(core, text, visual_tokens)
    pos_emb = core.image_pos_emb.embedding(n_gen).float()
    tok_emb = core.image_emb.weight.float()
    dec = [_block_params(blk) for blk in core.transformer['transformer']
           .resblocks]
    ln_head, fc = core.to_logits
    ln_w, ln_b = ln_head.weight.float(), ln_head.bias.float()
    fc_w = fc.weight[cfg.num_control_tokens:].float().t()
    fc_b = fc.bias[cfg.num_control_tokens:].float()
    k_img = min(max(int((1 - filter_thres) * cfg.total_tokens), 1),
                cfg.num_image_tokens)

    def filtered_logits(hidden):
        """[..., D] -> image logits [..., V], top-k filtered."""
        h = F.layer_norm(hidden, ln_head.normalized_shape, ln_w, ln_b,
                         ln_head.eps)
        logits = _dense(h, fc_w, fc_b, dt)
        if k_img < cfg.num_image_tokens:
            thresh = torch.topk(logits, k_img, dim=-1).values[..., -1:]
            logits = logits.masked_fill(logits < thresh, float('-inf'))
        return logits

    def draw(logits):
        """A categorical draw at ``temperature``: Gumbel-argmax."""
        noise = gumbel(logits.shape, generator, dev)
        return torch.argmax(logits / temperature + noise, dim=-1)

    if visual_tokens is not None and visual_tokens.shape[-1] >= seg:
        vis_draft = visual_tokens[:, :seg].long().clamp(
            0, cfg.num_image_tokens - 1)
    else:
        vis_draft = torch.zeros((b, seg), dtype=torch.long, device=dev)

    stops = ([min((f + 1) * seg, n_gen) for f in range(-(-n_gen // seg))]
             if window else [n_gen])

    def width(stop):
        # an active lane has pos <= stop - 1 and writes up to
        # base + k_spec = ctrl_len + pos - 1 + k_spec
        return ctrl_len + stop + k_spec

    # per-layer [B, W + m, D] caches, grown per segment; rows W .. W + m - 1
    # take idle lanes' writes
    cache_k = [k.to(dt) for k in pre_k]
    cache_v = [v.to(dt) for v in pre_v]

    tok0 = draw(filtered_logits(prefix_last))
    # out is padded by m so a chunk's commit never clamps its start
    out = torch.zeros((b, n_gen + m), dtype=torch.long, device=dev)
    out[:, 0] = tok0
    prev = tok0
    pos = torch.ones((b,), dtype=torch.long, device=dev)
    steps = torch.zeros((b,), dtype=torch.long, device=dev)
    lanes = torch.arange(b, device=dev)
    arange_m = torch.arange(m, device=dev)
    arange_k = torch.arange(k_spec, device=dev)
    out_cols = torch.arange(n_gen + m, device=dev)
    vocab = torch.arange(cfg.num_image_tokens, device=dev)

    for stop in stops:
        w = width(stop)
        cache_k = [_grow(c, w + m) for c in cache_k]
        cache_v = [_grow(c, w + m) for c in cache_v]
        cols = torch.arange(w, device=dev)
        while bool((pos < stop).any()):   # one host read a chunk
            active = pos < stop                                 # [B]
            base = ctrl_len + pos - 1                           # [B]
            # drafts for target positions pos .. pos + k - 1
            dpos = pos[:, None] + arange_k[None]                # [B, k]
            from_prev = out.gather(1, (dpos - seg).clamp(0, n_gen - 1))
            from_vis = vis_draft.gather(1, dpos.clamp(0, seg - 1))
            drafts = torch.where(dpos >= seg, from_prev, from_vis)
            toks = torch.cat([prev[:, None], drafts], dim=1)    # [B, m]
            rows = (pos[:, None] - 1 + arange_m[None]).clamp(0, n_gen - 1)
            x = tok_emb[toks] + pos_emb[rows]
            rows_w = torch.where(active[:, None], base[:, None] + arange_m,
                                 w + arange_m[None])
            valid = (cols[None, None, None, :]
                     <= (base[:, None] + arange_m[None])[:, None, :, None])
            for i in range(n_layers):
                x = _chunk_block(dec[i], x, cache_k[i], cache_v[i],
                                 lanes[:, None], rows_w, valid, heads, dt)
            logits = filtered_logits(x)                         # [B, m, V]

            # point-mass rejection: accept draft i with p_i(d_i); j is the
            # first rejection (k_spec if none)
            if force:
                acc = torch.ones((b, k_spec), dtype=torch.bool, device=dev)
            else:
                logp = torch.log_softmax(logits[:, :k_spec] / temperature,
                                         dim=-1)
                p_draft = logp.gather(2, drafts[..., None])[..., 0].exp()
                u = torch.rand((b, k_spec), generator=generator, device=dev)
                acc = u < p_draft
            rej = torch.cat([~acc, torch.ones((b, 1), dtype=torch.bool,
                                              device=dev)], dim=1)
            j = rej.to(torch.uint8).argmax(dim=1)               # [B]
            # the replacement: the draft masked out on a rejection, the
            # bonus row on full acceptance (logits row j either way)
            sel = logits[lanes, j]                              # [B, V]
            d_at_j = drafts[lanes, j.clamp(max=k_spec - 1)]
            res = sel.masked_fill(vocab[None] == d_at_j[:, None],
                                  float('-inf'))
            new_from = torch.where((j < k_spec)[:, None], res, sel)
            new_tok = draw(new_from)

            cand = torch.cat([drafts, torch.zeros((b, 1), dtype=torch.long,
                                                  device=dev)], dim=1)
            cand[lanes, j] = new_tok                            # j drafts + new
            ncommit = torch.where(active, torch.minimum(j + 1, n_gen - pos),
                                  torch.zeros_like(pos))
            rel = out_cols[None] - pos[:, None]
            in_out = (rel >= 0) & (rel < ncommit[:, None])
            out = torch.where(in_out, cand.gather(1, rel.clamp(0, m - 1)),
                              out)
            prev_new = cand.gather(1, (ncommit - 1).clamp_min(0)[:, None])
            prev = torch.where(active, prev_new[:, 0], prev)
            pos = pos + ncommit
            steps = steps + active.long()
    return out[:, :n_gen], steps
