"""Batched mask-predict (PNAG) sampler in PyTorch.

Counterpart of ``mmvid_tpu/models/sampler.py``.  The whole batch advances
together: each round re-masks the lowest-confidence tokens, runs one
batched transformer forward (beams folded J-major into the batch) and
resamples the re-masked slots.  ``lax.while_loop`` becomes a Python loop.

* Confidence-weighted re-masking without replacement is Gumbel top-k over
  log Y; preserved slots are pinned to +inf so they always stay.  The sort
  is stable, so tied scores keep the lowest index first, as JAX does.
* ``dynamic=False`` never reads the device from the host inside the loop.
  ``dynamic=True`` reads one bool per round for the stop test.
* On a CUDA tensor each round's sampling is the fused sample-head kernel
  (``ops/sample_head.py``); ``spec.deterministic`` (a test hook) samples
  by argmax from the full logits instead, as JAX does.
* ``mask_predict_trace`` (the PNAG debug grid) runs the same rounds at one
  beam without the dynamic stop and keeps every round's tokens and keep
  mask.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mmvid_tpu_torch.ops.sample_head import (fused_sample_head,
                                             prepare_head_weight)
from mmvid_tpu_torch.ops.sample_head import gumbel as _gumbel


def make_schedules(mp_config: Dict, N: int, steps: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, int]:
    """n(t) re-mask counts and temp(t) schedules."""
    Tmax = mp_config['T'] if steps <= 0 else steps
    N3_n = max(1, int(N * mp_config['N3_n']))
    N4_n = max(1, int(N * mp_config['N4_n']))
    n = (list(N * np.linspace(mp_config['N1_n'], mp_config['N2_n'],
                              mp_config['T1_n']))
         + list(N3_n * np.ones(mp_config['T2_n']))
         + list(N4_n * np.ones(mp_config['T3_n'])))
    temp = (list(np.linspace(mp_config['N1_t'], mp_config['N2_t'],
                             mp_config['T1_t']))
            + list(mp_config['N3_t'] * np.ones(mp_config['T2_t']))
            + list(mp_config['N4_t'] * np.ones(mp_config['T3_t'])))
    n = np.asarray(list(map(int, n)), np.int32)
    temp = np.asarray(temp, np.float32)
    if len(n) < Tmax:
        n = np.concatenate([n, np.full(Tmax - len(n), n[-1], np.int32)])
    if len(temp) < Tmax:
        temp = np.concatenate(
            [temp, np.full(Tmax - len(temp), temp[-1], np.float32)])
    return n[:Tmax], temp[:Tmax], Tmax


def preserve_layout(cfg, long_mode: str, t_overlap: int,
                    has_preserve: bool):
    """Static (preserve_mask [N_total] bool, N re-maskable count)."""
    n_tok = cfg.image_seq_len
    total = cfg.target_seq_len
    if long_mode == 'long':
        if not has_preserve:
            t_overlap = 0
        N = total - n_tok * t_overlap
        mask = np.zeros(total, bool)
        if has_preserve:
            mask[:n_tok * t_overlap] = True
    elif long_mode in ('interp', 'interp2', 'interp_real'):
        N = total // 2
        mask = np.zeros((cfg.num_targets, n_tok), bool)
        if has_preserve:
            mask[::2, :] = True
        mask = mask.reshape(-1)
    else:
        N = total
        mask = np.zeros(total, bool)
    return mask, N


def arrange_preserve_tokens(cfg, preserve, long_mode: str, t_overlap: int):
    """Place given tokens [B, target_seq_len] into the preserved slots of
    the target grid; everything else is [MASK]."""
    n_tok = cfg.image_seq_len
    b = preserve.shape[0]
    out = torch.full((b, cfg.target_seq_len), cfg.mask_token,
                     dtype=torch.long, device=preserve.device)
    if long_mode == 'long':
        k = n_tok * t_overlap
        out[:, :k] = preserve[:, -k:]
    elif long_mode in ('interp', 'interp2', 'interp_real'):
        t = cfg.num_targets
        src = preserve.reshape(b, t, n_tok)[:, :t // 2]
        grid = out.view(b, t, n_tok)
        grid[:, ::2, :] = src
    return out


def _sample_argmax(logits):
    """Deterministic stand-in for the multinomial draw: token =
    argmax(logits), Y = its softmax probability."""
    tok = torch.argmax(logits, dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    chosen = torch.gather(logits, -1, tok[..., None])[..., 0]
    return torch.exp(chosen - lse), tok


def _sample_multinomial(logits, temperature, generator):
    """Gumbel-noised categorical: (Y = prob of the chosen token under the
    noised softmax, tokens)."""
    noised = logits + temperature * _gumbel(logits.shape, generator,
                                            logits.device)
    tok = torch.argmax(noised + _gumbel(noised.shape, generator,
                                        logits.device), dim=-1)
    lse = torch.logsumexp(noised, dim=-1)
    chosen = torch.gather(noised, -1, tok[..., None])[..., 0]
    return torch.exp(chosen - lse), tok


@dataclasses.dataclass(frozen=True)
class MaskPredictSpec:
    """Static sampler spec."""
    n_sched: tuple
    temp_sched: tuple
    Tmax: int
    beams: int
    dynamic: bool
    patience: int = 5  # dynamic stop horizon
    # Testing hook: argmax sampling and keeping the highest-confidence
    # tokens, so trajectories compare step for step with the JAX package.
    deterministic: bool = False


def build_spec(mp_config: Dict, N: int, steps: int = 0,
               dynamic: bool = True) -> MaskPredictSpec:
    n, temp, Tmax = make_schedules(mp_config, N, steps)
    return MaskPredictSpec(tuple(n.tolist()), tuple(temp.tolist()), Tmax,
                           int(mp_config.get('B', 1)), dynamic)


def chain_beam_updates(Y, I_tok, keep_all, Y_new_all, I_new_all, S_all):
    """Sequential beam chaining + best-beam selection: beam j's update
    composes on beam j-1's chained state; the returned state is the chained
    value AT the highest-scoring beam.

    Y, I_tok: [b, N]; keep_all / Y_new_all / I_new_all: [J, b, N];
    S_all: [J, b].  Returns (S_best [b], Y_best [b, N], I_best [b, N])."""
    Ys, Is = [], []
    for keep_j, Yn, In in zip(keep_all, Y_new_all, I_new_all):
        Y = torch.where(keep_j, Y, Yn)
        I_tok = torch.where(keep_j, I_tok, In)
        Ys.append(Y)
        Is.append(I_tok)
    jbest = torch.argmax(S_all, dim=0)
    bidx = torch.arange(Y.shape[0], device=Y.device)
    return (S_all[jbest, bidx], torch.stack(Ys)[jbest, bidx],
            torch.stack(Is)[jbest, bidx])


@torch.no_grad()
def mask_predict(core, control_emb, generator, spec: MaskPredictSpec,
                 preserve_mask: np.ndarray,
                 preserve_tokens: Optional[torch.Tensor] = None,
                 trace: Optional[List] = None):
    """Run batched mask-predict.

    core: BertCore; control_emb [B, C, D]; generator: torch.Generator on
    control_emb's device; preserve_mask [N_total] static bool;
    preserve_tokens [B, N_total] (read where preserve_mask is True).
    ``trace``: a list that gets (tokens [B, N_total], keep mask [B,
    N_total]) after the first pass and after each round (one beam, no
    dynamic stop: :func:`mask_predict_trace`).
    Returns tokens [B, N_total] int64.
    """
    cfg = core.cfg
    dev = control_emb.device
    b = control_emb.shape[0]
    n_total = cfg.target_seq_len
    pmask = torch.as_tensor(preserve_mask, device=dev)
    n_pres = int(preserve_mask.sum())
    N = n_total - n_pres
    if preserve_tokens is None:
        preserve_tokens = torch.full((b, n_total), cfg.mask_token,
                                     dtype=torch.long, device=dev)
    ln, fc = core.to_logits
    # W in the compute dtype (a training build holds it in fp32), the bias
    # in fp32, as JAX's sampler passes them
    w_head = (fc.weight.to(core.dtype).t().contiguous()
              if not spec.deterministic else None)
    b_head = fc.bias.float() if not spec.deterministic else None
    # W as the split-TF32 kernel reads it (an fp32 W's TF32 split), made
    # once for the rounds
    w_prepared = (prepare_head_weight(w_head) if not spec.deterministic
                  else None)

    def forward(tokens, remask):
        """tokens / remask [B', N], B' = J*b (beams folded J-major);
        returns (head_in, rel, vid): head_in is the MSM logits under
        spec.deterministic, else the raw hidden rows."""
        tok_in = torch.where(remask, cfg.mask_token, tokens)
        target_emb = core.target_embedding(tok_in)
        reps = tok_in.shape[0] // b
        ctrl = control_emb if reps == 1 else control_emb.repeat(reps, 1, 1)
        if spec.deterministic:
            logits, rel, vid, _ = core.forward_full(ctrl, target_emb)
            return logits, rel, vid
        return core.forward_hidden(ctrl, target_emb)

    def sample(head_in, temp):
        if spec.deterministic:
            return _sample_argmax(head_in)
        bp, n, d = head_in.shape
        y, tok = fused_sample_head(head_in.reshape(bp * n, d), ln.weight,
                                   ln.bias, w_head, b_head, temp, generator,
                                   w_prepared=w_prepared)
        return y.view(bp, n), tok.view(bp, n)

    # initial step: everything except the preserved slots is masked
    init_tokens = torch.where(pmask[None], preserve_tokens, cfg.mask_token)
    head_in, _, _ = forward(init_tokens, (~pmask)[None].expand(b, -1))
    Y, I_new = sample(head_in, spec.temp_sched[0])
    I_tok = torch.where(pmask[None], preserve_tokens, I_new)
    # preserved slots never resample: pin their confidence high
    Y = torch.where(pmask[None], torch.inf, Y)
    if trace is not None:
        trace.append((I_tok, pmask[None].expand(b, -1)))

    def beams_round(Y, I_tok, t):
        J = spec.beams
        keep_n = N - spec.n_sched[t - 1] + n_pres   # tokens kept this round
        scores = torch.log(Y.clamp_min(1e-30))[None]
        if spec.deterministic:
            scores = scores.expand((J,) + Y.shape)
        else:
            scores = scores + _gumbel((J,) + Y.shape, generator, dev)
        scores = torch.where(pmask, torch.inf, scores)
        # keep the keep_n best-ranked slots (stable: ties keep low indices)
        order = torch.argsort(-scores, dim=-1, stable=True)
        keep_all = torch.zeros_like(scores, dtype=torch.bool)
        keep_all.scatter_(-1, order[..., :keep_n], True)
        keep_all |= pmask

        head_in, rel, vid = forward(
            I_tok[None].expand((J,) + I_tok.shape).reshape(J * b, -1),
            (~keep_all).reshape(J * b, -1))
        Y_new, I_new = sample(head_in, spec.temp_sched[t])
        S_all = ((torch.sigmoid(rel) + torch.sigmoid(vid)) * 0.5
                 ).reshape(J, b)
        return keep_all, chain_beam_updates(
            Y, I_tok, keep_all, Y_new.reshape(J, b, -1),
            I_new.reshape(J, b, -1), S_all)

    Smax = torch.zeros((b,), dtype=torch.float32, device=dev)
    tmax = torch.zeros((b,), dtype=torch.long, device=dev)
    Imax = I_tok
    for t in range(1, spec.Tmax):
        if spec.dynamic:
            # step t runs iff some lane's t - tmax <= patience
            active = (t - tmax) <= spec.patience
            if not bool(active.any()):
                break
        keep_all, (S_best, Y_best, I_best) = beams_round(Y, I_tok, t)
        if spec.dynamic:
            Y = torch.where(active[:, None], Y_best, Y)
            I_tok = torch.where(active[:, None], I_best, I_tok)
            improved = (S_best > Smax) & active
            Smax = torch.where(improved, S_best, Smax)
            tmax = torch.where(improved, t, tmax)
            Imax = torch.where(improved[:, None], I_tok, Imax)
        else:
            Y, I_tok = Y_best, I_best
        if trace is not None:
            trace.append((I_tok, keep_all[0]))
    return Imax if spec.dynamic else I_tok


def mask_predict_trace(core, control_emb, generator, spec: MaskPredictSpec,
                       preserve_mask: np.ndarray,
                       preserve_tokens: Optional[torch.Tensor] = None):
    """:func:`mask_predict` at one beam, every round run (no dynamic
    stop), for the PNAG debug grid: returns (tokens_per_step [S, B, N],
    keep_masks_per_step [S, B, N] bool, final tokens [B, N]), S =
    ``spec.Tmax``; step 0's keep mask is the preserve mask, a False marks
    a slot that round re-masked."""
    steps = []
    final = mask_predict(core, control_emb, generator,
                         dataclasses.replace(spec, beams=1, dynamic=False),
                         preserve_mask, preserve_tokens, trace=steps)
    return (torch.stack([tok for tok, _ in steps]),
            torch.stack([keep for _, keep in steps]), final)
