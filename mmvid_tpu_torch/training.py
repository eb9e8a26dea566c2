"""The training step: optimizer, LR schedules, gradient clipping and the
MSM/REL/VID step, in PyTorch.

Counterpart of ``mmvid_tpu/training.py``, on one device or data-parallel
over ranks (``make_train_step(..., dp=)``, JAX's ``jit_train_step`` on a
``dp`` / ``dcn`` mesh; its ``tp`` and ``pp`` shardings and the pipelined
stack are not ported, ROADMAP.md A6).  The step computes the loss
``beta_msm * MSM + beta_rel * REL + beta_vid * VID`` (ART-V: its weighted
segment cross-entropy, with beta_msm 1 as JAX's config forces in AR
mode), its gradient with respect to the core's parameters (the VQGANs
stay frozen and tokenize inside the loss), and optax's update, written
out so every value is optax's:

* ``clip_by_global_norm``: g * max_norm / ||g|| where ||g|| >= max_norm
  (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
* ``adam``: ``optax.adam(sched)``, betas (0.9, 0.999), eps 1e-8; with
  weight decay it is L2, ``add_decayed_weights`` on the clipped gradient
  before the moments (torch's ``Adam(weight_decay=...)``); ``adamw``:
  betas (0.9, 0.95), decoupled decay added to Adam's direction;
* the schedule is read at the count before the increment, so warmuplr's
  first update has lr 0 (``torch.optim.lr_scheduler`` is one step ahead);
* ``reducelronplateau``: optax.contrib's ``reduce_on_plateau`` (factor
  0.5, patience 2, cooldown 5, rtol 1e-4, the losses averaged over
  ``lr_scheduler_every`` steps, min scale 1e-6 / lr), a scale on the
  update fed the step's loss.

Over ranks (``parallel.mesh.DataParallel``) each rank computes its share
of the global batch's losses (its sums over the global counts), the
gradients are summed in flat fp32 buckets after the backward, and the
metrics are summed too: every rank updates with the global loss's
gradient, feeds the plateau the global loss, and keeps parameters that
are bit-identical to the other ranks'.  DDP is not used: its reducer does
not serve ``torch.autograd.grad``, and it would average per-rank means.

The optimizer's state is a flat dict: the count as a host int
(``count``), so a step reads nothing back to the host, and tensors on
the parameters' device (``mu`` and ``nu`` by parameter name; the
plateau's six scalars).
``opt_state_leaves`` / ``opt_state_from_leaves`` turn it into numbered
leaves and back, bit for bit, for a resume.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mmvid_tpu_torch.parallel.mesh import LOCAL


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    optimizer: str = 'adam'           # adam | adamw
    lr_scheduler: str = 'warmuplr'    # warmuplr | warmupdecaylr | steplr |
    #                                   cosineannealinglr | reducelronplateau
    #                                   | none
    lr_scheduler_warmup: int = 5000
    lr_scheduler_step_size: int = 10000
    lr_scheduler_every: int = 1       # plateau check cadence
    total_steps: int = 200000
    weight_decay: float = 0.0
    clip_grad_norm: float = 1.0
    beta_msm: float = 7.0
    beta_rel: float = 0.5
    beta_vid: float = 0.5
    msm_strategy_prob: Tuple[float, ...] = (0.7, 0.1, 0.1, 0.1)
    msm_bernoulli_prob: Tuple[float, float] = (0.2, 0.2)
    vid_strategy_prob: Tuple[float, ...] = (0.25, 0.25, 0.25, 0.25)
    pc_prob: float = 0.0
    rel_no_fully_masked: bool = False
    negvc: bool = False
    rand_visual: bool = False
    fullvc: bool = False
    vc_mode: Optional[str] = None
    visual_aug_mode: Optional[str] = None
    dropout_vc: float = 0.1

    @property
    def rel(self) -> bool:
        return self.beta_rel > 0

    @property
    def vid(self) -> bool:
        return self.beta_vid > 0


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule."""
    frac = 1 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def make_lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """count -> lr as an fp32 value, optax's schedule of the JAX package at
    every count."""
    base = tc.learning_rate
    warm = max(tc.lr_scheduler_warmup, 1)
    if tc.lr_scheduler == 'warmuplr':
        # 0 -> lr over warmup, then constant
        def sched(count):
            return (_linear(0.0, base, warm, count) if count < warm
                    else base)
    elif tc.lr_scheduler == 'warmupdecaylr':
        decay = max(tc.total_steps - warm, 1)

        def sched(count):
            return (_linear(0.0, base, warm, count) if count < warm
                    else _linear(base, 0.0, decay, count - warm))
    elif tc.lr_scheduler == 'steplr':
        # halved every lr_scheduler_step_size steps (staircase)
        def sched(count):
            if count <= 0:
                return base
            return base * 0.5 ** math.floor(count
                                            / tc.lr_scheduler_step_size)
    elif tc.lr_scheduler == 'cosineannealinglr':
        def sched(count):
            c = min(count, tc.lr_scheduler_step_size)
            return base * 0.5 * (1 + math.cos(
                math.pi * c / tc.lr_scheduler_step_size))
    elif tc.lr_scheduler in ('reducelronplateau', 'none'):
        # reducelronplateau: a constant lr; the plateau's scale is applied
        # after it (Optimizer.update)
        def sched(count):
            return base
    else:
        raise ValueError(f'unknown lr_scheduler {tc.lr_scheduler!r}; '
                         'expected warmuplr|warmupdecaylr|steplr|'
                         'cosineannealinglr|reducelronplateau|none')
    return lambda count: float(np.float32(sched(int(count))))


# ReduceLROnPlateau's settings (the reference's torch ReduceLROnPlateau
# mode=min, factor 0.5, patience 2, cooldown 5, threshold 1e-4 rel)
PLATEAU = dict(factor=0.5, patience=2, cooldown=5, rtol=1e-4)
PLATEAU_FIELDS = ('scale', 'best_value', 'plateau_count', 'cooldown_count',
                  'count', 'avg_value')


class Optimizer:
    """optax's transform chain of the JAX package's ``make_optimizer``:
    clip, then Adam (with L2 or decoupled decay), the schedule, and the
    plateau's scale.  ``init(params)`` -> state; ``update(grads, state,
    params, value)`` -> (updates, state, the gradient's global norm before
    the clip), ``value`` being the step's loss (read by the plateau
    only)."""

    def __init__(self, tc: TrainConfig):
        if tc.optimizer not in ('adam', 'adamw'):
            raise ValueError(f'unknown optimizer {tc.optimizer!r}')
        self.tc = tc
        self.sched = make_lr_schedule(tc)
        self.b1, self.b2 = (0.9, 0.95) if tc.optimizer == 'adamw' else (
            0.9, 0.999)
        self.eps = 1e-8
        self.plateau = tc.lr_scheduler == 'reducelronplateau'

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        dev = next(iter(params.values())).device
        state = {'count': 0,
                 'mu': {n: torch.zeros_like(p) for n, p in params.items()},
                 'nu': {n: torch.zeros_like(p) for n, p in params.items()}}
        if self.plateau:
            f32 = dict(dtype=torch.float32, device=dev)
            i32 = dict(dtype=torch.int32, device=dev)
            state['plateau'] = {
                'scale': torch.ones((), **f32),
                'best_value': torch.full((), float('inf'), **f32),
                'plateau_count': torch.zeros((), **i32),
                'cooldown_count': torch.zeros((), **i32),
                'count': torch.zeros((), **i32),
                'avg_value': torch.zeros((), **f32)}
        return state

    @torch.no_grad()
    def update(self, grads, state, params, value=None):
        tc, names = self.tc, list(params)
        g = [grads[n] for n in names]
        p = [params[n] for n in names]
        # clip_by_global_norm, (t / norm) * max_norm where norm >= max_norm,
        # as two multi-tensor passes: t / 1 * 1 leaves t as it is
        norm = global_norm(g)
        clip = norm >= tc.clip_grad_norm
        g = torch._foreach_mul(
            torch._foreach_div(g, torch.where(clip, norm, 1.0)),
            torch.where(clip, tc.clip_grad_norm, 1.0))
        if tc.optimizer == 'adam' and tc.weight_decay > 0:
            g = torch._foreach_add(g, p, alpha=tc.weight_decay)   # L2
        mu = [state['mu'][n] for n in names]
        nu = [state['nu'][n] for n in names]
        # (1 - b) * g**order + b * moment
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                                torch._foreach_mul(mu, self.b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2),
            torch._foreach_mul(nu, self.b2))
        # the count is kept on the host, so the bias corrections (fp32, as
        # optax computes them) and the schedule, read at the count before
        # the increment, need no read-back
        count = state['count']
        c = np.float32(count + 1)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** c)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** c)
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        upd = torch._foreach_div(
            mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps))
        if tc.optimizer == 'adamw':
            upd = torch._foreach_add(upd, p, alpha=tc.weight_decay)
        upd = torch._foreach_mul(upd, -self.sched(count))
        new = {'count': count + 1,
               'mu': dict(zip(names, mu)), 'nu': dict(zip(names, nu))}
        if self.plateau:
            new['plateau'] = self._plateau(state['plateau'], value)
            upd = torch._foreach_mul(upd, new['plateau']['scale'])
        return dict(zip(names, upd)), new, norm

    def _plateau(self, st, value):
        """optax.contrib.reduce_on_plateau's update of its state."""
        pl, tc = PLATEAU, self.tc
        acc = max(tc.lr_scheduler_every, 1)
        min_scale = np.float32(1e-6 / tc.learning_rate)
        count = st['count'] + 1
        avg = (st['count'] * st['avg_value']
               + value.detach().float()) / count
        do = count == acc
        improved = avg < (1 - pl['rtol']) * st['best_value']
        best = torch.where(improved, avg, st['best_value'])
        plateau = torch.where(improved, 0, st['plateau_count'] + 1)
        cooling = st['cooldown_count'] > 0
        hit = plateau == pl['patience']
        new_plateau = torch.where(cooling, 0, torch.where(hit, 0, plateau))
        new_scale = torch.where(
            cooling, st['scale'],
            torch.clamp_min(torch.where(hit, st['scale'] * pl['factor'],
                                        st['scale']), float(min_scale)))
        new_cool = torch.where(cooling, st['cooldown_count'] - 1,
                               torch.where(hit, pl['cooldown'], 0))
        i32 = dict(dtype=torch.int32)
        return {
            'scale': torch.where(do, new_scale, st['scale']),
            'best_value': torch.where(do, best, st['best_value']),
            'plateau_count': torch.where(do, new_plateau,
                                         st['plateau_count']).to(**i32),
            'cooldown_count': torch.where(do, new_cool,
                                          st['cooldown_count']).to(**i32),
            'count': torch.where(do, 0, count).to(**i32),
            'avg_value': torch.where(do, 0.0, avg)}


def make_optimizer(tc: TrainConfig) -> Optimizer:
    return Optimizer(tc)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm),
    from the tensors' norms in one multi-tensor pass."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        [t.float() for t in tensors])))


@dataclasses.dataclass
class TrainState:
    """step; params: the trained parameters by name (the model's own
    tensors, updated in place); opt_state: :class:`Optimizer`'s state."""
    step: int
    params: Dict[str, torch.nn.Parameter]
    opt_state: dict


def trainable_parameters(model) -> Dict[str, torch.nn.Parameter]:
    """The core's parameters, by their reference names, that the JAX
    package's params hold (the model's ``optional_keys``, which no forward
    reads, excepted).  The VQGANs are not among them."""
    skip = set(getattr(model, 'optional_keys', ()))
    return {n: p for n, p in model.core.named_parameters() if n not in skip}


def create_train_state(model, tc: TrainConfig) -> TrainState:
    params = trainable_parameters(model)
    return TrainState(step=0, params=params,
                      opt_state=make_optimizer(tc).init(params))


def opt_state_leaves(opt_state: dict) -> Dict[str, torch.Tensor]:
    """The optimizer state as numbered leaves {str(i): tensor}: count, the
    first moments and the second moments in parameter order, then the
    plateau's scalars."""
    mu = opt_state['mu']
    count = torch.tensor(opt_state['count'], dtype=torch.int32,
                         device=next(iter(mu.values())).device)
    leaves = [count, *mu.values(), *opt_state['nu'].values()]
    if 'plateau' in opt_state:
        leaves += [opt_state['plateau'][k] for k in PLATEAU_FIELDS]
    return {str(i): t for i, t in enumerate(leaves)}


def opt_state_from_leaves(template: dict, leaves: Dict[str, torch.Tensor]
                          ) -> dict:
    """Rebuild an optimizer state from :func:`opt_state_leaves`'s output;
    ``template`` is a fresh state of the same optimizer configuration."""
    want = len(opt_state_leaves(template))
    if len(leaves) != want:
        raise ValueError(
            f'optimizer state leaf count changed: the checkpoint has '
            f'{len(leaves)}, the optimizer expects {want} (was the optimizer '
            'or lr_scheduler config changed across the resume?)')
    it = iter(leaves[str(i)] for i in range(want))
    dev = next(iter(template['mu'].values())).device
    state = {'count': int(next(it)),
             'mu': {n: next(it).to(dev) for n in template['mu']},
             'nu': {n: next(it).to(dev) for n in template['nu']}}
    if 'plateau' in template:
        state['plateau'] = {k: next(it).to(dev) for k in PLATEAU_FIELDS}
    return state


def refuse_serving_only(model) -> None:
    """The JAX package's training refusals, and the port's: an int8 model,
    the quantized attention variants, and the fused LN+QKV gate (neither
    package has a backward for it)."""
    if model.cfg.clip.int8_scales is not None:
        raise RuntimeError(
            'model was quantized for serving (int8_scales set); training '
            'requires the bf16/fp32 model: build it without '
            'quantize_for_serving')
    for flag in ('MMVID_ATTN_BF16', 'MMVID_ATTN_INT8', 'MMVID_FUSED_LNQKV'):
        if os.environ.get(flag) == '1':
            raise RuntimeError(
                f'{flag}=1 is a serving/bench-only flag: its kernel has no '
                'backward that matches its forward. Unset it for training.')


def make_train_step(model, tc: TrainConfig, dp=LOCAL):
    """The step: ``(state, batch, generator, draws=None) -> (state,
    metrics)``.  batch: {'text': [B, L] ids, 'target': [B, T, H, W, 3] in
    [0, 1] (or [B, N] ids), optional 'visual', 'text_neg', 'visual_neg'},
    tensors on the model's device; ``generator`` (a torch.Generator there)
    draws the masks, warps and the visual dropout; ``draws`` is
    ``model.loss``'s deterministic hook (it may carry ``visual_drop``).
    Metrics (0-d tensors): loss, loss_msm, loss_rel, loss_vid, grad_norm
    (the gradient's global norm before clipping); the parameters are
    updated in place.  ``dp``: the data-parallel ranks; the batch is this
    rank's rows, ``generator`` and ``draws`` are the same on every rank
    (the draws of the global batch), and the metrics are the global
    batch's."""
    refuse_serving_only(model)
    opt = make_optimizer(tc)

    def loss_fn(batch, generator, draws):
        visual = batch.get('visual')
        visual_drop = None
        if (visual is not None and tc.dropout_vc > 0 and not tc.fullvc
                and 'visual_drop' not in (draws or {})):
            # one draw a step: the whole batch's control dropped with
            # probability dropout_vc
            visual_drop = torch.rand((), generator=generator,
                                     device=visual.device) < tc.dropout_vc
        msm, rel, vid = model.loss(
            generator, text=batch['text'], visual=visual,
            visual_drop=visual_drop, target=batch['target'], rel=tc.rel,
            vid=tc.vid, msm_strategy_prob=tc.msm_strategy_prob,
            msm_bernoulli_prob=tc.msm_bernoulli_prob,
            rel_no_fully_masked=tc.rel_no_fully_masked,
            vid_strategy_prob=tc.vid_strategy_prob, pc_prob=tc.pc_prob,
            erase_visual=tc.rand_visual and not tc.fullvc,
            vc_mode=tc.vc_mode, visual_aug_mode=tc.visual_aug_mode,
            negvc=tc.negvc, visual_neg=batch.get('visual_neg'),
            text_neg=batch.get('text_neg'), draws=draws, dp=dp)
        total = tc.beta_msm * msm + tc.beta_rel * rel + tc.beta_vid * vid
        return total, {'loss': total, 'loss_msm': msm, 'loss_rel': rel,
                       'loss_vid': vid}

    def train_step(state: TrainState, batch, generator, draws=None):
        names = list(state.params)
        total, metrics = loss_fn(batch, generator, draws)
        grads = torch.autograd.grad(
            total, [state.params[n] for n in names], allow_unused=True)
        grads = {n: torch.zeros_like(state.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        # the global batch's gradient and metrics: the ranks' shares summed
        dp.all_reduce_(list(grads.values()))
        keys = list(metrics)
        summed = torch.stack([metrics[k].detach().float() for k in keys])
        dp.all_reduce_([summed])
        metrics = dict(zip(keys, summed.unbind()))
        updates, opt_state, norm = opt.update(grads, state.opt_state,
                                              state.params,
                                              value=metrics['loss'])
        with torch.no_grad():
            torch._foreach_add_([state.params[n] for n in names],
                                [updates[n] for n in names])
        metrics['grad_norm'] = norm
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return train_step
