"""Tensor parallelism over ``torch.distributed``: the port's counterpart of
the ``tp`` axis and ``--seq_parallel`` of ``mmvid_tpu/parallel/``.

JAX shards the backbone's kernels by ``_TP_RULES`` (``mmvid_tpu/parallel/
mesh.py``: query / key / value / fc split by output columns, out / proj by
input rows, everything else replicated) and GSPMD inserts the collectives.
The port runs one process a rank and writes those collectives out, as
Megatron-LM does:

* without sequence parallelism, before a column-split product the input is
  the identity forward and an all-reduce over tp backward
  (:meth:`TensorParallel.enter`), and after a row-split product the partial
  sums are all-reduced forward and passed through backward
  (:meth:`TensorParallel.leave`), the row product's bias added once, after
  the sum;
* with ``seq_parallel``, the residual stream between blocks is split over
  tp by sequence rows (rank t holds rows ``[t c, min(L, (t + 1) c))``, ``c
  = ceil(L / tp)``), as ``mmvid_tpu/models/clip.py`` constrains it: the
  LayerNorms and residual adds run on the shard, ``enter`` all-gathers
  the rows (reduce-scatter backward) and ``leave`` reduce-scatters the
  partial sums (all-gather backward); the stack's entry takes this rank's
  rows (:meth:`TensorParallel.split`) and its exit all-gathers them
  (:meth:`TensorParallel.join`).  Attention always sees all L rows.

The port keeps torch's packed ``in_proj_weight`` [3D, D]: rank t holds
rows ``[i D + t D / tp, i D + (t + 1) D / tp)`` of each of the q, k and v
blocks (i = 0, 1, 2), which are heads ``[t H / tp, (t + 1) H / tp)`` of
each, as JAX's column split of its separate query / key / value kernels.
The column products' biases (``in_proj_bias``, ``c_fc.bias``) are split
with their rows: JAX keeps them replicated and GSPMD slices them at use,
the port slices them once.

Partial sums travel in fp32 (the wire of the dp buckets, ``mesh.py``);
gathers carry exact values.  The collectives are chosen by the tp group's
backend at construction: on NCCL ``all_gather_into_tensor`` /
``reduce_scatter_tensor``; on gloo, which has neither on CUDA tensors, the
all-reduce of a zero-filled buffer with this rank's rows in place (as
``DataParallel.gather`` does).  A backend that is neither raises.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

TP_AXIS = 'tp'

# the stack's parameters under ``resblocks.<i>.``: the dimension of the
# port's tensor that tp splits (torch's [out, in] weights: JAX's column
# split of a kernel [in, out] is the weight's dim 0, its row split dim 1)
SPLIT_DIMS = {
    'attn.in_proj_weight': 0,
    'attn.in_proj_bias': 0,
    'attn.out_proj.weight': 1,
    'mlp.c_fc.weight': 0,
    'mlp.c_fc.bias': 0,
    'mlp.c_proj.weight': 1,
}
# packed q | k | v rows: each of the three blocks is split on its own
PACKED = ('attn.in_proj_weight', 'attn.in_proj_bias')
# replicated parameters of the stack that, under seq_parallel, see only
# this rank's rows: their gradients are partial sums over tp
SEQ_PARTIAL = ('ln_1.weight', 'ln_1.bias', 'ln_2.weight', 'ln_2.bias',
               'attn.out_proj.bias', 'mlp.c_proj.bias')
_BLOCK = re.compile(r'(?:^|\.)resblocks\.\d+\.(.+)$')

# the JAX package's rules (mmvid_tpu/parallel/mesh.py _TP_RULES) over a
# '/'-joined param path, as ``_spec_for_path(path, use_tp=True,
# use_pp=False)`` applies them: the first match wins, no match replicates
JAX_TP_RULES = (
    (re.compile(r'.*/attn/qkv/kernel$'), (None, TP_AXIS)),
    (re.compile(r'.*/attn/(query|key|value)/kernel$'), (None, TP_AXIS)),
    (re.compile(r'.*/attn/out/kernel$'), (TP_AXIS, None)),
    (re.compile(r'.*/mlp/fc/kernel$'), (None, TP_AXIS)),
    (re.compile(r'.*/mlp/proj/kernel$'), (TP_AXIS, None)),
)


def jax_spec(path: str) -> tuple:
    """The PartitionSpec (as a tuple) JAX's ``param_shardings`` gives the
    param at ``path`` on a mesh with tp > 1 and pp = 1."""
    for rx, spec in JAX_TP_RULES:
        if rx.match(path):
            return spec
    return ()


def jax_paths(name: str) -> tuple:
    """The JAX leaf paths (under the stack's ``blocks_<i>``) that the
    port's stack parameter ``name`` (``...resblocks.<i>.<leaf>``) holds;
    the packed projection holds three."""
    m = re.search(r'resblocks\.(\d+)\.(.+)$', name)
    i, leaf = m.group(1), m.group(2)
    if leaf in PACKED:
        jleaf = 'kernel' if leaf.endswith('weight') else 'bias'
        return tuple(f'blocks_{i}/attn/{p}/{jleaf}'
                     for p in ('query', 'key', 'value'))
    mod, _, kind = leaf.rpartition('.')
    jleaf = {'weight': 'kernel', 'bias': 'bias'}[kind]
    if mod in ('ln_1', 'ln_2'):
        return (f'blocks_{i}/{mod}/{"scale" if kind == "weight" else kind}',)
    jmod = {'attn.out_proj': 'attn/out', 'mlp.c_fc': 'mlp/fc',
            'mlp.c_proj': 'mlp/proj'}[mod]
    return (f'blocks_{i}/{jmod}/{jleaf}',)


def split_dim(name: str) -> Optional[int]:
    """The dimension of parameter ``name`` that tp splits, None where it
    is replicated."""
    m = _BLOCK.search(name)
    return SPLIT_DIMS.get(m.group(1)) if m else None


def seq_partial(name: str) -> bool:
    """Whether ``name``'s gradient is a partial sum over tp under
    seq_parallel."""
    m = _BLOCK.search(name)
    return bool(m) and m.group(1) in SEQ_PARTIAL


def _packed(name: str) -> bool:
    m = _BLOCK.search(name)
    return bool(m) and m.group(1) in PACKED


def shard(t: torch.Tensor, name: str, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s shard of the full parameter (or moment) ``t``."""
    dim = split_dim(name)
    if dim is None or tp == 1:
        return t
    if t.shape[dim] % tp:
        raise ValueError(f'{name} {tuple(t.shape)}: dim {dim} does not '
                         f'split over tp={tp}')
    if _packed(name):
        return torch.cat([blk.chunk(tp, 0)[rank] for blk in t.chunk(3, 0)])
    return t.chunk(tp, dim)[rank]


def shard_state_dict(sd: Dict, tp: int, rank: int) -> Dict:
    """A full reference-layout state dict sliced to rank ``rank`` of
    ``tp``: split tensors contiguous copies, the others as they are."""
    return {k: (shard(v, k, tp, rank).contiguous().clone()
                if split_dim(k) is not None and tp > 1 else v)
            for k, v in sd.items()}


def gather_state_dict(sd: Dict, tp: 'LocalTensor') -> Dict:
    """The inverse of :func:`shard_state_dict` over the ranks of ``tp``
    (every rank of the group calls it, in the same key order): the full
    tensors on every rank, in their dtype."""
    return {k: (tp.gather_param(v, k) if split_dim(k) is not None
                and tp.size > 1 else v) for k, v in sd.items()}


def split_stack(stack, tp: 'LocalTensor') -> None:
    """Slice a full :class:`models.clip.TransformerStack` in place to its
    shard for ``tp``'s rank: its split parameters become new parameters
    holding the shard, its attention holds H / tp heads, and every block
    runs ``tp``'s collectives."""
    heads = stack.cfg.heads
    refuse_heads(heads, tp.size)
    if stack.cfg.int8_scales is not None:
        refuse_int8(tp.size)
    stack.tp = tp
    for block in stack.resblocks:
        for name, p in list(block.named_parameters()):
            if split_dim(f'resblocks.0.{name}') is None:
                continue
            mod_name, _, leaf = name.rpartition('.')
            mod = block.get_submodule(mod_name) if mod_name else block
            piece = shard(p.detach(), f'resblocks.0.{name}', tp.size,
                          tp.rank).contiguous().clone()
            setattr(mod, leaf, torch.nn.Parameter(
                piece, requires_grad=p.requires_grad))
        block.attn.heads = heads // tp.size
        block.tp = block.attn.tp = block.mlp.tp = tp


def split_model(model, tp: 'LocalTensor') -> None:
    """:func:`split_stack` on the backbone of an MMVID or ART-V model (or
    its core); a tp of one leaves it as it is."""
    if tp.size == 1:
        return
    core = getattr(model, 'core', model)
    split_stack(core.transformer['transformer'], tp)


def stack_tp(model) -> 'LocalTensor':
    """The tensor-parallel context of a model's backbone."""
    core = getattr(model, 'core', model)
    return core.transformer['transformer'].tp


def refuse_heads(heads: int, tp: int) -> None:
    if heads % tp:
        raise NotImplementedError(
            f'tp={tp} does not divide the backbone\'s {heads} heads: the '
            'port splits attention by whole heads (JAX reshards such a tp '
            'through GSPMD; ROADMAP.md, A6)')


def refuse_int8(tp: int) -> None:
    if tp > 1:
        raise NotImplementedError(
            f'int8 serving with tp={tp}: the quantized backbone runs on one '
            'rank (the JAX serving drivers build no tp mesh); drop --int8 '
            'or the tp axis')


def rows(length: int, tp: int, rank: int) -> tuple:
    """Rank ``rank``'s sequence rows ``[lo, hi)`` of ``length`` under
    seq_parallel."""
    c = -(-length // tp)
    return min(length, rank * c), min(length, (rank + 1) * c)


class LocalTensor:
    """One rank holds the whole backbone: every method is the identity."""

    size = 1
    rank = 0
    seq_parallel = False

    def enter(self, x, length: int):
        """A column-split product's input, from the residual stream's
        (normalised) rows; ``length``: the whole sequence's."""
        return x

    def split(self, x):
        """The stack's entry: this rank's rows of the residual stream."""
        return x

    def join(self, x, length: int):
        """The stack's exit: the whole residual stream of ``length``
        rows."""
        return x

    def reduce_seq_grads_(self, grads: Dict) -> None:
        """Sum the seq_parallel partial gradients over tp, in place."""


LOCAL_TP = LocalTensor()


class TensorParallel(LocalTensor):
    """This rank's place in its tp group ``group`` of ``size`` ranks.
    ``route``: 'collective' (all-gather / reduce-scatter) or 'all_reduce';
    by default the group's backend chooses (NCCL: collective, gloo:
    all_reduce)."""

    def __init__(self, group, seq_parallel: bool = False,
                 route: Optional[str] = None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.seq_parallel = bool(seq_parallel)
        backend = dist.get_backend(group)
        if backend not in ('nccl', 'gloo'):
            raise NotImplementedError(
                f'tp over {backend!r}: the port\'s tp collectives run on '
                'nccl or gloo')
        self.route = route or ('collective' if backend == 'nccl'
                               else 'all_reduce')
        if self.route not in ('collective', 'all_reduce'):
            raise ValueError(f'tp route {self.route!r}')

    # -- the collectives (no autograd) --------------------------------------

    def sum(self, x):
        """x summed over the group, fp32 on the wire."""
        y = x.float().contiguous().clone()
        dist.all_reduce(y, group=self.group)
        return y

    def gather_rows(self, x, length: int):
        """[B, rows, ...] shards of a [B, length, ...] tensor -> the whole
        tensor on every rank, in x's dtype."""
        lo, hi = rows(length, self.size, self.rank)
        if self.route == 'all_reduce':
            buf = x.new_zeros((x.shape[0], length) + tuple(x.shape[2:]),
                              dtype=torch.float32)
            buf[:, lo:hi] = x
            dist.all_reduce(buf, group=self.group)
            return buf.to(x.dtype)
        c = -(-length // self.size)
        inp = x.new_zeros((x.shape[0], c) + tuple(x.shape[2:]))
        inp[:, :hi - lo] = x
        # the ranks' shards concatenated along dim 0
        out = x.new_empty((self.size * inp.shape[0],) + tuple(inp.shape[1:]))
        _all_gather(out, inp, group=self.group)
        out = out.view((self.size,) + tuple(inp.shape)).transpose(0, 1).reshape(
            (x.shape[0], self.size * c) + tuple(x.shape[2:]))
        return out[:, :length]

    def scatter_rows(self, y):
        """Partial sums [B, L, ...] -> this rank's rows of their sum over
        the group, fp32."""
        length = y.shape[1]
        lo, hi = rows(length, self.size, self.rank)
        if self.route == 'all_reduce':
            return self.sum(y)[:, lo:hi]
        c = -(-length // self.size)
        full = y.new_zeros((y.shape[0], self.size * c) + tuple(y.shape[2:]),
                           dtype=torch.float32)
        full[:, :length] = y
        inp = full.view((y.shape[0], self.size, c) + tuple(y.shape[2:])
                        ).transpose(0, 1).contiguous()
        out = inp.new_empty(inp.shape[1:])
        inp = inp.view((-1,) + tuple(inp.shape[2:]))
        _reduce_scatter(out, inp, group=self.group)
        return out[:, :hi - lo]

    def own_rows(self, x):
        lo, hi = rows(x.shape[1], self.size, self.rank)
        return x[:, lo:hi]

    def gather_param(self, t, name: str):
        """The full parameter (or moment) from each rank's shard ``t`` of
        ``name``, in t's dtype."""
        dim = split_dim(name)
        parts = 3 if _packed(name) else 1
        full_shape = list(t.shape)
        full_shape[dim] *= self.size
        buf = t.new_zeros(full_shape, dtype=torch.float32)
        # this rank's slice of each packed block, or of the one tensor
        blocks = buf.chunk(parts, dim)
        for blk, piece in zip(blocks, t.chunk(parts, dim)):
            blk.narrow(dim, self.rank * piece.shape[dim],
                       piece.shape[dim]).copy_(piece)
        dist.all_reduce(buf, group=self.group)
        return buf.to(t.dtype)

    # -- the autograd operations ----------------------------------------

    def enter(self, x, length: int):
        if self.seq_parallel:
            return _GatherRows.apply(x, self, length)
        return _Enter.apply(x, self)

    def leave(self, y, bias, dtype):
        """A row-split product's output in ``dtype``: the partial sums
        ``y`` reduced (under seq_parallel, this rank's rows of them), then
        ``bias`` added once, in fp32."""
        if self.seq_parallel:
            s = _ScatterRows.apply(y, self)
        else:
            s = _Leave.apply(y, self)
        return (s + bias.float()).to(dtype)

    def split(self, x):
        return _Split.apply(x, self) if self.seq_parallel else x

    def join(self, x, length: int):
        return _Join.apply(x, self, length) if self.seq_parallel else x

    # -- the step ----------------------------------------------------

    def norm_sq(self, split_sq, repl_sq):
        """The gradient's squared global norm from the split parameters'
        sum of squares (this rank's shard) and the replicated ones'."""
        return self.sum(split_sq) + repl_sq

    def reduce_seq_grads_(self, grads: Dict) -> None:
        if not self.seq_parallel:
            return
        for n, g in grads.items():
            if seq_partial(n):
                g.copy_(self.sum(g))


def row_product(x, w):
    """``x @ w^T`` for a row-split layer: the partial sum of this rank's
    input columns, fp32 and not rounded to x's dtype, so that the sum over
    tp rounds once, as the one-rank product does.  A bf16 x takes cuBLAS's
    bf16 product with an fp32 result on the card (``torch.mm(...,
    out_dtype=torch.float32)``) and fp32 arithmetic on the CPU; its
    gradients are the bf16 products a bf16 ``F.linear`` takes."""
    if x.dtype == torch.float32:
        return F.linear(x, w)
    return _RowProduct.apply(x, w)


class _RowProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda:
            y = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:
            y = x2.float() @ w.float().t()
        return y.view(tuple(x.shape[:-1]) + (w.shape[0],))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return g @ w, gw


def _all_gather(out, inp, group):
    fn = getattr(dist, 'all_gather_single', None) or \
        dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _reduce_scatter(out, inp, group):
    fn = getattr(dist, 'reduce_scatter_single', None) or \
        dist.reduce_scatter_tensor
    fn(out, inp, group=group)


class _Enter(torch.autograd.Function):
    """Identity forward; backward: the input's gradient, partial on each
    rank (its heads' or hidden units' share), summed over tp."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.sum(g).to(g.dtype), None


class _Leave(torch.autograd.Function):
    """The partial sums summed over tp (fp32); identity backward."""

    @staticmethod
    def forward(ctx, y, tp):
        ctx.dtype = y.dtype
        return tp.sum(y)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _GatherRows(torch.autograd.Function):
    """seq_parallel's enter: the rows all-gathered; backward: the whole
    gradient (partial on each rank) reduce-scattered to this rank's
    rows."""

    @staticmethod
    def forward(ctx, x, tp, length):
        ctx.tp, ctx.dtype = tp, x.dtype
        return tp.gather_rows(x, length)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.scatter_rows(g).to(ctx.dtype), None, None


class _ScatterRows(torch.autograd.Function):
    """seq_parallel's leave: the partial sums reduce-scattered to this
    rank's rows (fp32); backward: the rows' gradients all-gathered."""

    @staticmethod
    def forward(ctx, y, tp):
        ctx.tp, ctx.dtype, ctx.length = tp, y.dtype, y.shape[1]
        return tp.scatter_rows(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.gather_rows(g, ctx.length).to(ctx.dtype), None


class _Split(torch.autograd.Function):
    """The stack's entry under seq_parallel: this rank's rows of the
    replicated stream; backward: the rows' gradients all-gathered, the
    whole gradient on every rank."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.length = tp, x.shape[1]
        return tp.own_rows(x).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.gather_rows(g.contiguous(), ctx.length), None


class _Join(torch.autograd.Function):
    """The stack's exit under seq_parallel: the rows all-gathered;
    backward: this rank's rows of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, tp, length):
        ctx.tp = tp
        return tp.gather_rows(x, length)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.own_rows(g).contiguous(), None, None


def shard_opt_state(opt_state: Dict, tp: LocalTensor) -> Dict:
    """A full-layout optimizer state (``training.Optimizer``'s) with its
    moments sliced to ``tp``'s rank."""
    out = dict(opt_state)
    for k in ('mu', 'nu'):
        out[k] = shard_state_dict(opt_state[k], tp.size, tp.rank)
    return out


def gather_opt_state(opt_state: Dict, tp: LocalTensor) -> Dict:
    """The inverse of :func:`shard_opt_state` (every rank of the group
    calls it)."""
    out = dict(opt_state)
    for k in ('mu', 'nu'):
        out[k] = gather_state_dict(opt_state[k], tp)
    return out
