"""Data parallelism over ``torch.distributed``: the port's counterpart of
the ``dcn`` and ``dp`` axes of ``mmvid_tpu/parallel/mesh.py``.

JAX trains one SPMD program over a ``(dcn, dp, pp, tp)`` mesh; XLA shards
the batch over ``(dcn, dp)`` and inserts the gradient ``psum``.  The port
runs one process a rank, as the reference's DDP did (one process per GPU,
NCCL, rank-0-only side effects), and writes the collectives out:

* ``dcn`` is more ``dp``: ``dcn=a,dp=b`` is one data-parallel world of
  ``a * b`` ranks, ranked ``dcn``-major;
* rank r holds rows ``[r * b, (r + 1) * b)`` of the global batch ``B = N *
  b``, as JAX's batch sharding lays the batch over its devices;
* every loss normaliser is over the global batch (:meth:`DataParallel.
  total`), so the gradients are summed, not averaged, and the N-rank step
  computes the one-rank step at batch B;
* the random draws are made at the global batch's shape from the step's
  generator, which is the same on every rank, and each rank keeps its rows
  (:meth:`DataParallel.rows`).

Only ``all_reduce`` and ``broadcast`` are used, which both NCCL and gloo
support on CUDA and CPU tensors.  ``tp``, ``pp`` and ``--seq_parallel``
are not ported (ROADMAP.md, A6): they raise.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

DCN_AXIS = 'dcn'
DP_AXIS = 'dp'
PP_AXIS = 'pp'
TP_AXIS = 'tp'
MESH_AXES = (DCN_AXIS, DP_AXIS, PP_AXIS, TP_AXIS)

# the gradients' all-reduce: flat fp32 buckets of at most this size (a
# larger tensor is a bucket of its own, reduced in place)
BUCKET_BYTES = 25 << 20

# the environment that ``python -m torch.distributed.run`` sets
LAUNCHER_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK')


def parse_mesh_shape(spec: Optional[str], n_devices: int) -> Dict[str, int]:
    """Parse ``"dp=4,tp=2"`` / ``"dcn=2,dp=2,pp=2,tp=2"`` into an axis
    dict; default is all-DP (JAX's ``parse_mesh_shape``)."""
    axes: Dict[str, int] = {}
    if spec:
        for part in spec.split(','):
            name, _, val = part.partition('=')
            name = name.strip()
            if name not in MESH_AXES:
                raise ValueError(
                    f'unknown mesh axis {name!r}; expected one of '
                    f'{MESH_AXES}')
            axes[name] = int(val)
    else:
        axes[DP_AXIS] = n_devices
    for name in MESH_AXES:
        axes.setdefault(name, 1)
    total = int(np.prod(list(axes.values())))
    if total != n_devices:
        raise ValueError(
            f'mesh shape {axes} needs {total} devices, have {n_devices}')
    return axes


def refuse_model_parallel(args) -> None:
    """``tp`` or ``pp`` above 1 and ``--seq_parallel`` raise: only the
    data-parallel axes are ported."""
    if getattr(args, 'seq_parallel', False):
        raise NotImplementedError(
            '--seq_parallel: sequence parallelism is not ported (ROADMAP.md, '
            'A6: tp, then pp, then seq_parallel)')
    spec = getattr(args, 'mesh_shape', None)
    if not spec:
        return
    for part in spec.split(','):
        name, _, val = part.partition('=')
        if name.strip() in (TP_AXIS, PP_AXIS) and int(val) > 1:
            raise NotImplementedError(
                f'--mesh_shape {spec}: {name.strip()} > 1 is not ported '
                '(ROADMAP.md, A6: tp, then pp, then seq_parallel); the '
                'port trains data-parallel over dcn x dp ranks')


def mesh_ranks(spec: Optional[str], n_devices: int) -> int:
    """The data-parallel world that ``--mesh_shape`` asks for over
    ``n_devices``: dcn * dp (tp and pp must be 1)."""
    axes = parse_mesh_shape(spec, n_devices)
    return axes[DCN_AXIS] * axes[DP_AXIS]


def default_dp(n_devices: int, batch: int) -> int:
    """JAX's default: all devices dp, shrunk to the largest dp that divides
    the batch, with its note (the root ``train.py:183-192``)."""
    dp = math.gcd(n_devices, batch)
    if dp < n_devices:
        print(f'batch {batch} not divisible by {n_devices} devices; '
              f'using dp={dp}')
    return dp


def local_batch(batch: int, world: int) -> int:
    """``--batch_size`` is the global batch; each rank loads its share."""
    if batch % world:
        raise ValueError(f'batch_size {batch} not divisible by {world} '
                         'ranks')
    return batch // world


def launched_by_env() -> bool:
    """Whether ``python -m torch.distributed.run`` started this process."""
    return all(k in os.environ for k in LAUNCHER_ENV)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_root() -> bool:
    return rank() == 0


def check_backend(backend: str, device_type: str) -> None:
    """The backend the flags name, as they name it: NCCL needs the card,
    and a backend this build lacks raises (no switch to another)."""
    if backend == 'nccl' and device_type != 'cuda':
        raise RuntimeError(
            f'--dist_backend nccl runs on CUDA devices, not --device '
            f'{device_type}; pass --dist_backend gloo to run the ranks on '
            'the CPU')
    available = {'nccl': dist.is_nccl_available,
                 'gloo': dist.is_gloo_available}
    if backend not in available:
        raise ValueError(f'--dist_backend {backend!r}: expected nccl or gloo')
    if not available[backend]():
        raise RuntimeError(f'--dist_backend {backend}: this PyTorch build '
                           'has no such backend')


def rank_device(name: str, local_rank: int) -> torch.device:
    """The device of the rank that is ``local_rank`` on its host: a bare
    ``cuda`` is the local rank's card; an indexed one (``cuda:0``) is
    taken as given, so ranks may share a card on purpose."""
    dev = torch.device(name)
    if dev.type != 'cuda':
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f'--device {name}: no CUDA device is available (pass --device '
            'cpu --dist_backend gloo to run the ranks on the CPU)')
    if dev.index is None:
        dev = torch.device('cuda', local_rank)
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f'rank on {dev}: only '
                           f'{torch.cuda.device_count()} CUDA devices')
    return dev


def init(backend: str, device: torch.device, rank_: int, world_: int,
         init_method: str) -> 'DataParallel':
    """Join the process group (rank ``rank_`` of ``world_``) and return its
    :class:`DataParallel`."""
    check_backend(backend, device.type)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_, rank=rank_)
    return DataParallel(device=device)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


class LocalBatch:
    """One process holds the whole batch: every method is the identity."""

    rank = 0
    world = 1

    def rows(self, x):
        """This rank's rows of a global-batch tensor."""
        return x

    def batch(self, b: int) -> int:
        """The global batch of ``b`` rows a rank."""
        return b

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """A count summed over the ranks (no gradient)."""
        return t.detach()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch from each rank's rows (no gradient)."""
        return x

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`gather` with a gradient: the global batch's gradient is
        summed over the ranks and each rank keeps its rows'."""
        return x

    def all_reduce_(self, tensors) -> None:
        """Sum ``tensors`` over the ranks, in place."""

    def broadcast_(self, tensors) -> None:
        """Rank 0's ``tensors`` on every rank, in place."""

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on some rank."""
        return bool(flag)

    def barrier(self) -> None:
        """Wait for every rank."""


LOCAL = LocalBatch()


class DataParallel(LocalBatch):
    """This process's rank in the default process group, whose tensors live
    on ``device``.  Rank r holds rows ``[r * b, (r + 1) * b)`` of the
    global batch."""

    def __init__(self, device: torch.device, group=None):
        self.group = group
        self.device = device
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)

    def rows(self, x):
        b = x.shape[0] // self.world
        return x[self.rank * b:(self.rank + 1) * b]

    def batch(self, b: int) -> int:
        return b * self.world

    def total(self, t):
        t = t.detach().clone()
        dist.all_reduce(t, group=self.group)
        return t

    @torch.no_grad()
    def gather(self, x):
        b = x.shape[0]
        wire = x.float() if x.is_floating_point() else x
        buf = wire.new_zeros((b * self.world,) + tuple(x.shape[1:]))
        buf[self.rank * b:(self.rank + 1) * b] = wire
        # a sum over zeros and one rank's rows is exact in any order
        dist.all_reduce(buf, group=self.group)
        return buf.to(x.dtype)

    def exchange(self, x):
        return _Exchange.apply(x, self)

    def all_reduce_(self, tensors) -> None:
        self._bucketed(tensors, lambda flat: dist.all_reduce(
            flat, group=self.group))

    def broadcast_(self, tensors) -> None:
        self._bucketed(tensors, lambda flat: dist.broadcast(
            flat, src=0, group=self.group))

    def _bucketed(self, tensors, op) -> None:
        """``op`` on flat fp32 buckets of ``tensors``, in their order,
        copied back; an fp32 contiguous tensor of a bucket's size or more
        is its own bucket, done in place."""
        bucket, size = [], 0

        def flush():
            nonlocal bucket, size
            if len(bucket) == 1 and bucket[0].dtype == torch.float32 \
                    and bucket[0].is_contiguous():
                op(bucket[0])
            elif bucket:
                flat = torch.cat([t.reshape(-1).float() for t in bucket])
                op(flat)
                for t, piece in zip(bucket, flat.split(
                        [t.numel() for t in bucket])):
                    t.copy_(piece.view(t.shape))
            bucket, size = [], 0

        with torch.no_grad():
            for t in tensors:
                nbytes = t.numel() * 4
                if bucket and size + nbytes > BUCKET_BYTES:
                    flush()
                bucket.append(t)
                size += nbytes
            flush()

    def any(self, flag: bool) -> bool:
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def barrier(self) -> None:
        if dist.get_backend(self.group) == 'nccl':
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


class _Exchange(torch.autograd.Function):
    """The global batch from each rank's rows; backward: the global
    gradient summed over the ranks (an all-reduce, which gloo has where
    it lacks reduce_scatter), then this rank's rows."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp, ctx.dtype = dp, x.dtype
        return dp.gather(x)

    @staticmethod
    def backward(ctx, grad):
        dp = ctx.dp
        grad = grad.float().contiguous().clone()
        dist.all_reduce(grad, group=dp.group)
        return dp.rows(grad).to(ctx.dtype), None
