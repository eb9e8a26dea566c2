"""The port's tensor parallelism (``mmvid_tpu_torch/parallel/tensor.py``,
the ``tp`` axis and ``--seq_parallel``) on the CPU, held to JAX and to the
port's one-rank run.

Ranks are processes over gloo: a pool of four, started once for the
module (a ``FileStore`` under ``tmp_path``, one thread each), which lays
out ``tp=2`` on ranks 0 and 1, ``tp=4`` on all four, and ``dp=2,tp=2`` as
the mesh does (tp groups {0, 1} and {2, 3}, dp groups {0, 2} and {1, 3}).
Both collective routes run on gloo's CPU tensors: the all-reduce route
(gloo's own) and the all-gather / reduce-scatter route (NCCL's).

* (a) the layout: the port's split table reproduces JAX's
  ``param_shardings`` leaf by leaf through the converter's names, and
  ``shard_state_dict`` / ``gather_state_dict`` round-trip exactly;
* (b) the stack: tp = 2 and 4, with and without ``seq_parallel``, at a
  length that no tp divides, equals JAX's ``TransformerStack`` on the same
  weights (1e-5), and its gradients the one-rank port's;
* (c) the step: tp = 2 and dp = 2 x tp = 2 (remat on, with and without
  ``seq_parallel``) equal JAX's one-device step on JAX's draws: the loss
  within rtol 1e-5, grad_norm within 1e-4, the parameters within 1e-5
  normwise (the key projection's zero-gradient bias held as
  tests/test_torch_training.py::_hold_params holds it); the replicated
  parameters bit-identical on a tp group's ranks; JAX's train state
  carried onto the shards (``weights.train_state_from_jax``) gathers back
  exactly;
* (d) on the generator's draws with nonzero biases, tp = 2 equals one rank,
  and the three planted faults leave the tolerance: a global norm that
  counts the replicated parameters tp times, a row-split bias added on
  every rank, the seq_parallel partial gradients left unreduced; one
  ART-V step at tp = 2 equals one rank;
* (e) generation: tp = 2 samples the one-rank tokens under the
  deterministic hook;
* (f) the driver through the launcher's environment with ``--mesh_shape
  tp=2 --seq_parallel``: its losses are the one-rank run's, its checkpoint
  has the one-rank keys and shapes, and it resumes at tp = 1; the
  refusals raise.
"""

import dataclasses
import os
import queue
import shutil
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mmvid_tpu_torch import factories, training, weights
from mmvid_tpu_torch.parallel import mesh, tensor
from test_torch_parallel import (  # noqa: F401 (clips, jax_model: fixtures)
    _driver_argv,
    _launched_rank,
    _logged,
    clips,
    jax_model,
)

POOL = 4
TIMEOUT_S = 240
TOL = 1e-5
NORM_TOL = 1e-4
LOG_TOL = 2e-4
STEPS = 3


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One thread for the module (tests/test_torch_parallel.py's)."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


# -- the rank pool ------------------------------------------------------

LAYOUTS = {'tp2': 2, 'tp4': 4, 'dp2tp2': 4}


def _rank_main(rank, store, jobs, results):
    """One rank of the pool: runs each job it is sent with its layout's
    (DataParallel, tp group); ranks outside a layout answer None."""
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{store}',
                            rank=rank, world_size=POOL)
    # every rank creates every group, in the same order
    g01, g23 = dist.new_group([0, 1]), dist.new_group([2, 3])
    g02, g13 = dist.new_group([0, 2]), dist.new_group([1, 3])
    layouts = {'tp2': (mesh.LOCAL, g01), 'tp4': (mesh.LOCAL, None),
               'dp2tp2': (mesh.DataParallel(torch.device('cpu'),
                                            g02 if rank % 2 == 0 else g13),
                          g01 if rank < 2 else g23)}
    try:
        while True:
            job = jobs.get()
            if job is None:
                return
            name, layout, kw = job
            try:
                out = None
                if rank < LAYOUTS[layout]:
                    dp, group = layouts[layout]
                    out = globals()[name](dp, group, **kw)
                results.put((rank, 'ok', out))
            except Exception:
                results.put((rank, 'error', traceback.format_exc()))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """run(job, layout, **kw) -> the job's output on the layout's ranks."""
    ctx = mp.get_context('spawn')
    store = tmp_path_factory.mktemp('tpstore') / 'store'
    jobs = [ctx.Queue() for _ in range(POOL)]
    results = ctx.Queue()
    old = os.environ.get('GLOO_SOCKET_IFNAME')
    os.environ['GLOO_SOCKET_IFNAME'] = 'lo'
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, str(store), jobs[r], results))
             for r in range(POOL)]
    for p in procs:
        p.start()

    def run(name, layout, **kw):
        for q in jobs:
            q.put((name, layout, dict(kw)))
        outs = {}
        for _ in range(POOL):
            try:
                r, status, out = results.get(timeout=TIMEOUT_S)
            except queue.Empty:
                raise RuntimeError(f'{name}: a rank did not answer in '
                                   f'{TIMEOUT_S} s') from None
            if status == 'error':
                raise RuntimeError(f'{name} on rank {r}:\n{out}')
            outs[r] = out
        return [outs[r] for r in range(LAYOUTS[layout])]

    try:
        yield run
    finally:
        for q in jobs:
            q.put(None)
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        if old is None:
            os.environ.pop('GLOO_SOCKET_IFNAME', None)
        else:
            os.environ['GLOO_SOCKET_IFNAME'] = old


# -- the planted faults ------------------------------------------------------

class NormCountsReplicated(tensor.TensorParallel):
    """The global norm with the replicated parameters' squares summed over
    tp as well (counted tp times)."""

    def norm_sq(self, split_sq, repl_sq):
        return self.sum(split_sq + repl_sq)


class BiasOnEveryRank(tensor.TensorParallel):
    """The row-split product's bias added on every rank before the sum."""

    def leave(self, y, bias, dtype):
        return super().leave(y + bias.to(y.dtype),
                             torch.zeros_like(bias), dtype)


class SeqGradsUnreduced(tensor.TensorParallel):
    """seq_parallel's LayerNorm and row-bias gradients left as this rank's
    partial sums."""

    def reduce_seq_grads_(self, grads):
        pass


FAULTS = {None: tensor.TensorParallel, 'norm': NormCountsReplicated,
          'bias': BiasOnEveryRank, 'seq_grads': SeqGradsUnreduced}


def _tp(group, sp=False, route=None, fault=None):
    return FAULTS[fault](group, seq_parallel=sp, route=route)


# -- the jobs (each rank runs one) --------------------------------------------

def _job_roundtrip(dp, group, sd, route):
    """This rank's shard of ``sd``, gathered back over the group."""
    tp = _tp(group, route=route)
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    got = tensor.gather_state_dict(
        tensor.shard_state_dict(sd, tp.size, tp.rank), tp)
    return {k: v.numpy() for k, v in got.items()}


def _stack_run(stack, x, mask):
    x = torch.from_numpy(x).requires_grad_(True)
    y = stack(x, torch.from_numpy(mask))
    cot = torch.from_numpy(np.random.RandomState(9).randn(
        *y.shape).astype(np.float32))
    params = dict(stack.named_parameters())
    grads = torch.autograd.grad((y * cot).sum(), [x, *params.values()])
    named = dict(zip(params, grads[1:]))
    stack.tp.reduce_seq_grads_(named)
    full = tensor.gather_state_dict(named, stack.tp)
    return {'y': y.detach().numpy(), 'dx': grads[0].numpy(),
            'grads': {k: v.numpy() for k, v in full.items()}}


def _port_stack(sd, heads, remat=False):
    from mmvid_tpu_torch.models.clip import ClipStackConfig, TransformerStack
    stack = TransformerStack(ClipStackConfig(width=64, layers=2, heads=heads,
                                             remat=remat))
    stack.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return stack


def _job_stack(dp, group, sd, heads, x, mask, sp, route):
    stack = _port_stack(sd, heads)
    tensor.split_stack(stack, _tp(group, sp, route))
    return _stack_run(stack, x, mask)


def _perturb_biases(model, seed):
    """The backbone's biases and LayerNorm shifts drawn N(0, 0.1) (the
    builds make them zero, which would hide a bias added twice)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.core.transformer.named_parameters():
            if name.endswith('bias'):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)


def _outcome(state, metrics, tp):
    """Metrics, gathered parameters and first moments, and this rank's
    replicated parameters."""
    full = tensor.gather_state_dict(
        {n: p.detach() for n, p in state.params.items()}, tp)
    mu = tensor.gather_state_dict(state.opt_state['mu'], tp)
    return {'metrics': metrics,
            'params': {n: p.numpy().copy() for n, p in full.items()},
            'mu': {n: t.numpy().copy() for n, t in mu.items()},
            'replicated': {n: p.detach().numpy().copy()
                           for n, p in state.params.items()
                           if tensor.split_dim(n) is None}}


def _job_jax_steps(dp, group, params, vae_params, text, frames, draws, tc,
                   sp):
    """The tiny flagship (remat) on JAX's weights split over tp, a step
    for each of JAX's global draws, this dp rank's rows."""
    tp = _tp(group, sp)
    model, _ = factories.flagship_train(tiny=True, dtype=torch.float32,
                                        device='cpu', seed=1, remat=True)
    weights.load_jax_params(model, params, vae_params)
    tensor.split_model(model, tp)
    tc = training.TrainConfig(**tc)
    state = training.create_train_state(model, tc)
    step = training.make_train_step(model, tc, dp)
    batch = {'text': dp.rows(torch.from_numpy(text).long()),
             'target': dp.rows(torch.from_numpy(frames))}
    metrics = []
    for d in draws:
        state, m = step(state, batch, None, draws=_tree(d))
        metrics.append({k: float(v) for k, v in m.items()})
    return _outcome(state, metrics, tp)


def _job_from_jax_state(dp, group, params, vae_params, opt_state, step):
    """JAX's train state carried onto a split model: its shards gathered
    back (params and Adam's moments)."""
    tp = _tp(group)
    model, _ = factories.flagship_train(tiny=True, dtype=torch.float32,
                                        device='cpu', seed=1, remat=True)
    weights.load_jax_params(model, params, vae_params)
    tensor.split_model(model, tp)
    state = weights.train_state_from_jax(
        model, training.TrainConfig(), params, opt_state, step)
    out = _outcome(state, [], tp)
    out['nu'] = {n: t.numpy() for n, t in tensor.gather_state_dict(
        state.opt_state['nu'], tp).items()}
    out['count'] = state.opt_state['count']
    return out


def _tree(x):
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return torch.as_tensor(x)


GEN_TC = dict(learning_rate=1e-3, lr_scheduler='none',
              rel_no_fully_masked=True, msm_bernoulli_prob=(0.2, 0.5))


def _generator_batch(cfg, b, seed):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, 100, (b, cfg.text_seq_len))
    text[:, -2:] = 0
    size = cfg.image_size
    return {'text': torch.from_numpy(text).long(),
            'target': torch.from_numpy(rng.uniform(0, 1, (
                b, cfg.num_targets, size, size, 3)).astype(np.float32))}


def _job_generator_steps(dp, group, sp=False, fault=None, tp_on=True):
    """The tiny flagship from seed 2 (biases perturbed), tp-split unless
    ``tp_on`` is off, three steps on the generator's draws at batch 4."""
    model, _ = factories.flagship_train(tiny=True, dtype=torch.float32,
                                        device='cpu', seed=2, remat=False)
    _perturb_biases(model, 3)
    tp = _tp(group, sp, fault=fault) if tp_on else tensor.LOCAL_TP
    tensor.split_model(model, tp)
    tc = training.TrainConfig(**GEN_TC)
    state = training.create_train_state(model, tc)
    step = training.make_train_step(model, tc, dp)
    batch = {k: dp.rows(v) for k, v in
             _generator_batch(model.cfg, 4, 7).items()}
    metrics = []
    for i in range(STEPS):
        state, m = step(state, batch, torch.Generator().manual_seed(40 + i))
        metrics.append({k: float(v) for k, v in m.items()})
    return _outcome(state, metrics, tp)


def _job_artv_step(dp, group, tp_on=True):
    """One ART-V step (tiny, fp32) from seed 4, biases perturbed."""
    model, _ = factories.artv_train(tiny=True, dtype=torch.float32,
                                    device='cpu', seed=4)
    _perturb_biases(model, 5)
    tp = _tp(group) if tp_on else tensor.LOCAL_TP
    tensor.split_model(model, tp)
    tc = training.TrainConfig(**dict(GEN_TC, beta_msm=1.0, beta_rel=0.0,
                                     beta_vid=0.0))
    state = training.create_train_state(model, tc)
    step = training.make_train_step(model, tc, dp)
    rng = np.random.RandomState(11)
    batch = {'text': torch.from_numpy(rng.randint(1, 50, (2, 6))).long(),
             'target': torch.from_numpy(rng.uniform(0, 1, (
                 2, 2, 32, 32, 3)).astype(np.float32)),
             'visual': torch.from_numpy(rng.uniform(0, 1, (
                 2, 1, 32, 32, 3)).astype(np.float32))}
    state, m = step(state, batch, torch.Generator().manual_seed(3))
    return _outcome(state, [{k: float(v) for k, v in m.items()}], tp)


def _job_generate(dp, group, sp=False, tp_on=True):
    """The tiny flagship's tokens under the deterministic hook."""
    from mmvid_tpu_torch.models import mmvid as pmmvid
    model, _ = factories.flagship(tiny=True, device='cpu', seed=6)
    _perturb_biases(model, 8)
    tensor.split_model(model, _tp(group, sp) if tp_on else tensor.LOCAL_TP)
    orig = pmmvid.build_spec
    pmmvid.build_spec = lambda *a, **k: dataclasses.replace(
        orig(*a, **k), deterministic=True)
    try:
        text = torch.from_numpy(np.random.RandomState(0).randint(
            1, 100, (2, model.cfg.text_seq_len)))
        with torch.no_grad():
            videos, seq = model.generate_images(
                torch.Generator().manual_seed(0), text,
                mask_predict_steps=4, dynamic=False)
    finally:
        pmmvid.build_spec = orig
    return {'seq': seq.numpy(), 'videos': videos.numpy()}


# -- helpers --------------------------------------------------------------

def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _normwise(got, want, dim, lr_sum, what=''):
    """Each parameter within TOL of ``want`` normwise; the key projection's
    bias (gradient exactly 0, moved by each run's Adam on its own rounding
    noise) within three times the lr summed over the steps."""
    for name, w in want.items():
        g = np.array(got[name], dtype=np.float64)
        w = np.array(w, dtype=np.float64)
        if name.endswith('attn.in_proj_bias'):
            kb = slice(dim, 2 * dim)
            assert np.abs(g[kb] - w[kb]).max() <= 3 * lr_sum, name
            g[kb] = w[kb]
        gap = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert gap <= TOL, f'{what} {name}: normwise gap {gap}'


def _tp_groups_agree(outs, tp):
    """The replicated parameters and the metrics bit-identical on each tp
    group's ranks."""
    for r, out in enumerate(outs):
        ref = outs[r - r % tp]
        assert out['metrics'] == ref['metrics'], r
        for name, p in ref['replicated'].items():
            assert np.array_equal(out['replicated'][name], p), (r, name)


def _hold_metrics(got, want, what):
    """JAX's tolerances (tests/test_pipeline.py:137-141): rtol 1e-5 on the
    losses, 1e-4 on grad_norm."""
    for i, (pm, wm) in enumerate(zip(got, want)):
        for k, v in wm.items():
            np.testing.assert_allclose(
                pm[k], v, rtol=NORM_TOL if k == 'grad_norm' else TOL,
                err_msg=f'{what} step {i} {k}')


# -- (a) the layout -------------------------------------------------------

def test_split_table_matches_jax_param_shardings(jax_model):
    """Every stack leaf of JAX's tiny param tree: its PartitionSpec on a
    tp=2 mesh equals the port's rule for it, and the port's parameter that
    holds it splits the matching dimension (kernels [in, out] against
    weights [out, in]); a column kernel's bias splits with it (JAX slices
    it at use)."""
    import jax

    from mmvid_tpu.parallel.mesh import make_mesh, param_shardings
    from mmvid_tpu_torch.utils.torch_compat import bert_params_to_torch
    _, params, _ = jax_model
    shardings = param_shardings(params, make_mesh(
        'dp=1,tp=2', devices=jax.devices()[:2]))
    specs = {'/'.join(str(k.key) for k in path): tuple(s.spec)
             for path, s in jax.tree_util.tree_flatten_with_path(
                 shardings)[0]}
    for path, spec in specs.items():
        assert tensor.jax_spec(path) == spec, path
    stack = {p[len('transformer/'):]: s for p, s in specs.items()
             if p.startswith('transformer/')}
    names = [n for n in bert_params_to_torch(params)
             if 'resblocks' in n]
    covered = set()
    for name in names:
        paths = tensor.jax_paths(name)
        jspecs = {stack[p] for p in paths}
        assert len(jspecs) == 1, (name, jspecs)
        (jspec,) = jspecs
        covered.update(paths)
        dim = tensor.split_dim(name)
        kernel = name.endswith('weight') and 'ln_' not in name
        if kernel:
            # kernel [in, out] column split (dim 1) is the weight's dim 0
            want = (None if jspec in ((), (None, None))
                    else 1 - jspec.index('tp'))
            assert dim == want, name
        elif dim is not None:
            assert tensor.split_dim(name.replace('bias', 'weight')) == 0, \
                name
        else:
            assert jspec in ((), (None,)), name
    assert covered == set(stack)


@pytest.mark.parametrize('route', ['all_reduce', 'collective'])
def test_shard_gather_roundtrip(ranks, route):
    rng = np.random.RandomState(0)
    sd = {'transformer.transformer.resblocks.0.attn.in_proj_weight':
          rng.randn(12, 4), 'resblocks.1.attn.in_proj_bias': rng.randn(12),
          'resblocks.0.attn.out_proj.weight': rng.randn(4, 4),
          'resblocks.0.mlp.c_fc.weight': rng.randn(16, 4),
          'resblocks.0.mlp.c_fc.bias': rng.randn(16),
          'resblocks.0.mlp.c_proj.weight': rng.randn(4, 16),
          'resblocks.0.ln_1.weight': rng.randn(4),
          'to_logits.1.weight': rng.randn(8, 4)}
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    for layout in ('tp2', 'tp4'):
        for out in ranks('_job_roundtrip', layout, sd=sd, route=route):
            for k, v in sd.items():
                assert np.array_equal(out[k], v), (layout, k)
    # rank 1 of 2 holds the second half of each of q, k and v
    w = torch.from_numpy(sd['transformer.transformer.resblocks.0.attn.'
                            'in_proj_weight'])
    got = tensor.shard(w, 'resblocks.0.attn.in_proj_weight', 2, 1)
    assert torch.equal(got, torch.cat([w[2:4], w[6:8], w[10:12]]))


# -- (b) the stack -----------------------------------------------------------

@pytest.fixture(scope='module')
def jax_stacks():
    """heads -> (numpy weights in the port's names, x, mask, JAX's output)
    at L 13 (no tp divides it)."""
    import jax
    import jax.numpy as jnp

    from mmvid_tpu.models.clip import ClipStackConfig as JaxClip
    from mmvid_tpu.models.clip import TransformerStack as JaxStack
    from mmvid_tpu_torch.models.clip import build_attention_mask
    from mmvid_tpu_torch.utils.torch_compat import stack_params_to_torch
    out = {}
    rng = np.random.RandomState(2)
    x = rng.randn(2, 13, 64).astype(np.float32)
    mask = build_attention_mask(13, 'mask_prev', (3, 9)).numpy()
    for heads in (2, 4):
        stack = JaxStack(JaxClip(width=64, layers=2, heads=heads))
        params = jax.jit(stack.init)(jax.random.PRNGKey(heads),
                                     jnp.asarray(x), jnp.asarray(mask))
        params = jax.tree_util.tree_map(np.asarray, params['params'])
        # nonzero biases, so a misplaced one shows
        params = jax.tree_util.tree_map(
            lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32)
            if a.ndim == 1 else a, params)
        y = np.asarray(jax.jit(lambda p: stack.apply({'params': p},
                                                     jnp.asarray(x),
                                                     jnp.asarray(mask)))(
            params))
        out[heads] = (stack_params_to_torch(params, 'resblocks'), x, mask,
                      y)
    return out


@pytest.mark.parametrize('layout,sp,route', [
    ('tp2', False, None), ('tp2', True, 'all_reduce'),
    ('tp2', True, 'collective'), ('tp4', True, 'all_reduce'),
    ('tp4', True, 'collective'), ('tp4', False, 'collective')])
def test_stack_matches_jax(ranks, jax_stacks, layout, sp, route):
    heads = LAYOUTS[layout] if layout == 'tp4' else 2
    sd, x, mask, want = jax_stacks[heads]
    one = _stack_run(_port_stack(sd, heads), x, mask)
    outs = ranks('_job_stack', layout, sd=sd, heads=heads, x=x, mask=mask,
                 sp=sp, route=route)
    _close(one['y'], want, TOL, 'one rank against JAX')
    for r, out in enumerate(outs):
        _close(out['y'], want, TOL, f'rank {r} against JAX')
        _close(out['dx'], one['dx'], TOL, f'rank {r} input gradient')
        for name, g in one['grads'].items():
            _close(out['grads'][name], g, TOL, f'rank {r} {name}')


def test_fused_ln_qkv_gate_is_refused_under_tp(monkeypatch):
    """The gate's kernel takes the whole [3D, D] projection (its shape
    checks): a split block refuses the gate before any collective."""
    from types import SimpleNamespace

    from mmvid_tpu_torch.models.clip import ClipStackConfig, TransformerStack
    monkeypatch.setenv('MMVID_FUSED_LNQKV', '1')
    stack = TransformerStack(ClipStackConfig(width=128, layers=1, heads=2),
                             dtype=torch.bfloat16)
    tensor.split_stack(stack, SimpleNamespace(size=2, rank=0,
                                              seq_parallel=False))
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match='MMVID_FUSED_LNQKV=1 with '
                                              'tp=2'):
        stack.resblocks[0](torch.zeros((1, 3, 128), dtype=torch.bfloat16))


def test_split_refuses_a_tp_that_does_not_divide_the_heads():
    from types import SimpleNamespace

    from mmvid_tpu_torch.models.clip import ClipStackConfig, TransformerStack
    stack = TransformerStack(ClipStackConfig(width=64, layers=1, heads=2))
    with pytest.raises(NotImplementedError, match='does not divide the '
                       'backbone\'s 2 heads'):
        tensor.split_stack(stack, SimpleNamespace(size=4, rank=0))


# -- (c) the step against JAX --------------------------------------------

@pytest.fixture(scope='module')
def jax_run(jax_model):
    """JAX's three one-device steps at batch 4: (tc, text, frames, draws,
    metrics, final state)."""
    import jax
    import jax.numpy as jnp

    from mmvid_tpu import training as jtrain
    from test_torch_training import TC, _batch, _jax_draws
    jmodel, _, _ = jax_model
    text, frames = _batch(jmodel.cfg, b=4, seed=1)
    step = jax.jit(jtrain.make_train_step(jmodel, TC))
    state = jtrain.create_train_state(jmodel, TC)
    jbatch = {'text': jnp.asarray(text), 'target': jnp.asarray(frames)}
    draws, metrics = [], []
    for i in range(STEPS):
        key = jax.random.PRNGKey(30 + i)
        state, m = step(state, jbatch, key)
        metrics.append({k: float(v) for k, v in m.items()})
        d = _jax_draws(jmodel.cfg, TC, key, 4)
        draws.append({'keep': d['keep'].numpy(), 'nfm': d['nfm'].numpy(),
                      'warp': {k: v.numpy() for k, v in d['warp'].items()}})
    return TC, text, frames, draws, metrics, jax.device_get(state)


@pytest.mark.parametrize('layout,sp', [('tp2', False), ('tp2', True),
                                       ('dp2tp2', True), ('dp2tp2', False)],
                         ids=['tp2', 'tp2_seq_parallel',
                              'dp2_tp2_seq_parallel', 'dp2_tp2'])
def test_step_matches_jax(ranks, jax_model, jax_run, layout, sp):
    import jax

    from mmvid_tpu_torch.utils.torch_compat import bert_params_to_torch
    from test_torch_training import _port_tc
    jmodel, params, vae_params = jax_model
    tc, text, frames, draws, jmetrics, jstate = jax_run
    outs = ranks('_job_jax_steps', layout, params=params,
                 vae_params=vae_params, text=text, frames=frames,
                 draws=draws, tc=dataclasses.asdict(_port_tc(tc)), sp=sp)
    _tp_groups_agree(outs, 2)
    if layout == 'dp2tp2':
        for out in outs[1:]:
            assert out['metrics'] == outs[0]['metrics']
    _hold_metrics(outs[0]['metrics'], [
        {k: m[k] for k in ('loss', 'loss_msm', 'loss_rel', 'loss_vid',
                           'grad_norm')} for m in jmetrics], layout)
    want = bert_params_to_torch(jax.tree_util.tree_map(np.asarray,
                                                       jstate.params))
    lr = training.make_lr_schedule(_port_tc(tc))
    _normwise(outs[0]['params'], want, jmodel.cfg.dim,
              sum(lr(c) for c in range(STEPS)), layout)
    adam = weights._find_state(jstate.opt_state, 'nu')
    mu = bert_params_to_torch(adam.mu)
    for name, t in outs[0]['mu'].items():
        _close(t, mu[name], TOL, f'mu {name}')


def test_train_state_from_jax_splits_params_and_moments(ranks, jax_model,
                                                       jax_run):
    """JAX's state after its three steps, carried onto tp = 2: each rank
    holds its shard of the params and moments, which gather back to JAX's
    (``bert_params_to_torch``) exactly."""
    import jax

    from mmvid_tpu_torch.utils.torch_compat import bert_params_to_torch
    _, _, vae_params = jax_model
    jstate = jax_run[-1]
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    params, opt_state = np_tree(jstate.params), np_tree(jstate.opt_state)
    adam = weights._find_state(opt_state, 'nu')
    want = {'params': bert_params_to_torch(params),
            'mu': bert_params_to_torch(adam.mu),
            'nu': bert_params_to_torch(adam.nu)}
    for out in ranks('_job_from_jax_state', 'tp2', params=params,
                     vae_params=vae_params, opt_state=opt_state,
                     step=int(jstate.step)):
        assert out['count'] == int(np.asarray(adam.count)) == STEPS
        for part, sd in want.items():
            for name, w in sd.items():
                assert np.array_equal(out[part][name], w), (part, name)


# -- (d) against one rank, and the planted faults ---------------------------

@pytest.fixture(scope='module')
def one_rank():
    return _job_generator_steps(mesh.LOCAL, None, tp_on=False)


def _gaps(out, want, dim=64):
    """The largest relative gap of the metrics and of the parameters
    (normwise, each; the key projection's bias, whose gradient is exactly
    0, within three times the lr summed over the steps, and left out)."""
    m = max(abs(p[k] - w[k]) / abs(w[k]) for p, w in zip(
        out['metrics'], want['metrics']) for k in w if w[k])
    gaps = []
    for n, w in want['params'].items():
        g = out['params'][n].copy()
        if n.endswith('attn.in_proj_bias'):
            kb = slice(dim, 2 * dim)
            assert np.abs(g[kb] - w[kb]).max() <= 3 * STEPS * \
                GEN_TC['learning_rate'], n
            g[kb] = w[kb]
        gaps.append(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
    return m, float(max(gaps))


@pytest.mark.parametrize('sp,fault', [
    (False, None), (True, None), (False, 'norm'), (False, 'bias'),
    (True, 'seq_grads')], ids=['tp2', 'tp2_seq_parallel', 'fault_norm',
                               'fault_bias', 'fault_seq_grads'])
def test_tp2_equals_one_rank_and_faults_fail(ranks, one_rank, sp, fault):
    """Nonzero biases, a constant lr: tp = 2 within TOL of one rank (its
    metrics and every parameter normwise); each planted fault out of it."""
    outs = ranks('_job_generator_steps', 'tp2', sp=sp, fault=fault)
    metric_gap, param_gap = _gaps(outs[0], one_rank)
    if fault is None:
        _tp_groups_agree(outs, 2)
        assert metric_gap <= TOL and param_gap <= TOL, (metric_gap,
                                                         param_gap)
    else:
        assert max(metric_gap, param_gap) > 10 * TOL, (fault, metric_gap,
                                                       param_gap)


def test_artv_step_tp2_equals_one_rank(ranks):
    want = _job_artv_step(mesh.LOCAL, None, tp_on=False)
    outs = ranks('_job_artv_step', 'tp2')
    _tp_groups_agree(outs, 2)
    metric_gap, param_gap = _gaps(outs[0], want)
    assert metric_gap <= TOL and param_gap <= TOL, (metric_gap, param_gap)


# -- (e) generation -----------------------------------------------------------

@pytest.mark.parametrize('sp', [False, True], ids=['tp2',
                                                   'tp2_seq_parallel'])
def test_generation_tp2_matches_one_rank(ranks, sp):
    """The port's counterpart of tests/test_sharded_generation.py::
    test_generation_tp_sharded_matches_replicated."""
    want = _job_generate(mesh.LOCAL, None, tp_on=False)
    for out in ranks('_job_generate', 'tp2', sp=sp):
        assert np.array_equal(out['seq'], want['seq'])
        _close(out['videos'], want['videos'], TOL, 'videos')


# -- (f) the driver -----------------------------------------------------------

def _launch(world, argv):
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    mp.start_processes(_launched_rank, args=(world, port, argv),
                       nprocs=world, start_method='spawn')


def test_driver_tp2_seq_parallel(clips, tmp_path):
    """Two launched ranks at tp=2 with --seq_parallel log the one-rank
    run's losses and write the one-rank layout, which resumes at tp=1."""
    from mmvid_tpu_torch import train as ptrain
    tp, one = tmp_path / 'tp', tmp_path / 'one'
    extra = ['--save_every_n_steps', '100', '--sample_every', '2']
    try:
        _launch(2, _driver_argv(clips, tp, 3, extra + [
            '--mesh_shape', 'tp=2', '--seq_parallel']))
        ptrain.main(_driver_argv(clips, one, 3, extra))
        got, want = _logged(tp / 'ddp'), _logged(one / 'ddp')
        assert [i for i, _ in got] == [0, 1, 2] == [i for i, _ in want]
        for (i, g), (_, w) in zip(got, want):
            _close(g, w, LOG_TOL, f'iter {i} loss, msm, rel, gnorm')
        assert sorted(os.listdir(tp / 'ddp' / 'samples')) == [
            '0000002_0.png', '0000002_captions.txt']
        a = torch.load(tp / 'ddp' / 'weights' / 'last' / 'dalle.pt',
                       map_location='cpu', weights_only=False)
        b = torch.load(one / 'ddp' / 'weights' / 'last' / 'dalle.pt',
                       map_location='cpu', weights_only=False)
        assert a['step'] == b['step'] == 3
        for part in ('weights', 'opt_state'):
            assert list(a[part]) == list(b[part])
            for k, v in b[part].items():
                assert a[part][k].shape == v.shape, (part, k)
        shutil.rmtree(one)
        # the tp checkpoint resumes in one process at tp = 1
        ptrain.main(_driver_argv(clips, tp, 4, extra + ['--auto_resume']))
        assert [i for i, _ in _logged(tp / 'ddp')] == [0, 1, 2, 3]
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.slow
def test_driver_dcn_dp_tp_four_ranks(clips, tmp_path):
    """Four launched ranks at dcn=2,dp=1,tp=2 with --seq_parallel log the
    one-rank run's losses (the dp axes fold, dcn-major)."""
    from mmvid_tpu_torch import train as ptrain
    four, one = tmp_path / 'four', tmp_path / 'one'
    extra = ['--save_every_n_steps', '100']
    try:
        _launch(4, _driver_argv(clips, four, 3, extra + [
            '--mesh_shape', 'dcn=2,dp=1,tp=2', '--seq_parallel']))
        ptrain.main(_driver_argv(clips, one, 3, extra))
        got, want = _logged(four / 'ddp'), _logged(one / 'ddp')
        assert [i for i, _ in got] == [0, 1, 2] == [i for i, _ in want]
        for (i, g), (_, w) in zip(got, want):
            _close(g, w, LOG_TOL, f'iter {i} loss, msm, rel, gnorm')
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize('extra,env,err,match', [
    (['--mesh_shape', 'dp=2,pp=2'], False, NotImplementedError, 'pp > 1'),
    (['--mesh_shape', 'tp=4'], True, NotImplementedError,
     'does not divide'),
    (['--mesh_shape', 'tp=2', '--seq_parallel'], False, ValueError,
     'needs 2 devices'),
], ids=['pp', 'tp_heads', 'tp_one_process'])
def test_driver_refusals(tmp_path, monkeypatch, extra, env, err, match):
    """Each raises before any process group starts."""
    from mmvid_tpu_torch import train as ptrain
    if env:
        monkeypatch.setenv('RANK', '0')
        monkeypatch.setenv('WORLD_SIZE', '4')
        monkeypatch.setenv('LOCAL_RANK', '0')
    with pytest.raises(err, match=match):
        ptrain.main(_driver_argv(tmp_path, tmp_path, 1, extra))
    assert not dist.is_initialized()


def test_seq_parallel_at_tp_one_is_the_plain_stack(tmp_path):
    """--seq_parallel without a tp axis is JAX's no-op constraint: one
    process takes it, and its ranks get no tensor-parallel context."""
    from mmvid_tpu_torch import train as ptrain
    from mmvid_tpu_torch.config import process_args
    args = process_args(train=True, argv=_driver_argv(
        tmp_path, tmp_path, 1, ['--seq_parallel', '--mesh_shape', 'dp=1']))
    ptrain.refuse_multi_device(args)
    assert mesh.spec_axes(args.mesh_shape)['tp'] == 1
    assert mesh.LOCAL.tp is tensor.LOCAL_TP


def test_int8_with_tp_is_refused(tmp_path):
    """The serving driver refuses --int8 with tp above 1, and so do the
    quantized stack and its frozen weights."""
    from mmvid_tpu_torch import test as ptest
    from mmvid_tpu_torch.config import process_args
    args = process_args(argv=['--image_text_folder', str(tmp_path),
                              '--dalle_path', str(tmp_path / 'x.pt'),
                              '--device', 'cpu', '--int8',
                              '--mesh_shape', 'tp=2'])
    with pytest.raises(NotImplementedError, match='int8 serving with tp=2'):
        ptest.main_worker(args)
    with pytest.raises(NotImplementedError, match='int8 serving with tp=2'):
        tensor.refuse_int8(2)
