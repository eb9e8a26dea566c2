"""The port's data-parallel training (``mmvid_tpu_torch/parallel/``, the
``dp`` argument of ``training.make_train_step``, the training driver's
ranks) on the CPU, held to JAX's step on its own ``dp`` mesh of the
conftest's virtual CPU devices.

Ranks are processes over gloo: a pool of three, started once for the
module (a ``FileStore`` under ``tmp_path``, one thread each, as
tests/test_torch_drivers.py::_one_thread runs the drivers), in which
ranks 0 and 1 form the two-rank group and all three the odd one; the
driver's ranks are started through its launcher environment.

* (a) ``parse_mesh_shape`` gives JAX's axes and errors;
* (b) three steps of the tiny flagship on two ranks equal three steps of
  JAX's ``jit_train_step(..., mesh=make_mesh('dp=2,tp=1'))`` at global
  batch 4 with ``rel_no_fully_masked`` and 6 (three rows a rank) without,
  on JAX's weights and JAX's draws, given global to every rank: the REL
  negatives and the VID's stolen frames cross ranks;
* (c) on the generator's draws (no hook), two ranks equal one rank at the
  same global batch: the flagship, the text+mask model with its random
  erasers, colour shift and control dropout, and three ranks at batch 3
  (the odd batch's roll);
* (d) the planted fault, per-rank means averaged (a naive DDP), fails
  (b)'s check;
* (e) the loader's per-rank blocks are disjoint and lay out the one-rank
  loader's batches;
* (f) ``python -m mmvid_tpu_torch.train --device cpu --dist_backend gloo``
  on two ranks writes one log, one set of checkpoints and one grid, logs
  the one-rank run's losses and resumes at the right iteration; the
  refusals raise.

Tolerances: JAX's (tests/test_torch_training.py: metrics and Adam's first
moments 1e-5, parameters ``_hold_params``); between the port's one and N
ranks, only the sums' order differs: metrics and moments 1e-5,
parameters 1e-5 but the key projection's bias (gradient exactly 0: each
run's Adam moves it by up to the lr a step on its own rounding noise),
held to three times the lr summed over the steps, as ``_hold_params``
does; the driver's logged losses (printed at 4 decimals) within 2e-4.
"""

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
from mmvid_tpu_torch.data import loader as ploader
from mmvid_tpu_torch.parallel import mesh

POOL = 3                       # ranks 0, 1: the pair; all three: the odd
TIMEOUT_S = 240
STEP_TOL = 1e-5
LOG_TOL = 2e-4
STEPS = 3


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """torch's and the BLAS / OpenMP pools at one thread for the module,
    as tests/test_torch_drivers.py::_one_thread: the one-rank runs in this
    process do not spin against the ranks and the other test workers."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


# -- the rank pool ------------------------------------------------------

def _rank_main(rank, world, store, jobs, results):
    """One rank of the pool: runs each job it is sent on its group's
    DataParallel (ranks outside a job's group answer None)."""
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{store}',
                            rank=rank, world_size=world)
    groups = {2: dist.new_group([0, 1]), 3: None}
    try:
        while True:
            job = jobs.get()
            if job is None:
                return
            name, n, kw = job
            try:
                out = None
                if rank < n:
                    dp = (NaiveDDP if kw.pop('naive', False)
                          else mesh.DataParallel)(torch.device('cpu'),
                                                  groups[n])
                    out = globals()[name](dp, **kw)
                results.put((rank, 'ok', out))
            except Exception:
                results.put((rank, 'error', traceback.format_exc()))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """run(job, n, **kw) -> the job's output on ranks 0..n-1."""
    ctx = mp.get_context('spawn')
    store = tmp_path_factory.mktemp('store') / 'store'
    jobs = [ctx.Queue() for _ in range(POOL)]
    results = ctx.Queue()
    old = os.environ.get('GLOO_SOCKET_IFNAME')
    os.environ['GLOO_SOCKET_IFNAME'] = 'lo'
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, POOL, str(store), jobs[r], results))
             for r in range(POOL)]
    for p in procs:
        p.start()

    def run(name, n, **kw):
        for q in jobs:
            q.put((name, n, dict(kw)))
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
        return [outs[r] for r in range(n)]

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


class NaiveDDP(mesh.DataParallel):
    """The planted fault: every normaliser a rank's own count, summed
    over ranks in the gradient's all-reduce as DDP would average them, so
    the step descends the mean of the ranks' mean losses."""

    def total(self, t):
        return t.detach() * self.world


# -- the jobs (each rank runs one; LOCAL runs it as one process) -----------

def _tree(x):
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return torch.as_tensor(x)


def _outcome(state, metrics):
    return {'metrics': metrics,
            'params': {n: p.detach().numpy().copy()
                       for n, p in state.params.items()},
            'mu': {n: t.numpy().copy()
                   for n, t in state.opt_state['mu'].items()}}


def _job_jax_steps(dp, params, vae_params, text, frames, draws, tc):
    """The tiny flagship on JAX's weights: a step for each of JAX's
    global draws, this rank's rows of the global batch."""
    model, _ = factories.flagship_train(tiny=True, dtype=torch.float32,
                                        device='cpu', seed=1, remat=True)
    weights.load_jax_params(model, params, vae_params)
    tc = training.TrainConfig(**tc)
    state = training.create_train_state(model, tc)
    step = training.make_train_step(model, tc, dp)
    batch = {'text': dp.rows(torch.from_numpy(text).long()),
             'target': dp.rows(torch.from_numpy(frames))}
    metrics = []
    for d in draws:
        state, m = step(state, batch, None, draws=_tree(d))
        metrics.append({k: float(v) for k, v in m.items()})
    return _outcome(state, metrics)


def _generator_batch(cfg, b, seed):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, 100, (b, cfg.text_seq_len))
    text[:, -2:] = 0
    size = cfg.image_size
    batch = {'text': torch.from_numpy(text).long(),
             'target': torch.from_numpy(rng.uniform(0, 1, (
                 b, cfg.num_targets, size, size, 3)).astype(np.float32))}
    if cfg.num_visuals:
        batch['visual'] = torch.from_numpy(rng.uniform(0, 1, (
            b, cfg.num_visuals, size, size, 3)).astype(np.float32))
    return batch


def _job_generator_steps(dp, b, tc, cvae, steps=STEPS):
    """The tiny flagship (with ``cvae``: one control frame through a
    cvae) from seed 2, this rank's rows of a global batch ``b``, each
    step's draws from a generator seeded from the step."""
    model, _ = factories.flagship(tiny=True, device='cpu', seed=2,
                                  use_cvae=cvae, param_dtype=torch.float32)
    tc = training.TrainConfig(**tc)
    state = training.create_train_state(model, tc)
    step = training.make_train_step(model, tc, dp)
    batch = {k: dp.rows(v) for k, v in
             _generator_batch(model.cfg, b, 7).items()}
    metrics = []
    for i in range(steps):
        state, m = step(state, batch, torch.Generator().manual_seed(40 + i))
        metrics.append({k: float(v) for k, v in m.items()})
    return _outcome(state, metrics)


def _job_swap(dp, x, w):
    """REL's negative of the global batch ``x`` and its gradient under
    the weights ``w``: (this rank's negatives, this rank's gradient)."""
    xs = dp.rows(torch.from_numpy(x)).requires_grad_(True)
    from mmvid_tpu_torch.models.bert import swap_halves
    neg = swap_halves(xs, dp)
    (g,) = torch.autograd.grad((neg * dp.rows(torch.from_numpy(w))).sum(),
                               xs)
    return neg.detach().numpy(), g.numpy()


# -- helpers --------------------------------------------------------------

def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _hold_port(got, want, dim, lr_sum):
    """Parameters of two port runs: STEP_TOL, the key projection's bias
    within three times the lr summed over the steps."""
    for name, p in want.items():
        g = got[name].copy()
        if name.endswith('attn.in_proj_bias'):
            kb = slice(dim, 2 * dim)
            assert np.abs(g[kb] - p[kb]).max() <= 3 * lr_sum, name
            g[kb] = p[kb]
        _close(g, p, STEP_TOL, name)


def _same_on_ranks(outs):
    """Every rank ends with rank 0's parameters, bit for bit."""
    for out in outs[1:]:
        for name, p in outs[0]['params'].items():
            assert np.array_equal(out['params'][name], p), name
        assert out['metrics'] == outs[0]['metrics']


# -- (a) the mesh spec ------------------------------------------------------

@pytest.mark.parametrize('spec,n', [
    (None, 8), (None, 1), ('dp=4,tp=2', 8), ('dcn=2,dp=2,pp=2,tp=2', 16),
    ('dp=2', 2), ('dcn=2,dp=3', 6), (' dp=2,tp=1', 2), ('dp=4', 8),
    ('pp=2,tp=1', 3), ('foo=2', 2), ('dp=x', 2)])
def test_parse_mesh_shape_matches_jax(spec, n):
    from mmvid_tpu.parallel import mesh as jmesh
    try:
        want = jmesh.parse_mesh_shape(spec, n)
    except Exception as e:
        with pytest.raises(type(e)) as got:
            mesh.parse_mesh_shape(spec, n)
        assert str(got.value) == str(e)
        return
    assert mesh.parse_mesh_shape(spec, n) == want
    assert mesh.MESH_AXES == jmesh.MESH_AXES


# -- (b), (d) against JAX's dp mesh ----------------------------------------

@pytest.fixture(scope='module')
def jax_model():
    """JAX's tiny flagship (test_torch_training.py's, built once): (model,
    numpy params, numpy VQGAN params)."""
    import jax
    import jax.numpy as jnp

    from mmvid_tpu.models import bert as jbert
    from mmvid_tpu.models.clip import ClipStackConfig as JaxClip
    from mmvid_tpu.models.mmvid import MMVIDBert as JaxMMVID
    from mmvid_tpu.models.vqgan import VQGanConfig as JaxVQCfg
    from mmvid_tpu.models.vqgan import VQGanVAE as JaxVAE
    from test_torch_training import _spread
    vq = JaxVQCfg(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                  z_channels=64, embed_dim=64, n_embed=1024,
                  attn_resolutions=())
    k_vae, k_bert = jax.random.split(jax.random.PRNGKey(0))
    vae_params = _spread(jax.jit(JaxVAE(image_size=16, cfg=vq,
                                        params={}).init_params)(k_vae), 1)
    vae = JaxVAE(image_size=16, cfg=vq, params=vae_params)
    cfg = jbert.BertConfig(dim=64, num_text_tokens=100, text_seq_len=8,
                           num_visuals=0, num_targets=2,
                           num_image_tokens=1024, image_fmap_size=8,
                           image_size=16,
                           clip=JaxClip(width=64, layers=2, heads=2))
    params = jax.jit(jbert.BertCore(cfg).init)(
        k_bert, jnp.zeros((1, cfg.text_seq_len), jnp.int32), None,
        jnp.zeros((1, cfg.target_seq_len), jnp.int32))['params']
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return JaxMMVID(cfg, vae, params=params), np_tree(params), \
        np_tree(vae_params)


@pytest.fixture(scope='module')
def jax_runs(jax_model):
    """(rel_no_fully_masked, global batch) -> JAX's three mesh steps:
    (tc, text, frames, the global draws, metrics, final state), cached."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from mmvid_tpu import training as jtrain
    from mmvid_tpu.parallel.mesh import make_mesh
    from test_torch_training import TC, _batch, _jax_draws
    jmodel, _, _ = jax_model
    cache = {}

    def get(rel_nfm, b):
        if (rel_nfm, b) not in cache:
            tc = dataclasses.replace(TC, rel_no_fully_masked=rel_nfm)
            text, frames = _batch(jmodel.cfg, b=b, seed=1)
            step = jtrain.jit_train_step(
                jmodel, tc, mesh=make_mesh('dp=2,tp=1',
                                           devices=jax.devices()[:2]))
            state = step.shard_state(jtrain.create_train_state(jmodel, tc))
            jbatch = {'text': jnp.asarray(text),
                      'target': jnp.asarray(frames)}
            draws, metrics = [], []
            for i in range(STEPS):
                key = jax.random.PRNGKey(30 + i)
                state, m = step(state, jbatch, key)
                metrics.append({k: float(v) for k, v in m.items()})
                d = _jax_draws(jmodel.cfg, tc, key, b)
                draws.append({'keep': d['keep'].numpy(),
                              'nfm': d['nfm'].numpy(),
                              'warp': {k: v.numpy()
                                       for k, v in d['warp'].items()}})
            cache[rel_nfm, b] = (tc, text, frames, draws, metrics,
                                 jax.device_get(state))
        return cache[rel_nfm, b]

    return get


def _port_on_jax(ranks, jax_model, run, naive=False):
    from test_torch_training import _port_tc
    import dataclasses
    _, params, vae_params = jax_model
    tc, text, frames, draws, _, _ = run
    return ranks('_job_jax_steps', 2, params=params, vae_params=vae_params,
                 text=text, frames=frames, draws=draws,
                 tc=dataclasses.asdict(_port_tc(tc)), naive=naive)


def _hold_jax(out, run, jmodel):
    """One rank's three steps against JAX's mesh steps."""
    from mmvid_tpu_torch.utils.torch_compat import bert_params_to_torch
    from test_torch_training import _hold_params, _port_tc
    from mmvid_tpu_torch import weights as pweights
    tc, _, _, _, jmetrics, jstate = run
    for i, (pm, jm) in enumerate(zip(out['metrics'], jmetrics)):
        for k in ('loss', 'loss_msm', 'loss_rel', 'loss_vid', 'grad_norm'):
            _close(pm[k], jm[k], STEP_TOL, f'step {i} {k}')
    _hold_params({n: torch.from_numpy(p) for n, p in out['params'].items()},
                 jstate.params, jmodel.cfg.dim,
                 sum(training.make_lr_schedule(_port_tc(tc))(c)
                     for c in range(STEPS)))
    adam = pweights._find_state(jstate.opt_state, 'nu')
    mu = bert_params_to_torch(adam.mu)
    for name, t in out['mu'].items():
        _close(t, mu[name], STEP_TOL, f'mu {name}')


@pytest.mark.parametrize('rel_nfm,b', [(True, 4), (False, 6)],
                         ids=['rel_nfm', 'no_rel_nfm_odd_split'])
def test_two_ranks_match_jax_dp_mesh(ranks, jax_model, jax_runs, rel_nfm,
                                     b):
    """Parameters, moments and metrics of both ranks within JAX's
    tolerance of its dp=2 mesh; the ranks bit-identical.  Rank 0 holds
    rows [0, b/2), so every row's REL partner (i + b/2) mod b is on the
    other rank."""
    run = jax_runs(rel_nfm, b)
    outs = _port_on_jax(ranks, jax_model, run)
    _same_on_ranks(outs)
    _hold_jax(outs[0], run, jax_model[0])
    stolen = [(d['warp']['strategy'] == 0)
              & (d['warp']['i_other'] // (b // 2) != np.arange(b) // (b // 2))
              for d in run[3]]
    assert np.any(stolen), 'no VID negative stole across ranks'


def test_naive_ddp_normalisation_fails(ranks, jax_model, jax_runs):
    """Per-rank means averaged (every normaliser the rank's own count):
    the loss and the parameters leave JAX's tolerance."""
    run = jax_runs(True, 4)
    out = _port_on_jax(ranks, jax_model, run, naive=True)[0]
    gap = abs(out['metrics'][0]['loss'] - run[4][0]['loss'])
    assert gap > 100 * STEP_TOL, gap
    with pytest.raises(AssertionError):
        _hold_jax(out, run, jax_model[0])


# -- (c) N ranks against one, on the generator's draws ---------------------

GEN_TC = dict(learning_rate=1e-3, lr_scheduler='warmuplr',
              lr_scheduler_warmup=2, rel_no_fully_masked=True,
              msm_bernoulli_prob=(0.2, 0.5), pc_prob=0.5)


@pytest.mark.parametrize('n,b,cvae,extra', [
    (2, 4, False, {}),
    (2, 4, True, dict(rand_visual=True, vc_mode='mask_8x8',
                      visual_aug_mode='motion_color', dropout_vc=0.4)),
    (3, 3, False, {})], ids=['flagship', 'text_mask', 'three_ranks_odd'])
def test_ranks_equal_one_rank_on_generator_draws(ranks, n, b, cvae, extra):
    tc = dict(GEN_TC, **extra)
    want = _job_generator_steps(mesh.LOCAL, b=b, tc=tc, cvae=cvae)
    outs = ranks('_job_generator_steps', n, b=b, tc=tc, cvae=cvae)
    _same_on_ranks(outs)
    for i, (pm, wm) in enumerate(zip(outs[0]['metrics'], want['metrics'])):
        for k, v in wm.items():
            _close(pm[k], v, STEP_TOL, f'step {i} {k}')
    for name, t in want['mu'].items():
        _close(outs[0]['mu'][name], t, STEP_TOL, f'mu {name}')
    lr = training.make_lr_schedule(training.TrainConfig(**tc))
    _hold_port(outs[0]['params'], want['params'], 64,
               sum(lr(c) for c in range(STEPS)))


def test_swap_halves_crosses_ranks(ranks):
    """REL's negative over three ranks at batch 3 (the roll) and two at
    batch 4: the global batch's, with each partner's gradient on the
    rank that owns it."""
    from mmvid_tpu_torch.models.bert import swap_halves
    rng = np.random.RandomState(5)
    for n, b in ((3, 3), (2, 4)):
        x = rng.randn(b, 2, 3).astype(np.float32)
        w = rng.randn(b, 2, 3).astype(np.float32)
        xt = torch.from_numpy(x).requires_grad_(True)
        neg = swap_halves(xt)
        (g,) = torch.autograd.grad((neg * torch.from_numpy(w)).sum(), xt)
        outs = ranks('_job_swap', n, x=x, w=w)
        assert np.array_equal(np.concatenate([o[0] for o in outs]),
                              neg.detach().numpy())
        assert np.array_equal(np.concatenate([o[1] for o in outs]),
                              g.numpy())


# -- (e) the loader's blocks ------------------------------------------------

class _Ids:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {'i': np.int64(i)}


@pytest.mark.parametrize('n,world,b', [(24, 2, 3), (25, 3, 2), (16, 4, 2)])
def test_loader_blocks_are_disjoint_and_lay_out_one_rank(n, world, b):
    one = ploader.DataLoader(_Ids(n), batch_size=world * b, num_workers=1,
                             seed=3)
    shards = [ploader.DataLoader(_Ids(n), batch_size=b, num_workers=1,
                                 seed=3, process_index=r,
                                 process_count=world, shard='block')
              for r in range(world)]
    for epoch in range(2):
        for ld in [one] + shards:
            ld.set_epoch(epoch)
        got = [[x['i'].tolist() for x in ld] for ld in shards]
        assert all(len(g) == len(one) == n // (world * b) for g in got)
        seen = [i for g in got for x in g for i in x]
        assert len(seen) == len(set(seen))
        assert [sum((g[k] for g in got), []) for k in range(len(one))] == \
            [x['i'].tolist() for x in one]
    starts = [[x['i'].tolist() for x, _ in zip(
        ploader.infinite_batches(ld, start=3), range(2))] for ld in shards]
    whole = [x['i'].tolist() for x, _ in zip(
        ploader.infinite_batches(one, start=3), range(2))]
    assert [sum((s[k] for s in starts), []) for k in range(2)] == whole


# -- (f) the driver ----------------------------------------------------------

@pytest.fixture(scope='module')
def clips(tmp_path_factory):
    """8 clips of 10 frames at 32 px."""
    from mmvid_tpu_torch.data import png
    root = tmp_path_factory.mktemp('ddp') / 'mmvox'
    rng = np.random.RandomState(1)
    for i in range(8):
        key = f'id{i:05d}#c{i}#000'
        d = root / 'video' / key
        d.mkdir(parents=True)
        for j in range(10):
            png.write_png(d / f'{j:03d}.png',
                          rng.randint(0, 255, (32, 32, 3)).astype(np.uint8))
        (root / 'txt').mkdir(exist_ok=True)
        (root / 'txt' / f'{key}.txt').write_text(f'person {i} talks\n')
    yield root
    shutil.rmtree(root.parent, ignore_errors=True)


def _driver_argv(tree, logs, iters, extra=()):
    return ['--image_text_folder', str(tree), '--dataset', 'video_text',
            '--name', 'ddp', '--log_root', str(logs), '--batch_size', '4',
            '--iters', str(iters), '--num_visuals', '0',
            '--which_transformer', 'custom:64:2:2', '--dim', '64',
            '--text_seq_len', '12', '--num_targets', '2', '--frame_num', '2',
            '--frame_step', '2', '--image_size', '32', '--device', 'cpu',
            '--save_every_n_steps', '2', '--log_every', '1',
            '--sample_every', '2', '--n_sample', '1', '--n_per_sample', '1',
            '--mask_predict_steps', '1', '--num_workers', '1',
            '--lr_scheduler_warmup', '2', '--rel_no_fully_masked',
            '--beta_vid', '0', '--use_html', '--deterministic',
            '--dist_backend', 'gloo',
            *extra]


def _launched_rank(rank, world, port, argv):
    """One rank as ``python -m torch.distributed.run`` starts it."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                      MASTER_PORT=str(port), GLOO_SOCKET_IFNAME='lo')
    torch.set_num_threads(1)
    from mmvid_tpu_torch import train
    train.main(argv)


def _launch(world, argv):
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    mp.start_processes(_launched_rank, args=(world, port, argv),
                       nprocs=world, start_method='spawn')


def _logged(log_dir):
    lines = [ln.split() for ln in (log_dir / 'log.txt').read_text(
    ).splitlines() if ln.startswith('iter ')]
    return [(int(w[1]), [float(w[k]) for k in (3, 5, 7, 11)])
            for w in lines]


def test_driver_two_ranks(clips, tmp_path):
    from mmvid_tpu_torch import train as ptrain
    from mmvid_tpu_torch.config import process_args
    two, one = tmp_path / 'two', tmp_path / 'one'
    _launch(2, _driver_argv(clips, two, 3))
    _launch(2, _driver_argv(clips, two, 4, ['--auto_resume']))
    ptrain.main(_driver_argv(clips, one, 4))
    got, want = _logged(two / 'ddp'), _logged(one / 'ddp')
    # one log, each iteration once, the resume from iteration 3
    assert [i for i, _ in got] == [0, 1, 2, 3] == [i for i, _ in want]
    for (i, g), (_, w) in zip(got, want):
        _close(g, w, LOG_TOL, f'iter {i} loss, msm, rel, gnorm')
    for run, saved in ((two, ['2', '3', '4', 'last']),
                       (one, ['2', '4', 'last'])):
        d = run / 'ddp'
        assert sorted(os.listdir(d / 'weights')) == saved
        assert sorted(os.listdir(d / 'samples')) == [
            '0000002_0.png', '0000002_captions.txt']
        assert (d / 'args.txt').is_file() and (d / 'web').is_dir()
    w2 = torch.load(two / 'ddp' / 'weights' / 'last' / 'dalle.pt',
                    map_location='cpu', weights_only=False)
    w1 = torch.load(one / 'ddp' / 'weights' / 'last' / 'dalle.pt',
                    map_location='cpu', weights_only=False)
    assert w2['step'] == w1['step'] == 4
    lr = training.make_lr_schedule(ptrain.train_config(
        process_args(train=True, argv=_driver_argv(clips, one, 4))))
    _hold_port({k: v.numpy() for k, v in w2['weights'].items()
                if not k.startswith('vae.')},
               {k: v.numpy() for k, v in w1['weights'].items()
                if not k.startswith('vae.')}, 64, sum(lr(c) for c in
                                                      range(4)))


@pytest.mark.parametrize('extra,env,err,match', [
    (['--dist_backend', 'nccl'], True, RuntimeError, 'nccl runs on CUDA'),
    (['--mesh_shape', 'tp=2'], True, NotImplementedError, 'tp > 1'),
    (['--mesh_shape', 'dp=2,pp=2'], False, NotImplementedError, 'pp > 1'),
    (['--seq_parallel'], False, NotImplementedError, 'seq_parallel'),
    (['--mesh_shape', 'dp=2'], False, ValueError, 'needs 2 devices'),
    (['--multiprocessing_distributed'], False, RuntimeError,
     'one rank a visible GPU'),
    (['--dist_backend', 'mpi'], True, ValueError, 'expected nccl or gloo'),
], ids=['nccl_on_cpu', 'tp', 'pp', 'seq_parallel', 'dp_one_process',
        'spawn_on_cpu', 'backend'])
def test_driver_refusals(tmp_path, monkeypatch, extra, env, err, match):
    """Each raises before any process group starts, under the launcher's
    environment (``env``) or in one process."""
    from mmvid_tpu_torch import train as ptrain
    if env:
        monkeypatch.setenv('RANK', '0')
        monkeypatch.setenv('WORLD_SIZE', '1')
        monkeypatch.setenv('LOCAL_RANK', '0')
    with pytest.raises(err, match=match):
        ptrain.main(_driver_argv(tmp_path, tmp_path, 1, extra))
    assert not dist.is_initialized()
