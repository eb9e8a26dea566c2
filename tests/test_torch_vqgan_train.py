"""VQGAN finetuning in the port (``mmvid_tpu_torch/models/vqgan_losses.py``,
``models/lpips.py``, ``models/vqgan.py``'s training surface and
``train_vqgan.py``) held to ``mmvid_tpu`` on the CPU, at
tests/test_vqgan_train.py's ``TINY_VQ`` (32 px), on numpy-seeded weights
and inputs shared by both packages:

* ``VQModel.forward``'s reconstruction, codebook loss and ids, and the
  gradient of a scalar through the straight-through estimator;
* LPIPS on shared random VGG weights and the shipped lin weights;
* the discriminator in eval and train mode, and its running stats after
  the d step's two chained train-mode calls;
* the GAN steps from ``weights.vqgan_train_state_from_jax`` at
  ``disc_start`` 1: one g step and one d step with the count below it
  (the eight metrics, the gradients through Adam's first moments, the
  BatchNorm stats), three alternating steps (the GAN terms on from the
  second), and the second iteration from JAX's state after the first
  (Adam's moments and count carried over; the GAN gradients);
* torch's Adam against optax's over three steps;
* the segmentation VQGAN's step; ``GumbelQuantize`` at eval (exactly) and
  in training on JAX's noise;
* the driver (``--device cpu``, 2 iterations on a PNG folder): the log
  lines, the image stream against JAX's transforms, and the checkpoint
  through ``factories.taming_vqgan_state`` and JAX's own reader.

The JAX state is built from numpy at ``jax.eval_shape``'s shapes (no
eager flax init); each JAX baseline is computed once a module, and the
module runs in one thread.
"""

import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmvid_tpu.models import lpips as jlpips
from mmvid_tpu.models import vqgan as jvq
from mmvid_tpu.models import vqgan_losses as jvl
from mmvid_tpu_torch import factories, weights
from mmvid_tpu_torch import train_vqgan as ptrain
from mmvid_tpu_torch.data import png
from mmvid_tpu_torch.models import lpips as plpips
from mmvid_tpu_torch.models import vqgan as pvq
from mmvid_tpu_torch.models import vqgan_losses as pvl
from mmvid_tpu_torch.utils.torch_compat import vqgan_params_to_torch

TINY = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1,
            z_channels=64, embed_dim=64, n_embed=128, attn_resolutions=())
TINY_FLAGS = ['--image_size', '32', '--ch', '32', '--ch_mult', '1,2',
              '--num_res_blocks', '1', '--z_channels', '64',
              '--embed_dim', '64', '--n_embed', '128',
              '--attn_resolutions', '']
# the driver's default: Adam moves an entry by up to about lr whatever its
# gradient's size, so entries whose gradient is rounding noise part the two
# packages' trajectories by about lr a step; the default keeps that small
LR = 4.5e-6
ITERS = 3
# the GAN terms off at iteration 0 (the count 0 below it) and on from
# iteration 1 (read before the d step moves the count): one JAX compile
# holds both sides of the threshold
DISC_START = 1
# fp32 on both sides; reductions and convolutions sum in other orders
VALUE_RTOL = 1e-4
# gradients (Adam's first moments): of the largest entry of the tensor,
# or of GRAD_FLOOR x the largest of the whole model (a gradient that is
# zero in exact arithmetic, as the attention's k bias and a conv bias
# before a GroupNorm have, is rounding noise on both sides).  Each side's
# error is about 1e-5 of the terms it sums, and the terms cancel: a bias's
# gradient sums thousands of positions, and once the GAN term is on, the
# adaptive weight scales it to the nll's size at the decoder's end, where
# the two partly cancel.  JAX's own g-step gradient and the sum of its
# three terms' gradients, each taken alone, differ by up to 9e-4 of a
# tensor's largest entry at the second iteration here.
GRAD_TOL = 2e-3
GRAD_FLOOR = 1e-2
# parameters, absolute, a bound for each Adam update taken: Adam moves
# every entry by up to about lr whatever its gradient's size, so an entry
# whose gradient is rounding noise may move either way on either side;
# a misplaced or mistransposed weight is off by far more
PARAM_ATOL_PER_UPDATE = 2 * LR


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """torch's and the BLAS / OpenMP pools at one thread for the module,
    as tests/test_torch_drivers.py::_one_thread."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def _np_params(shapes, seed):
    """numpy values at a flax tree's shapes: kernels N(0, 1/fan_in),
    biases and norm offsets N(0, 0.05), scales 1 + N(0, 0.05), a codebook
    N(0, 1) (spread, so no two codes nearly tie), BatchNorm means
    N(0, 0.05) and variances 1 + |N(0, 0.1)|."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        leaf = path[-1].key
        r = rng.randn(*s.shape).astype(np.float32)
        if leaf == 'kernel':
            return r / np.sqrt(np.prod(s.shape[:-1]))
        if leaf == 'embedding':
            return r
        if leaf == 'scale':
            return 1 + 0.05 * r
        if leaf == 'var':
            return 1 + 0.1 * np.abs(r)
        return 0.05 * r

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _close(got, want, rtol, name='', floor=1e-30):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.max(np.abs(got - want)) if got.size else 0.0
    scale = max(np.max(np.abs(want)) if want.size else 0.0, floor)
    assert err <= rtol * scale, (name, err, scale)


def _close_grads(module, got, want):
    """``got(name, p)`` against ``want[name]`` for each parameter of
    ``module``, within GRAD_TOL (GRAD_FLOOR's floor)."""
    floor = GRAD_FLOOR * max(np.max(np.abs(np.asarray(v))) for v in
                             (want[n] for n, _ in module.named_parameters()))
    for name, p in module.named_parameters():
        _close(got(name, p), want[name], GRAD_TOL, name, floor)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a), (0, 3, 1, 2))))


def _images(seed, n=2, size=32):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32)


# --------------------------------------------------------------------------
# The JAX baselines, once a module
# --------------------------------------------------------------------------

def _jax_trainer(vgg):
    lc = jvl.VQGanLossConfig(learning_rate=LR, disc_start=DISC_START)
    return jvl.VQGanTrainer(jvq.VQGanConfig(**TINY), lc,
                            lpips=jlpips.LPIPS(vgg_params=vgg))


@pytest.fixture(scope='module')
def vgg():
    shapes = jax.eval_shape(jlpips.VGG16Features().init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    return _np_params(shapes['params'], 1)


@pytest.fixture(scope='module')
def state0(vgg):
    """JAX's VQGanTrainState at step 0 from numpy values."""
    tr = _jax_trainer(vgg)
    x = jnp.zeros((1, 32, 32, 3))
    g = _np_params(jax.eval_shape(tr.model.init, jax.random.PRNGKey(0),
                                  x)['params'], 2)
    shapes = jax.eval_shape(partial(tr.disc.init, train=False),
                            jax.random.PRNGKey(0), x)
    d = _np_params(shapes['params'], 3)
    ds = _np_params(shapes['batch_stats'], 4)
    return jvl.VQGanTrainState(
        step=jnp.zeros((), jnp.int32), g_params=g, g_opt=tr.g_tx.init(g),
        d_params=d, d_state=ds, d_opt=tr.d_tx.init(d))


@pytest.fixture(scope='module')
def jax_run(vgg, state0):
    """JAX's states and metrics through ITERS iterations at ``disc_start``
    DISC_START: ``states[k]`` after k half-steps (g, d, g, d ...),
    ``metrics[i]`` of iteration i."""
    tr = _jax_trainer(vgg)
    g_step, d_step = jax.jit(tr.make_g_step()), jax.jit(tr.make_d_step())
    x = _images(5)
    state, states, metrics = state0, [state0], []
    for _ in range(ITERS):
        state, gm = g_step(state, x)
        states.append(jax.device_get(state))
        state, dm = d_step(state, x)
        states.append(jax.device_get(state))
        metrics.append({k: float(v) for k, v in {**gm, **dm}.items()})
    return {'x': x, 'states': states, 'metrics': metrics}


def _port_trainer(vgg, state):
    lc = pvl.VQGanLossConfig(learning_rate=LR, disc_start=DISC_START)
    lp = plpips.LPIPS({k: torch.from_numpy(v) for k, v in
                       weights.lpips_vgg_from_jax(vgg).items()})
    tr = pvl.VQGanTrainer(pvq.VQGanConfig(**TINY), lc, lpips=lp,
                          device='cpu')
    weights.vqgan_train_state_from_jax(tr, state)
    return tr


def _check_state(tr, jstate):
    """The port's parameters, BatchNorm stats and Adam's first moments
    (the gradients, scaled) against JAX's state."""
    for module, opt, params, stats in (
            (tr.model, tr.g_opt, vqgan_params_to_torch(jstate.g_params), {}),
            (tr.disc, tr.d_opt, weights.flax_conv_bn_to_torch(
                {'params': jstate.d_params}), weights.flax_conv_bn_to_torch(
                {'params': {}, 'batch_stats': jstate.d_state}))):
        state = module.state_dict()
        updates = max([int(s['step']) for s in opt.state.values()] + [0])
        for k, want in params.items():
            np.testing.assert_allclose(
                state[k], want, rtol=0,
                atol=PARAM_ATOL_PER_UPDATE * updates + 1e-7, err_msg=k)
        for k, want in stats.items():
            _close(state[k], want, VALUE_RTOL, k)
    for opt, module, jopt, conv in (
            (tr.g_opt, tr.model, jstate.g_opt, vqgan_params_to_torch),
            (tr.d_opt, tr.disc, jstate.d_opt,
             lambda t: weights.flax_conv_bn_to_torch({'params': t}))):
        _close_grads(module, lambda n, p: opt.state[p]['exp_avg'],
                     conv(weights._find_state(jopt, 'nu').mu))


# --------------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------------

def test_vqmodel_forward_and_straight_through(state0):
    """xrec, qloss and ids, and d(sum(xrec * w) + qloss)/d params: the
    straight-through estimator carries z_q's gradient to the encoder,
    the codebook loss to the codebook."""
    params = state0.g_params
    x = _images(6)
    w = np.random.RandomState(7).randn(*x.shape).astype(np.float32)
    model = jvq.VQModel(jvq.VQGanConfig(**TINY))

    def scalar(p):
        xrec, q = model.apply({'params': p}, x)
        idx = model.apply({'params': p}, x, method=jvq.VQModel.encode)[2]
        return jnp.sum(xrec * w) + q, (xrec, q, idx)

    (_, (xrec, qloss, idx)), grads = jax.jit(jax.value_and_grad(
        scalar, has_aux=True))(params)

    pm = pvq.VQModel(pvq.VQGanConfig(**TINY))
    weights.load_weights(pm, vqgan_params_to_torch(params))
    got_rec, got_q = pm(_nchw(x))
    (torch.sum(got_rec * _nchw(w)) + got_q).backward()
    _close(got_rec.detach().permute(0, 2, 3, 1), xrec, VALUE_RTOL, 'xrec')
    _close(got_q.detach(), qloss, VALUE_RTOL, 'qloss')
    np.testing.assert_array_equal(
        pm.encode(_nchw(x))[2].numpy(), np.asarray(idx))
    _close_grads(pm, lambda n, p: p.grad,
                 vqgan_params_to_torch(jax.device_get(grads)))


def test_lpips_matches_jax(vgg):
    """LPIPS on shared random VGG weights and the shipped lin weights (its
    gradient is held in the g step's, whose nll it enters)."""
    x, y = _images(8), _images(9)
    want = jlpips.LPIPS(vgg_params=vgg)(x, y)
    port = plpips.LPIPS({k: torch.from_numpy(v) for k, v in
                         weights.lpips_vgg_from_jax(vgg).items()})
    with torch.no_grad():
        _close(port(_nchw(x), _nchw(y)), want, VALUE_RTOL, 'lpips')
    np.testing.assert_allclose(port(_nchw(x), _nchw(x)).numpy(), 0,
                               atol=1e-6)
    for w, lin in zip(jlpips.load_lpips_lin_weights(),
                      plpips.load_lin_weights()):
        np.testing.assert_array_equal(lin.numpy(), w)


def test_vgg16_loader_takes_torchvision_names(vgg):
    """A torchvision vgg16 state_dict (``features.N``) loads as JAX's
    ``convert_vgg16`` reads it."""
    tv = {}
    for i, t in enumerate(plpips.TORCHVISION_CONVS):
        k = vgg[f'conv_{i}']
        tv[f'features.{t}.weight'] = np.transpose(k['kernel'], (3, 2, 0, 1))
        tv[f'features.{t}.bias'] = k['bias']
    got = plpips.vgg16_state_to_port(tv)
    want = weights.lpips_vgg_from_jax(jlpips.convert_vgg16(tv))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_discriminator_modes_and_running_stats(state0):
    """Eval mode on the running averages; two chained train-mode calls
    (real, then fake): outputs and the running stats after, which flax
    moves with the biased batch variance."""
    disc = jvl.NLayerDiscriminator(64, 3)
    variables = {'params': state0.d_params, 'batch_stats': state0.d_state}
    real, fake = _images(10), _images(11)

    @jax.jit
    def run(v):
        out = disc.apply(v, fake, train=False)
        lr_, st = disc.apply(v, real, train=True, mutable=['batch_stats'])
        lf_, st = disc.apply({'params': v['params'], **st}, fake,
                             train=True, mutable=['batch_stats'])
        return out, lr_, lf_, st

    want_eval, lr_, lf_, st = run(variables)

    port = pvl.NLayerDiscriminator(64, 3)
    weights.load_weights(port, weights.flax_conv_bn_to_torch(variables))
    with torch.no_grad():
        _close(port(_nchw(fake), train=False).permute(0, 2, 3, 1),
               want_eval, VALUE_RTOL, 'eval')
        _close(port(_nchw(real), train=True).permute(0, 2, 3, 1), lr_,
               VALUE_RTOL, 'real')
        _close(port(_nchw(fake), train=True).permute(0, 2, 3, 1), lf_,
               VALUE_RTOL, 'fake')
    stats = weights.flax_conv_bn_to_torch(
        {'params': {}, 'batch_stats': st['batch_stats']})
    for k, v in stats.items():
        _close(port.state_dict()[k], v, VALUE_RTOL, k)


# --------------------------------------------------------------------------
# The GAN steps
# --------------------------------------------------------------------------

def test_first_g_and_d_step(jax_run, vgg, state0):
    """One g step, then one d step, from JAX's step-0 state: the eight
    metrics, the gradients (Adam's first moments), the parameters and the
    discriminator's running stats after each."""
    tr = _port_trainer(vgg, state0)
    x = _nchw(jax_run['x'])
    gm = tr.g_step(x)
    _check_state(tr, jax_run['states'][1])
    dm = tr.d_step(x)
    _check_state(tr, jax_run['states'][2])
    assert tr.step == 1
    want = jax_run['metrics'][0]
    got = {k: float(v) for k, v in {**gm, **dm}.items()}
    assert sorted(got) == sorted(want) and len(got) == 8
    for k in want:
        _close(got[k], want[k], VALUE_RTOL, k)
    # the count 0 is below DISC_START: no GAN term on either side
    assert got['discloss'] == 0.0 and got['aeloss'] == pytest.approx(
        got['nll'] + got['qloss'], rel=1e-6)


def test_three_alternating_steps(jax_run, vgg, state0):
    """ITERS iterations from step 0: every metric of every iteration, and
    the parameters, moments and stats at the end."""
    tr = _port_trainer(vgg, state0)
    x = _nchw(jax_run['x'])
    for i in range(ITERS):
        got = {k: float(v) for k, v in {**tr.g_step(x),
                                        **tr.d_step(x)}.items()}
        for k, v in jax_run['metrics'][i].items():
            _close(got[k], v, VALUE_RTOL, f'iter {i} {k}')
    assert tr.step == ITERS
    _check_state(tr, jax_run['states'][-1])


def test_step_from_a_later_state(jax_run, vgg):
    """The port loaded from JAX's state after the first iteration (Adam's
    moments and counts, the stats, the step count) takes the second
    iteration, the first with the GAN terms, as JAX does: its metrics,
    and the gradients of both sides in the moments."""
    tr = _port_trainer(vgg, jax_run['states'][2])
    assert tr.step == 1
    assert all(float(s['step']) == 1 for s in tr.g_opt.state.values())
    x = _nchw(jax_run['x'])
    got = {k: float(v) for k, v in {**tr.g_step(x),
                                    **tr.d_step(x)}.items()}
    for k, v in jax_run['metrics'][1].items():
        _close(got[k], v, VALUE_RTOL, k)
    assert got['discloss'] > 0
    _check_state(tr, jax_run['states'][4])


def test_adam_matches_optax():
    """torch's Adam (betas (0.5, 0.9), eps 1e-8) against optax.adam over
    three steps on the same gradients."""
    rng = np.random.RandomState(12)
    p0 = rng.randn(64).astype(np.float32)
    grads = [rng.randn(64).astype(np.float32) * s for s in (1, 1e-3, 10)]
    tx = optax.adam(3e-2, b1=0.5, b2=0.9)
    p, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    t = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = pvl.adam([t], 3e-2)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, upd)
        t.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(p),
                                   rtol=1e-6, atol=1e-7)


def test_segmentation_step():
    """One step of the segmentation VQGAN (BCE + codebook loss, Adam
    1e-4) on one-hot maps of 5 labels: loss, qloss and the gradients."""
    module = jvl.SegmentationVQModel(jvq.VQGanConfig(**TINY), n_labels=5)
    x = np.eye(5, dtype=np.float32)[np.random.RandomState(13).randint(
        0, 5, (2, 32, 32))]
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    params = _np_params(shapes['params'], 14)
    tx = optax.adam(1e-4)
    step = jax.jit(jvl.make_segmentation_train_step(module, tx))
    _, opt_state, m = step(params, tx.init(params), x)

    port = pvl.SegmentationVQModel(pvq.VQGanConfig(**TINY), n_labels=5)
    weights.load_weights(port.model, vqgan_params_to_torch(params['model']))
    opt = torch.optim.Adam(port.parameters(), lr=1e-4)
    got = pvl.make_segmentation_train_step(port, opt)(_nchw(x))
    for k in ('loss', 'qloss'):
        _close(float(got[k]), float(m[k]), VALUE_RTOL, k)
    _close_grads(port.model, lambda n, p: opt.state[p]['exp_avg'],
                 vqgan_params_to_torch(jax.device_get(
                     weights._find_state(opt_state, 'nu').mu['model'])))


def test_gumbel_quantize():
    """At eval the arg-max one-hot, exactly; in training on JAX's noise
    (the draw the JAX module makes from its key, fed to
    ``gumbel_quantize``): z_q, the scaled KL and the ids, and the
    gradient through the straight-through sample."""
    q = jvq.GumbelQuantize(n_embed=32, embed_dim=16)
    z = np.random.RandomState(15).randn(2, 4, 4, 16).astype(np.float32)
    params = _np_params(jax.eval_shape(q.init, jax.random.PRNGKey(1), z),
                        19)
    key = jax.random.PRNGKey(3)
    w = np.random.RandomState(16).randn(2, 4, 4, 16).astype(np.float32)

    @jax.jit
    def run(zz):
        def scalar(a):
            zq, kl, idx = q.apply(params, a, train=True, temp=0.9, rng=key)
            return jnp.sum(zq * w) + kl, (zq, kl, idx)

        noise = -jnp.log(-jnp.log(jax.random.uniform(
            key, (2, 4, 4, 32), minval=1e-20)))
        return (q.apply(params, zz, train=False),
                jax.value_and_grad(scalar, has_aux=True)(zz), noise)

    (zq, kl, idx), ((_, train_out), gz), noise = run(z)
    port = pvq.GumbelQuantize(32, 16)
    weights.load_weights(port, weights.gumbel_params_to_torch(
        params['params']))
    got = port(_nchw(z), train=False)
    np.testing.assert_array_equal(got[0].detach().permute(0, 2, 3, 1),
                                  np.asarray(zq))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(idx))
    _close(got[1].detach(), kl, VALUE_RTOL, 'kl eval')

    zq, kl, idx = train_out
    zt = _nchw(z).requires_grad_(True)
    got = pvq.gumbel_quantize(port.proj(zt), port.embed.weight,
                              _nchw(noise), temp=0.9)
    (torch.sum(got[0] * _nchw(w)) + got[1]).backward()
    _close(got[0].detach().permute(0, 2, 3, 1), zq, VALUE_RTOL, 'z_q')
    _close(got[1].detach(), kl, VALUE_RTOL, 'kl')
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(idx))
    _close(zt.grad.permute(0, 2, 3, 1), gz, GRAD_TOL, 'grad')
    # the module's own draw, from a generator
    zq2, _, idx2 = port(_nchw(z), train=True,
                        generator=torch.Generator().manual_seed(0))
    assert zq2.shape == (2, 16, 4, 4) and int(idx2.max()) < 32


# --------------------------------------------------------------------------
# The driver
# --------------------------------------------------------------------------

LOG_LINE = re.compile(r'iter (\d+) ae -?\d+\.\d{4} nll -?\d+\.\d{4} '
                      r'disc -?\d+\.\d{4} d_w -?\d+\.\d{3} \(\d+\.\ds\)')


@pytest.fixture(scope='module')
def image_folder(tmp_path_factory):
    """5 PNGs of 40 x 36 px (resized to 32 by the stream) in two
    subfolders."""
    root = tmp_path_factory.mktemp('vqgan_images')
    rng = np.random.RandomState(17)
    for i in range(5):
        d = root / f'clip{i % 2}'
        d.mkdir(exist_ok=True)
        png.write_png(d / f'{i:03d}.png',
                      rng.randint(0, 255, (40, 36, 3)).astype(np.uint8),
                      i % 5)
    return root


def test_image_stream_matches_jax(image_folder):
    """The batches the driver draws: the same files in the same order as
    JAX's driver, decoded and resized equal to its Pillow path."""
    from mmvid_tpu.data import transforms as jt
    paths = ptrain.image_paths(image_folder)
    assert len(paths) == 5
    r1, r2 = np.random.RandomState(42), np.random.RandomState(42)
    for _ in range(2):
        got = ptrain.image_batch(paths, r1, 3, 32)
        idx = r2.randint(0, len(paths), 3)
        want = np.stack([jt.to_array(jt.resize_exact(
            jt.open_rgb(paths[i]), (32, 32))) for i in idx]) * 2.0 - 1.0
        np.testing.assert_array_equal(got, want)


def test_driver_runs_and_saves_a_taming_ckpt(image_folder, tmp_path,
                                             capsys):
    """``--device cpu``, 2 iterations: JAX's log line on each, the
    checkpoint under weights/2 and weights/last read back by
    ``factories.taming_vqgan_state`` into the VQModel and by JAX's
    ``load_vqgan_checkpoint`` at its params' shapes; the default
    ``--device cuda`` raises on a host without a GPU."""
    from mmvid_tpu.utils.torch_compat import load_vqgan_checkpoint
    argv = ['--image_folder', str(image_folder), '--batch_size', '2',
            '--iters', '2', '--log_every', '1', '--log_root',
            str(tmp_path), '--name', 'ft'] + TINY_FLAGS
    record = ptrain.main(ptrain.parse_args(argv + ['--device', 'cpu']))
    out = capsys.readouterr().out
    assert '5 images found' in out and 'vqgan finetuning done' in out
    lines = (tmp_path / 'ft' / 'log.txt').read_text().splitlines()
    assert [LOG_LINE.fullmatch(ln).group(1) for ln in lines] == ['0', '1']
    assert len(record['iters']) == 2
    path = tmp_path / 'ft' / 'weights' / '2' / ptrain.CKPT_FILE
    assert record['saves'] == [str(path)]
    assert (tmp_path / 'ft' / 'weights' / 'last' / ptrain.CKPT_FILE).is_file()
    assert torch.load(path, weights_only=True)['global_step'] == 2
    sd = factories.taming_vqgan_state(str(path))
    model = pvq.VQModel(pvq.VQGanConfig(**TINY))
    weights.load_weights(model, sd)
    with torch.no_grad():
        ids = model.encode_indices(_nchw(_images(18)))
        assert torch.isfinite(model.decode_code(ids)).all()
    shapes = jax.eval_shape(
        jvq.VQModel(jvq.VQGanConfig(**TINY)).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 32, 32, 3)))['params']
    jparams = load_vqgan_checkpoint(str(path))
    assert (jax.tree_util.tree_structure(jparams)
            == jax.tree_util.tree_structure(shapes))
    assert all(a.shape == b.shape for a, b in zip(
        jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(shapes)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            ptrain.main(ptrain.parse_args(argv))
