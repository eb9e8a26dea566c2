"""The port's evaluation (``mmvid_tpu_torch/eval``) against the JAX
package's (``mmvid_tpu/eval``), on the CPU, inputs from a numpy seed.

* TF1's legacy bilinear resize, the ping-pong indices and the Fréchet
  distance: to 1e-6 (the same fp32 / fp64 arithmetic).
* I3D at full width on [1, 9, 224, 224, 3] and InceptionV3 on
  [1, 299, 299, 3], both on the same random weights (numpy, at the shapes
  of ``jax.eval_shape`` of the flax ``init``: an eager init of I3D takes
  about 45 s here), carried over by ``weights.load_conv_bn_variables``:
  within 1e-4 of the output's largest magnitude (fp32 convolutions
  summed in another order); ``inception_preprocess`` up- and
  down-sampling (JAX's antialiased resize) within 1e-5.
* ``evaluate`` with both packages' generation stubbed to give the same
  videos (real clips of 3 frames, generated of 2, so each source length
  has its own ping-pong), the same I3D variables: the embeddings within
  1e-4 of their largest magnitude, FVD within 1e-3 relative, the same
  artifacts and the same ``n_samples``.
* PRD: the curve and its (F_8, F_1/8) pair exact; on well-separated
  clusters the binning is unambiguous and the pair equals JAX's (sklearn
  ``MiniBatchKMeans``) to 1e-12; on random embeddings the port's pair
  lies within the range of JAX's own runs.
"""

import os
import pickle
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvid_tpu.eval import evaluate as jeval
from mmvid_tpu.eval import fvd as jfvd
from mmvid_tpu.eval import prd as jprd
from mmvid_tpu.eval.i3d import I3D as JaxI3D
from mmvid_tpu.eval.inception import InceptionV3 as JaxInception
from mmvid_tpu.eval.inception import inception_preprocess as jax_inc_pre
from mmvid_tpu.models.mmvid import DEFAULT_MP_CONFIG
from mmvid_tpu_torch import weights
from mmvid_tpu_torch.eval import evaluate as peval
from mmvid_tpu_torch.eval import fvd, prd
from mmvid_tpu_torch.eval.i3d import I3D
from mmvid_tpu_torch.eval.inception import InceptionV3, inception_preprocess

EXACT = 1e-6
NET_TOL = 1e-4       # of the output's largest magnitude
FVD_RTOL = 1e-3


def random_variables(module, shape, seed):
    """{'params', 'batch_stats'} at the shapes of ``module.init`` (by
    ``jax.eval_shape``), drawn with numpy: kernels N(0, 2 / fan_in),
    variances U(0.5, 1.5), biases and means N(0, 0.1)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros(shape))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == 'kernel':
            fan = np.prod(s.shape[:-1])
            return (rng.randn(*s.shape) * np.sqrt(2.0 / fan)).astype(
                np.float32)
        if leaf == 'var':
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture
def one_thread():
    """torch's and the BLAS / OpenMP pools at one thread: small ops run as
    fast in one, and do not spin against the other test workers'
    threads (the suite runs six processes on the CPU)."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope='module')
def i3d_vars():
    return random_variables(JaxI3D(), (1, 9, 224, 224, 3), 0)


def _close(got, want, tol, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


# ---- resize, ping-pong, Fréchet distance ----

@pytest.mark.parametrize('shape,th,tw', [((2, 5, 7, 3), 11, 4),
                                          ((3, 16, 16, 3), 224, 224),
                                          ((1, 128, 96, 3), 224, 224),
                                          ((1, 6, 6, 2), 6, 6)])
def test_tf1_resize_bilinear_matches_jax(shape, th, tw):
    img = np.random.RandomState(5).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jfvd.tf1_resize_bilinear(jnp.asarray(img), th, tw))
    got = fvd.tf1_resize_bilinear(torch.from_numpy(img), th, tw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)


def test_preprocess_videos_matches_jax():
    v = np.random.RandomState(6).uniform(0, 1, (2, 3, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jfvd.preprocess_videos(jnp.asarray(v)))
    got = fvd.preprocess_videos(torch.from_numpy(v)).numpy()
    assert got.shape == (2, 3, 224, 224, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)


@pytest.mark.parametrize('t,target', [(1, 15), (2, 15), (3, 16), (8, 15),
                                      (15, 15), (20, 16)])
def test_pingpong_matches_jax(t, target):
    np.testing.assert_array_equal(fvd.pingpong_indices(t, target),
                                  jfvd.pingpong_indices(t, target))
    clip = np.arange(t * 2).reshape(t, 2)
    np.testing.assert_array_equal(fvd.extend_video_pingpong(clip, target),
                                  jfvd.extend_video_pingpong(clip, target))


@pytest.mark.parametrize('n,d', [(50, 8), (4, 400)])
def test_frechet_distance_matches_jax(n, d, one_thread):
    rng = np.random.RandomState(d)
    x, y = rng.randn(n, d), rng.randn(n, d) * 1.5 + 0.3
    want = jfvd.frechet_distance(x, y)
    assert fvd.frechet_distance(x, y) == pytest.approx(want, rel=EXACT)
    assert abs(fvd.frechet_distance(x, x)) <= EXACT * np.trace(
        np.atleast_2d(np.cov(x, rowvar=False)))


# ---- the embedding networks at full width ----

def test_i3d_full_width_matches_jax(i3d_vars):
    x = np.random.RandomState(1).uniform(-1, 1, (1, 9, 224, 224, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(JaxI3D().apply)(i3d_vars, x))
    model = I3D().eval()
    weights.load_conv_bn_variables(model, i3d_vars)
    with torch.no_grad():
        got = model.embed(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 400)
    _close(got, want, NET_TOL, 'I3D logits')


def test_inception_full_width_matches_jax():
    variables = random_variables(JaxInception(), (1, 299, 299, 3), 2)
    x = np.random.RandomState(3).uniform(-1, 1, (1, 299, 299, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(JaxInception().apply)(variables, x))
    model = InceptionV3().eval()
    weights.load_conv_bn_variables(model, variables)
    with torch.no_grad():
        got = model.embed(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 2048)
    _close(got, want, NET_TOL, 'InceptionV3 pool_3')


@pytest.mark.parametrize('size', [40, 400])
def test_inception_preprocess_matches_jax(size):
    """Up-sampling (40 -> 299) and down-sampling (400 -> 299, where JAX's
    resize antialiases).  The port's products are fp32 to 1e-6 of an fp64
    product with JAX's own weight matrices; JAX's CPU product lies up to
    1e-5 (of [0, 1] values) from it, so the two packages are held to
    3e-5 of the [-1, 1] output."""
    from jax._src.image.scale import _fill_triangle_kernel, \
        compute_weight_mat
    img = np.random.RandomState(size).uniform(0, 1, (2, size, size, 3)
                                              ).astype(np.float32)
    want = np.asarray(jax_inc_pre(jnp.asarray(img)))
    got = inception_preprocess(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)
    w = np.asarray(compute_weight_mat(size, 299, jnp.float32(299 / size),
                                      jnp.float32(0.0),
                                      _fill_triangle_kernel, True),
                   np.float64)
    exact = np.einsum('bhwc,hH->bHwc', img.astype(np.float64), w)
    exact = np.einsum('bHwc,wW->bHWc', exact, w)
    np.testing.assert_allclose(got, exact * 2 - 1, rtol=0, atol=2 * EXACT)


# ---- evaluate ----

class _PortStub(torch.nn.Module):
    """The port's side of a model whose generation returns given videos."""

    def __init__(self, fakes, cfg):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))
        self.fakes, self.cfg, self.calls = list(fakes), cfg, []

    def generate_images(self, generator, text, **kw):
        self.calls.append(kw)
        return torch.from_numpy(self.fakes.pop(0)), None


class _JaxStub:
    def __init__(self, fakes, cfg):
        self.fakes, self.cfg = list(fakes), cfg

    def generate_images(self, key, text, **kw):
        return jnp.asarray(self.fakes.pop(0)), None


def _eval_inputs(seed, steps, batch):
    rng = np.random.RandomState(seed)
    real = [{'text': rng.randint(1, 100, (batch, 8)),
             'target': rng.uniform(0, 1, (batch, 3, 16, 16, 3)).astype(
                 np.float32)} for _ in range(steps)]
    fake = [rng.uniform(0, 1, (batch, 2, 16, 16, 3)).astype(np.float32)
            for _ in range(steps)]
    return real, fake


def _args(out_dir, **kw):
    return types.SimpleNamespace(
        log_metric_dir=str(out_dir), seed=0, num_targets=2, eval_num=3,
        batch_size=2, mask_predict_steps=[2], pnag_dynamic=False,
        mp_config=DEFAULT_MP_CONFIG, **kw)


def test_evaluate_matches_jax(i3d_vars, tmp_path, capsys):
    """eval_num 3 at batch 2: both under-sample to 2 and say so."""
    real, fake = _eval_inputs(0, 1, 2)
    cfg = types.SimpleNamespace(num_visuals=0)
    want = jeval.evaluate(_args(tmp_path / 'jax'), _JaxStub(fake, cfg),
                          iter(real), i3d_variables=i3d_vars,
                          key=jax.random.PRNGKey(0), metrics=('fvd',))
    port = _PortStub(fake, cfg)
    got = peval.evaluate(_args(tmp_path / 'port'), port, iter(real),
                         i3d_variables=i3d_vars, metrics=('fvd', 'prd'))
    assert capsys.readouterr().out.count('using 2 samples') == 2
    assert got['fvd'] == pytest.approx(want['fvd'], rel=FVD_RTOL)
    for name in ('real_embs.npy', 'fake_embs.npy'):
        g, w = (np.load(tmp_path / d / name) for d in ('port', 'jax'))
        assert g.shape == w.shape == (2, 400)
        _close(g, w, NET_TOL, name)
    for d in ('port', 'jax'):
        text = (tmp_path / d / 'fvd_score.txt').read_text()
        assert 'n_samples = 2' in text
    assert port.calls[0] == dict(visual=None, mask_predict_steps=2,
                                 dynamic=False, mp_config=DEFAULT_MP_CONFIG)
    f8, f18 = got['prd']
    assert 0 <= f8 <= 1 and 0 <= f18 <= 1
    assert (tmp_path / 'port' / 'prd_score.txt').read_text().startswith(
        f'F_8 = {f8}')
    with open(tmp_path / 'port' / 'prd_data.pkl', 'rb') as f:
        assert set(pickle.load(f)) == {'precision', 'recall'}


def test_evaluate_refuses_random_i3d(tmp_path, monkeypatch):
    monkeypatch.delenv('MMVID_ALLOW_RANDOM_I3D', raising=False)
    real, fake = _eval_inputs(1, 1, 2)
    with pytest.raises(RuntimeError, match='I3D_CHECKPOINT'):
        peval.evaluate(_args(tmp_path), _PortStub(fake, types.SimpleNamespace(
            num_visuals=0)), iter(real))


# ---- PRD ----

def test_prd_curve_matches_jax(one_thread):
    rng = np.random.RandomState(4)
    e, r = rng.dirichlet(np.ones(20)), rng.dirichlet(np.ones(20))
    gp, gr = prd.compute_prd(e, r)
    wp, wr = jprd.compute_prd(e, r)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gr, wr)
    assert prd.prd_to_max_f_beta_pair(gp, gr) == \
        jprd.prd_to_max_f_beta_pair(wp, wr)


def _clusters(rng, counts, d=16):
    centres = np.eye(d)[:len(counts)] * 50.0
    return np.concatenate([c + rng.randn(n, d) for c, n in
                           zip(centres, counts)])


def test_prd_on_separated_clusters_equals_jax(one_thread):
    """Three clusters 50 apart with unit spread: every k-means start finds
    them, so both packages bin alike (eval weights 30/20/10, ref 20/20/20)."""
    rng = np.random.RandomState(8)
    ev, ref = _clusters(rng, (30, 20, 10)), _clusters(rng, (20, 20, 20))
    np.random.seed(0)   # sklearn draws its starts from numpy's global state
    want = jprd.prd_to_max_f_beta_pair(*jprd.compute_prd_from_embedding(
        ev, ref, num_clusters=3, num_runs=3))
    got = prd.prd_to_max_f_beta_pair(*prd.compute_prd_from_embedding(
        ev, ref, num_clusters=3, num_runs=3,
        rng=np.random.default_rng(0)))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_prd_on_random_embeddings_within_jax_spread(one_thread):
    """Each run bins at random; the port's pairs (4 seeds) lie within
    three standard deviations of the mean of JAX's (8 runs)."""
    rng = np.random.RandomState(9)
    ev, ref = rng.randn(64, 8), rng.randn(64, 8) + 0.5
    np.random.seed(1)
    runs = np.array([jprd.prd_to_max_f_beta_pair(
        *jprd.compute_prd_from_embedding(ev, ref, num_clusters=10))
        for _ in range(8)])
    mean, std = runs.mean(0), runs.std(0)
    for seed in range(4):
        got = np.array(prd.prd_to_max_f_beta_pair(
            *prd.compute_prd_from_embedding(
                ev, ref, num_clusters=10,
                rng=np.random.default_rng(seed))))
        assert np.all(np.abs(got - mean) <= 3 * std), (got, runs)


def test_kmeans_is_seeded(one_thread):
    data = np.random.RandomState(2).randn(40, 3)
    a = prd.kmeans(data, 4, np.random.default_rng(5))
    b = prd.kmeans(data, 4, np.random.default_rng(5))
    np.testing.assert_array_equal(a, b)
    assert set(a) == {0, 1, 2, 3}
