"""The port's VID warps (mmvid_tpu_torch.models.warp) and MSM masks
(``models/masking.py::sample_msm_mask``) against the JAX package's, on the
CPU.

The warps take their draws as tensors, so each strategy is held to JAX's
output on JAX's own draws (:func:`jax_warp_draws` repeats JAX's key
splits): the frame copies, shuffles and color shifts are exact, the
affine warp's bilinear sums within 5e-6 (fp32 trigonometry and sums in
another order: up to 1.01e-6 read here, on values in [0, 1]).  The token-level plan must equal tokenizing the pixel
warp (``tests/test_warp.py``'s property).  The MSM masks come from
another PRNG, so they are held to JAX's in distribution: the histogram of
kept tokens a sample by the chi^2 / TV pattern of
``tests/test_sampler_parity.py``, at 4000 samples a side.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvid_tpu.models import masking as jmask
from mmvid_tpu.models import warp as jwarp
from mmvid_tpu.models.bert import BertConfig as JaxBertConfig
from mmvid_tpu_torch import factories
from mmvid_tpu_torch.models import masking as pmask
from mmvid_tpu_torch.models import warp as pwarp

AFFINE_TOL = 5e-6
PROBS = {0: (1, 0, 0, 0), 1: (0, 1, 0, 0), 2: (0, 0, 1, 0), 3: (0, 0, 0, 1)}


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_warp_draws(key, b, t, probs):
    p = jnp.asarray(probs, jnp.float32)

    def per_sample(i, k):
        ks = jax.random.split(k, 6)
        perm = jax.random.permutation(ks[4], t)
        perm = jnp.where(jnp.all(perm == jnp.arange(t)), jnp.roll(perm, 1),
                         perm)
        k1, k2 = jax.random.split(ks[5])
        a1, a2, a3, a4 = jax.random.split(ks[5], 4)
        off = jax.random.randint(ks[3], (), 1, max(b, 2))
        return {'strategy': jax.random.choice(ks[0], 4, p=p),
                'j1': jax.random.randint(ks[1], (), 0, t),
                'j2': jax.random.randint(ks[2], (), 0, t),
                'i_other': (i + off) % b, 'perm': perm,
                'c_shift': jax.random.uniform(k1) - 0.5,
                'which': jax.random.randint(k2, (), 0, 4),
                'angle': jax.random.uniform(a1, minval=-30.0, maxval=30.0),
                'tx': jax.random.uniform(a2, minval=-0.1, maxval=0.1),
                'ty': jax.random.uniform(a3, minval=-0.1, maxval=0.1),
                'scale': jax.random.uniform(a4, minval=0.9, maxval=1.1)}

    return jax.vmap(per_sample)(jnp.arange(b), jax.random.split(key, b))


def jax_warp_draws(key, b, t, probs=(0.25, 0.25, 0.25, 0.25)):
    """Every draw of JAX's ``warp`` / ``warp_token_plan`` for ``key``, in
    the port's form (the same splits and draw order, per sample)."""
    return {k: torch.as_tensor(np.array(v)) for k, v in
            _jax_warp_draws(key, b, t, tuple(probs)).items()}


def _video(b=4, t=3, seed=3):
    rng = np.random.RandomState(seed)
    return rng.uniform(0, 1, (b, t, 16, 16, 3)).astype(np.float32)


@pytest.mark.parametrize('strategy', [0, 1, 2, 3])
def test_warp_matches_jax_on_jax_draws(strategy):
    video = _video()
    key = jax.random.PRNGKey(10 + strategy)
    want = np.asarray(jax.jit(jwarp.warp, static_argnums=2)(
        key, jnp.asarray(video), PROBS[strategy]))
    draws = jax_warp_draws(key, 4, 3, PROBS[strategy])
    assert (draws['strategy'] == strategy).all()
    got = pwarp.warp(None, torch.from_numpy(video), draws=draws).numpy()
    if strategy == 3:
        np.testing.assert_allclose(got, want, rtol=0, atol=AFFINE_TOL)
        assert not np.allclose(got, video)
    else:
        np.testing.assert_array_equal(got, want)


def test_affine_reflects_like_jax():
    """Rotations, shifts and scales that reach well past the frame's edge,
    where 'reflect' folds the coordinates back: JAX's
    ``_affine_warp_frame`` with wide ranges, on its own draws."""
    frame = _video(1, 1, seed=5)[0, 0]
    warp_frame = jax.jit(jwarp._affine_warp_frame, static_argnums=(2, 3, 4))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(warp_frame(key, jnp.asarray(frame), 170.0, 0.9,
                                     0.9))
        a1, a2, a3, a4 = jax.random.split(key, 4)
        draws = [jax.random.uniform(a1, minval=-170.0, maxval=170.0),
                 jax.random.uniform(a2, minval=-0.9, maxval=0.9),
                 jax.random.uniform(a3, minval=-0.9, maxval=0.9),
                 jax.random.uniform(a4, minval=0.1, maxval=1.9)]
        got = pwarp._affine_warp_frame(
            torch.from_numpy(frame)[None],
            *(torch.as_tensor(np.array(d))[None] for d in draws))[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=AFFINE_TOL)


def test_warp_video_with_color_matches_jax():
    video = _video(3, 2, seed=6)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jwarp.warp_video_with_color(key, jnp.asarray(video)))
    c, which = [], []
    for k in jax.random.split(key, 3):
        k1, k2 = jax.random.split(k)
        c.append(np.asarray(jax.random.uniform(k1) - 0.5))
        which.append(np.asarray(jax.random.randint(k2, (), 0, 4)))
    got = pwarp.warp_video_with_color(
        None, torch.from_numpy(video),
        {'c_shift': torch.as_tensor(np.stack(c)),
         'which': torch.as_tensor(np.stack(which))}).numpy()
    np.testing.assert_array_equal(got, want)


def test_token_plan_matches_jax():
    video = _video(5, 3, seed=8)
    key = jax.random.PRNGKey(8)
    mod, plan = jax.jit(jwarp.warp_token_plan)(key, jnp.asarray(video))
    draws = jax_warp_draws(key, 5, 3)
    got_mod, got_plan = pwarp.warp_token_plan(None, torch.from_numpy(video),
                                              draws=draws)
    np.testing.assert_allclose(got_mod.numpy(), np.asarray(mod), rtol=0,
                               atol=AFFINE_TOL)
    for k in ('strategy', 'j1', 'j2', 'i_other', 'perm'):
        np.testing.assert_array_equal(got_plan[k].numpy(),
                                      np.asarray(plan[k]), err_msg=k)
    rng = np.random.RandomState(9)
    tokens = rng.randint(0, 1024, (5, 3 * 64)).astype(np.int32)
    mod_tokens = rng.randint(0, 1024, (5, 64)).astype(np.int32)
    want = np.asarray(jwarp.apply_warp_token_plan(
        jnp.asarray(tokens), jnp.asarray(mod_tokens), plan))
    got = pwarp.apply_warp_token_plan(torch.from_numpy(tokens).long(),
                                      torch.from_numpy(mod_tokens).long(),
                                      got_plan).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope='module')
def tiny_vae():
    """The port's tiny VQGAN with a codebook with spread (randn): the
    random-init one has near-ties."""
    model, vae = factories.flagship(tiny=True, device='cpu', seed=2)
    with torch.no_grad():
        vae.model.quantize.embedding.weight.copy_(torch.randn(
            vae.model.quantize.embedding.weight.shape,
            generator=torch.Generator().manual_seed(2)))
    return model


def test_token_plan_equals_tokenized_warp(tiny_vae):
    """apply_warp_token_plan on the encoded targets equals encoding the
    pixel warp, on the same draws (the generator's), every strategy."""
    model = tiny_vae
    g = torch.Generator().manual_seed(4)
    video = torch.rand((8, 2, 16, 16, 3), generator=g)
    for seed in range(3):
        draws = pwarp.warp_draws(torch.Generator().manual_seed(seed), 8, 2)
        want = model.get_image_tokens(pwarp.warp(None, video, draws=draws))
        mod, plan = pwarp.warp_token_plan(None, video, draws=draws)
        got = pwarp.apply_warp_token_plan(
            model.get_image_tokens(video),
            model.get_image_tokens(mod[:, None]), plan)
        assert torch.equal(got, want), seed


def test_warp_draws_are_valid():
    g = torch.Generator().manual_seed(0)
    d = pwarp.warp_draws(g, 64, 4, (0.1, 0.2, 0.3, 0.4))
    assert ((d['j1'] >= 0) & (d['j1'] < 4)).all()
    assert (d['i_other'] != torch.arange(64)).all()
    assert (d['perm'].sort(-1).values == torch.arange(4)).all()
    assert not (d['perm'] == torch.arange(4)).all(-1).any()
    assert (d['angle'].abs() <= 30).all() and (d['tx'].abs() <= 0.1).all()
    assert ((d['scale'] >= 0.9) & (d['scale'] <= 1.1)).all()


# -- MSM masks in distribution ---------------------------------------------

MSM_N = 4000


def _tv(c1, c2):
    p, q = c1 / c1.sum(), c2 / c2.sum()
    return float(0.5 * np.abs(p - q).sum())


def _chi2(c1, c2):
    n1, n2 = c1.sum(), c2.sum()
    pooled = (c1 + c2) / (n1 + n2)
    keep = pooled > 0
    e1, e2 = n1 * pooled[keep], n2 * pooled[keep]
    return float(((c1[keep] - e1) ** 2 / e1).sum()
                 + ((c2[keep] - e2) ** 2 / e2).sum())


def _histogram(keep, nfm, n):
    """Bins: fully masked (nfm 0), then the kept share in 8 bins."""
    kept = keep.sum(1) / n
    bins = np.minimum((kept * 8).astype(int), 7) + 1
    bins[nfm == 0] = 0
    return np.bincount(bins, minlength=9).astype(np.float64)


@pytest.mark.parametrize('pc_prob', [0.0, 0.5])
def test_sample_msm_mask_matches_jax_in_distribution(pc_prob):
    """Kept-token histograms of 4000 samples a side: chi^2 below the
    0.999 quantile for 8 degrees of freedom (26.12), and TV below 0.05
    (split-half noise at this size is about 0.02)."""
    jcfg = JaxBertConfig(dim=64, num_text_tokens=100, text_seq_len=8,
                         num_targets=4, image_fmap_size=8)
    probs, bern = (0.4, 0.2, 0.2, 0.2), (0.2, 0.5)
    keep_j, nfm_j = jax.jit(
        lambda k: jmask.sample_msm_mask(k, jcfg, probs, bern, pc_prob,
                                        batch=MSM_N))(jax.random.PRNGKey(0))
    keep_p, nfm_p = pmask.sample_msm_mask(
        torch.Generator().manual_seed(0), jcfg, probs, bern, pc_prob,
        batch=MSM_N)
    assert keep_p.shape == (MSM_N, jcfg.target_seq_len)
    assert keep_p.dtype == torch.bool and nfm_p.dtype == torch.float32
    hj = _histogram(np.asarray(keep_j), np.asarray(nfm_j),
                    jcfg.target_seq_len)
    hp = _histogram(keep_p.numpy(), nfm_p.numpy(), jcfg.target_seq_len)
    chi2, tv = _chi2(hj, hp), _tv(hj, hp)
    assert chi2 < 26.12 and tv < 0.05, (chi2, tv, hj, hp)
    # every fully masked sample keeps nothing, unless pc kept its frames
    full = keep_p[nfm_p == 0]
    if pc_prob == 0:
        assert not full.any()
    else:
        per_frame = full.view(len(full), jcfg.num_targets, -1)
        assert (per_frame.all(-1) | ~per_frame.any(-1)).all()
