"""Port's mask-predict sampler (mmvid_tpu_torch.models.sampler) vs the JAX
package at the tiny flagship config, fp32, JAX weights carried over.

Under ``deterministic=True`` (the JAX package's test hook: argmax sampling,
keep the highest-confidence tokens, as tests/test_sampler_parity.py uses)
the trajectories must agree token for token, for dynamic stop off and on,
1 and 2 beams, and the ``long`` and ``interp`` preserve layouts.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvid_tpu.models import sampler as js
from mmvid_tpu.models.bert import BertCore as JaxCore
from mmvid_tpu.models.mmvid import DEFAULT_MP_CONFIG as MP
from mmvid_tpu_torch.models import sampler as ps
from test_torch_clip_bert import jax_tiny, port_tiny


@pytest.fixture(scope='module')
def pair():
    jmodel, jvae = jax_tiny(seed=3)
    return jmodel, port_tiny(jmodel, jvae)


@pytest.mark.parametrize('mp,n,steps', [
    (MP, 128, 0), (MP, 128, 20), (MP, 64, 7), (MP, 512, 30),
    (dict(MP, T1_n=3, T2_n=2, T3_n=4, T1_t=4, T2_t=1, T3_t=2, N1_t=1.0,
          N2_t=0.5, N3_t=0.25, T=12), 100, 0)])
def test_make_schedules_exact(mp, n, steps):
    for a, b in zip(js.make_schedules(mp, n, steps),
                    ps.make_schedules(mp, n, steps)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_chain_beam_updates_matches_jax():
    rng = np.random.RandomState(0)
    J, b, n = 3, 2, 16
    Y, Yn = rng.rand(b, n).astype(np.float32), rng.rand(J, b, n).astype(
        np.float32)
    I, In = rng.randint(0, 50, (b, n)), rng.randint(0, 50, (J, b, n))
    keep, S = rng.rand(J, b, n) < 0.5, rng.rand(J, b).astype(np.float32)
    want = js.chain_beam_updates(*map(jnp.asarray, (Y, I, keep, Yn, In, S)))
    got = ps.chain_beam_updates(*map(torch.from_numpy,
                                     (Y, I, keep, Yn, In, S)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize('mode', ['long', 'interp'])
def test_preserve_layout_and_arrangement(pair, mode):
    _, pmodel = pair
    cfg = pmodel.cfg
    for has in (False, True):
        (mj, nj), (mp_, np_) = (js.preserve_layout(cfg, mode, 1, has),
                                ps.preserve_layout(cfg, mode, 1, has))
        np.testing.assert_array_equal(mj, mp_)
        assert nj == np_
    src = np.random.RandomState(1).randint(0, 1024, (2, cfg.target_seq_len))
    want = js.arrange_preserve_tokens(cfg, jnp.asarray(src), mode, 1)
    got = ps.arrange_preserve_tokens(cfg, torch.from_numpy(src), mode, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CASES = [  # (dynamic, beams, preserve mode or None)
    (False, 1, None), (True, 1, None), (False, 2, None), (True, 2, None),
    (False, 1, 'long'), (False, 1, 'interp')]


@pytest.mark.parametrize('dynamic,beams,preserve', CASES)
def test_deterministic_mask_predict_token_for_token(pair, dynamic, beams,
                                                    preserve):
    jmodel, pmodel = pair
    cfg = jmodel.cfg
    rng = np.random.RandomState(7 + beams)
    text = rng.randint(1, cfg.num_text_tokens, (2, cfg.text_seq_len))
    ctrl = jmodel.core.apply({'params': jmodel.params},
                             jnp.asarray(text, jnp.int32), None,
                             method=JaxCore.control_embedding)
    mp = dict(MP, B=beams, T=10) if dynamic else dict(MP, B=beams)
    steps = 10 if dynamic else 6
    pmask, N = js.preserve_layout(cfg, preserve or 'long', 1,
                                  preserve is not None)
    ptoks_j = ptoks_p = None
    if preserve:
        src = rng.randint(0, 1024, (2, cfg.target_seq_len))
        ptoks_j = js.arrange_preserve_tokens(cfg, jnp.asarray(src),
                                             preserve, 1)
        ptoks_p = ps.arrange_preserve_tokens(cfg, torch.from_numpy(src),
                                             preserve, 1)
    spec_j = dataclasses.replace(
        js.build_spec(mp, N, steps=steps, dynamic=dynamic),
        deterministic=True)
    spec_p = dataclasses.replace(
        ps.build_spec(mp, N, steps=steps, dynamic=dynamic),
        deterministic=True)
    assert spec_p.n_sched == spec_j.n_sched and spec_p.beams == beams
    want = js.mask_predict(jmodel.core, jmodel.params, ctrl,
                           jax.random.PRNGKey(0), spec_j, pmask, ptoks_j)
    got = ps.mask_predict(pmodel.core, torch.from_numpy(np.array(ctrl)),
                          torch.Generator().manual_seed(0), spec_p, pmask,
                          ptoks_p)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if preserve:
        np.testing.assert_array_equal(got.numpy()[:, pmask],
                                      np.asarray(ptoks_j)[:, pmask])


def test_stochastic_mask_predict_reproducible_by_seed(pair):
    """The stochastic path (plain sample head on the CPU): tokens in the
    codebook, the same generator seed gives the same tokens."""
    _, pmodel = pair
    cfg = pmodel.cfg
    text = torch.randint(1, cfg.num_text_tokens, (2, cfg.text_seq_len),
                         generator=torch.Generator().manual_seed(0))
    ctrl = pmodel.core.control_embedding(text).detach()
    pmask, N = ps.preserve_layout(cfg, 'long', 1, False)
    spec = ps.build_spec(dict(MP, T1_t=10, N1_t=1.0, N2_t=0.5), N, steps=5,
                         dynamic=False)
    runs = [ps.mask_predict(pmodel.core, ctrl,
                            torch.Generator().manual_seed(s), spec, pmask)
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                             runs[2])
    assert 0 <= int(runs[0].min()) and int(runs[0].max()) < 1024
