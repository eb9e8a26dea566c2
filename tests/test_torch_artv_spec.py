"""The port's exact speculative ART-V decode
(mmvid_tpu_torch.models.artv_spec) against the JAX package's
(mmvid_tpu/models/artv_spec.py), at the tiny config of
tests/test_artv_spec.py (dim 64, 2 layers, 2 heads, 2 frames of 64
tokens), fp32 on the CPU, JAX weights carried over through
``weights.load_jax_params``.

Greedy decoding (temperature 1e-6) must give the same tokens, token for
token, as JAX's ``ar_sample_spec`` and the port's own ``ar_sample``, and
the same chunk counts as JAX; sampled tokens must match JAX's baseline in
distribution (the chi^2/TV bounds of tests/test_sampler_parity.py), since
the two frameworks' random streams differ.
"""

import dataclasses
import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvid_tpu.models import artv as jartv
from mmvid_tpu.models.artv_spec import ar_sample_spec as jax_spec
from mmvid_tpu.models.clip import ClipStackConfig as JaxClip
from mmvid_tpu_torch import factories, generate
from mmvid_tpu_torch.models import artv as partv
from mmvid_tpu_torch.models.artv_spec import ar_sample_spec
from mmvid_tpu_torch.models.clip import ClipStackConfig
from mmvid_tpu_torch.ops import artv_decode as AD
from mmvid_tpu_torch.weights import load_jax_params
from test_sampler_parity import _chi2_stat, _marginals, _tv
from test_torch_artv import JCFG, jax_tiny_artv, port_tiny_artv
from test_torch_drivers import _one_thread  # noqa: F401 (module-wide)

N_LOOP = JCFG.target_seq_len - 1     # 127 tokens after the first


@pytest.fixture(scope='module')
def pair():
    core, params, vae_params = jax_tiny_artv()
    return core, params, port_tiny_artv(params, vae_params)


def _inputs(b=2, seed=3):
    """tests/test_artv_spec.py's inputs: text ids and visual-control ids
    (the frame-0 drafts)."""
    rng = np.random.RandomState(seed)
    text = rng.randint(1, 50, (b, JCFG.text_seq_len)).astype(np.int32)
    visual = rng.randint(0, 1024, (b, JCFG.visual_seq_len)).astype(np.int32)
    return text, visual


def _torch(*arrays):
    return [torch.from_numpy(a).long() for a in arrays]


@pytest.fixture(scope='module')
def greedy_base(pair):
    """The port's baseline ``ar_sample`` at temperature 1e-6 (tokens, the
    forwards each lane ran), with ``MMVID_ARTV_SPEC`` unset."""
    assert 'MMVID_ARTV_SPEC' not in os.environ
    tt, vv = _torch(*_inputs())
    return partv.ar_sample(pair[2].core, tt, vv,
                           torch.Generator().manual_seed(1),
                           temperature=1e-6, return_steps=True)


@pytest.mark.parametrize('k', [1, 4, 64])
def test_spec_greedy_matches_jax_and_baseline(pair, greedy_base,
                                              monkeypatch, k):
    """temperature 1e-6: the port's speculative tokens equal JAX's and
    the port's baseline ``ar_sample``'s, and its chunk counts equal
    JAX's, for any chunk size; no decode kernel counts (the CPU).  JAX's
    ``ar_sample_spec`` runs under ``jax.jit`` (the same program its
    ``generate_images`` compiles; eager, it compiles each loop anew)."""
    core, params, pmodel = pair
    text, visual = _inputs()
    want, want_steps = jax.jit(functools.partial(
        jax_spec, core, spec_k=k, temperature=1e-6))(
            params, jnp.asarray(text), jnp.asarray(visual),
            jax.random.PRNGKey(2))
    tt, vv = _torch(text, visual)
    monkeypatch.setattr(AD, 'launches', 0)
    got, steps = ar_sample_spec(pmodel.core, tt, vv,
                                torch.Generator().manual_seed(2), k,
                                temperature=1e-6)
    assert AD.launches == 0
    assert got.shape == (2, JCFG.target_seq_len) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), greedy_base[0].numpy())
    np.testing.assert_array_equal(steps.numpy(), np.asarray(want_steps))
    assert int(steps.max()) <= N_LOOP


@pytest.mark.parametrize('k', [4, 8])
def test_spec_force_commits_full_chunks(pair, monkeypatch, k):
    """MMVID_ARTV_SPEC_FORCE=1 accepts every draft: ceil(127 / (k + 1))
    chunks a lane."""
    _, _, pmodel = pair
    monkeypatch.setenv('MMVID_ARTV_SPEC_FORCE', '1')
    tt, vv = _torch(*_inputs())
    toks, steps = ar_sample_spec(pmodel.core, tt, vv,
                                 torch.Generator().manual_seed(2), k)
    want = -(-N_LOOP // (k + 1))
    assert steps.tolist() == [want, want]
    assert 0 <= toks.min() and toks.max() < JCFG.num_image_tokens


def test_spec_env_routes_ar_sample(pair, greedy_base, monkeypatch):
    """``MMVID_ARTV_SPEC=k`` routes ``ar_sample`` (read at every call) to
    the speculative path, which forced acceptance shows by its chunk
    count (the baseline runs 127 forwards a lane); ``int8=True`` ignores
    the flag, as in JAX; ``generate_images(spec_stats=True)`` returns the
    chunk counts."""
    _, _, pmodel = pair
    tt, vv = _torch(*_inputs())
    assert greedy_base[1].tolist() == [N_LOOP, N_LOOP]
    monkeypatch.setenv('MMVID_ARTV_SPEC', '4')
    monkeypatch.setenv('MMVID_ARTV_SPEC_FORCE', '1')
    args = (pmodel.core, tt, vv)
    _, steps = partv.ar_sample(*args, torch.Generator().manual_seed(9),
                               return_steps=True)
    assert steps.tolist() == [26, 26]            # ceil(127 / 5)
    _, steps8 = partv.ar_sample(*args, torch.Generator().manual_seed(1),
                                int8=True, return_steps=True)
    assert steps8.tolist() == [N_LOOP, N_LOOP]
    videos, seq, steps = pmodel.generate_images(
        torch.Generator().manual_seed(9), tt, visual=vv, decode=False,
        spec_stats=True)
    assert videos is None and seq.shape == (2, JCFG.target_seq_len)
    assert steps.tolist() == [26, 26]


def test_spec_k_out_of_range_raises(pair):
    _, _, pmodel = pair
    tt, vv = _torch(*_inputs())
    for k in (0, JCFG.image_seq_len + 1):
        with pytest.raises(ValueError, match='spec_k'):
            ar_sample_spec(pmodel.core, tt, vv, torch.Generator(), k)


def test_spec_window_off_same_greedy(pair, monkeypatch):
    """MMVID_SPEC_WINDOW=0 (one full-width loop) against the per-frame
    segments: the same greedy tokens and chunk counts."""
    _, _, pmodel = pair
    tt, vv = _torch(*_inputs())
    t0, s0 = ar_sample_spec(pmodel.core, tt, vv,
                            torch.Generator().manual_seed(13), 4,
                            temperature=1e-6)
    monkeypatch.setenv('MMVID_SPEC_WINDOW', '0')
    t1, s1 = ar_sample_spec(pmodel.core, tt, vv,
                            torch.Generator().manual_seed(13), 4,
                            temperature=1e-6)
    assert torch.equal(t0, t1) and torch.equal(s0, s1)


def test_spec_seed_repeats_sampled_tokens(pair):
    """Temperature 1: one seed repeats its tokens and chunk counts; the
    draws come from the generator, so another seed gives other tokens."""
    _, _, pmodel = pair
    tt, vv = _torch(*_inputs())
    runs = [ar_sample_spec(pmodel.core, tt, vv,
                           torch.Generator().manual_seed(seed), 4)
            for seed in (17, 17, 18)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][0], runs[2][0])


def test_spec_distribution_matches_jax_baseline():
    """Temperature 1: 800 speculative trajectories of the port against
    800 of JAX's baseline ``ar_sample`` on a 32-token vocabulary, the
    same weights: the parity suite's chi^2 (31 degrees of freedom, alpha
    about 1e-4: 66.6) and TV within max(1.3 x JAX's split-half TV, 0.10)
    (tests/test_artv_spec.py's bounds)."""
    jcfg = jartv.ArtvConfig(dim=64, num_text_tokens=50, text_seq_len=6,
                            num_visuals=1, num_targets=2,
                            num_image_tokens=32, image_fmap_size=4,
                            image_size=16,
                            clip=JaxClip(width=64, layers=2, heads=2))
    core = jartv.ArtvCore(jcfg)
    r = 800
    rng = np.random.RandomState(7)
    text = np.tile(rng.randint(1, 50, (1, 6)), (r, 1)).astype(np.int32)
    visual = np.tile(rng.randint(0, 32, (1, jcfg.visual_seq_len)),
                     (r, 1)).astype(np.int32)
    params = jax.jit(core.init)(
        jax.random.PRNGKey(0), jnp.asarray(text[:1]),
        jnp.asarray(visual[:1]),
        jnp.zeros((1, jcfg.target_seq_len), jnp.int32))['params']
    base = np.asarray(jax.jit(functools.partial(
        jartv.ar_sample, core, temperature=1.0))(
            params, jnp.asarray(text), jnp.asarray(visual),
            jax.random.PRNGKey(5)))

    pcfg = partv.ArtvConfig(**{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
        if f.name != 'clip'}, clip=ClipStackConfig(width=64, layers=2,
                                                   heads=2))
    pmodel = partv.ArtvModel(pcfg, vae=None)
    load_jax_params(pmodel, params)
    tt, vv = _torch(text, visual)
    spec, _ = ar_sample_spec(pmodel.core, tt, vv,
                             torch.Generator().manual_seed(6), 4)
    spec = spec.numpy()
    assert spec.min() >= 0 and spec.max() < 32

    c_base, c_spec = _marginals(base, vocab=32), _marginals(spec, vocab=32)
    chi2 = _chi2_stat(c_base, c_spec)
    assert chi2 < 66.6, f'speculative distribution drifted (chi2={chi2:.1f})'
    half = _tv(_marginals(base[:r // 2], vocab=32),
               _marginals(base[r // 2:], vocab=32))
    cross = _tv(c_base, c_spec)
    assert cross < max(1.3 * half, 0.10), (cross, half)


def _checkpoint(path, ar):
    """A tiny dalle.pt: ART-V (hparams say ``ar``) or mask-predict."""
    hparams = {'dim': 64, 'text_seq_len': 6, 'num_targets': 2,
               'num_visuals': 0, 'image_size': 32,
               'which_transformer': 'custom:64:2:2'}
    if ar:
        hparams['ar'] = True
    args = SimpleNamespace(**hparams, loss_img_weight=7, insert_sep=False,
                           use_separate_visual_emb=False,
                           fixed_language_model=None,
                           text_emb_bottleneck=None)
    model = factories.get_dalle(
        args, factories.get_vae_model(args, device='cpu'), device='cpu')
    factories.init_weights(model, torch.Generator().manual_seed(0))
    torch.save({'iter': 1, 'hparams': hparams,
                'weights': model.state_dict()}, path)
    return path


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp('spec')
    return {'ar': _checkpoint(d / 'artv.pt', True),
            'mp': _checkpoint(d / 'mask_predict.pt', False)}


def _main(path, out, *flags):
    generate.main(generate.parse_args([
        '--dalle_path', str(path), '--prompts', 'a person is talking',
        'she laughs', '--out_dir', str(out), '--batch_size', '2',
        '--format', 'png', '--device', 'cpu', '--no-bf16', *flags]))


@pytest.mark.parametrize('which,flags,env,match', [
    ('mp', ['--spec', '4'], {}, '--spec requires --ar'),
    ('ar', ['--ar', '--spec', '4', '--int8'], {}, 'drop --int8'),
    ('ar', ['--ar'], {'MMVID_ARTV_SPEC_FORCE': '1'}, 'bench_unsafe')],
    ids=['spec_without_ar', 'spec_with_int8', 'force_without_bench_unsafe'])
def test_generate_refusals(checkpoints, tmp_path, monkeypatch, which, flags,
                           env, match):
    """JAX's refusals (generate.py:86-95, 138-148): --spec needs --ar (a
    mask-predict checkpoint, whose hparams do not say ``ar``) and refuses
    --int8; forced acceptance needs --bench_unsafe.  Nothing is written,
    and the speculative flag is not left set."""
    monkeypatch.delenv('MMVID_ARTV_SPEC', raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=match):
        _main(checkpoints[which], tmp_path / 'out', *flags)
    assert not list(tmp_path.glob('out/*.png'))
    assert 'MMVID_ARTV_SPEC' not in os.environ


def test_generate_spec_prints_acceptance(checkpoints, tmp_path,
                                         monkeypatch, capsys):
    """``--ar --spec 4`` samples through the speculative path and prints
    the tokens a chunk; with forced acceptance and --bench_unsafe, the
    ceiling (this checkpoint's VQGAN gives 2 x 2 tokens a frame: 7 tokens
    after the first in ceil(7 / 5) = 2 chunks, 3.50 a chunk)."""
    monkeypatch.delenv('MMVID_ARTV_SPEC', raising=False)
    _main(checkpoints['ar'], tmp_path / 'out', '--ar', '--spec', '4')
    out = capsys.readouterr().out
    assert 'spec acceptance:' in out and 'ceiling 5' in out
    assert len(list((tmp_path / 'out').glob('*.png'))) == 2
    monkeypatch.setenv('MMVID_ARTV_SPEC_FORCE', '1')
    _main(checkpoints['ar'], tmp_path / 'out2', '--ar', '--spec', '4',
          '--bench_unsafe')
    assert 'spec acceptance: 3.50 tokens/chunk' in capsys.readouterr().out
