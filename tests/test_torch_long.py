"""The port's long-video sampling and PNAG debug trace against the JAX
package on the CPU, at the tiny size with four frames (interp_real needs
num_targets divisible by 4), fp32, JAX weights carried over, the VQGANs'
codebooks with spread (randn) so that encoding compares id for id.

Under the deterministic hook (argmax sampling, keep the most confident
tokens: ``build_spec`` patched in both packages, as
tests/test_torch_generate.py does):

* ``preserve_layout`` / ``arrange_preserve_tokens`` for ``long`` at
  t_overlap 1 and 2, ``interp`` and ``interp_real``;
* ``mask_predict_trace`` token for token and keep mask for keep mask,
  without and with preserved slots, and its last step equal to
  ``mask_predict``'s;
* ``generate_images(preserve=...)`` in each mode: tokens equal, the
  preserved slots holding their sources;
* ``generate_long_video``, ``generate_interpolated_video`` and
  ``generate_interp_real_video``: every sampling call's tokens equal, the
  frame counts JAX's, the frames within 1e-4 (the decode tolerance of
  tests/test_torch_generate.py: fp32 sums in another order);
* ``save_pnag_debug_grid``'s pixels from the same arrays, and
  ``visualize_train`` with ``debug=True`` and with ``test_mode='shapes'``
  (three visual controls and a cvae): the same files, the same grid
  sizes, pixels within one 8-bit level;
* the test driver, ``--eval_mode long`` in each mode: ``long_{i}.png``
  and ``codebook_long.npy`` at JAX's shapes; its grids over the shape,
  shape_attr and iPER datasets with ``--test_mode shapes``;
* ART-V through the long modes: the calls taken, nothing preserved, as
  JAX's ``generate_images(**unused)`` does.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from mmvid_tpu.models import bert as jbert
from mmvid_tpu.models import mmvid as jmmvid
from mmvid_tpu.models import sampler as js
from mmvid_tpu.models.clip import ClipStackConfig as JaxClip
from mmvid_tpu.utils import html as jhtml
from mmvid_tpu.utils import viz as jviz
from mmvid_tpu_torch import factories
from mmvid_tpu_torch import test as ptest
from mmvid_tpu_torch.config import process_args
from mmvid_tpu_torch.data import png
from mmvid_tpu_torch.models import mmvid as pmmvid
from mmvid_tpu_torch.models import sampler as ps
from mmvid_tpu_torch.models.bert import BertConfig
from mmvid_tpu_torch.models.clip import ClipStackConfig
from mmvid_tpu_torch.models.vqgan import VQGanConfig, VQGanVAE
from mmvid_tpu_torch.utils import html as phtml
from mmvid_tpu_torch.utils import viz as pviz
from mmvid_tpu_torch.weights import load_jax_params
from test_torch_encode import VQ_TINY, jax_vae

FRAME_TOL = 1e-4
STEPS = 3


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One thread for torch and the BLAS pools: the tiny model's ops run
    as fast in one and do not spin against the other test workers."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def jax_model(seed, num_targets=4, num_visuals=0, vae=None):
    """The JAX tiny flagship at ``num_targets`` frames (``vae``, or a new
    one, and with ``num_visuals`` control frames a cvae of ``vae``'s
    weights), codebooks with spread."""
    vae = vae or jax_vae(VQ_TINY, seed, spread=True)
    cvae = (jmmvid.VQGanVAE(image_size=16, cfg=vae.cfg, params=vae.params)
            if num_visuals else None)
    cfg = jbert.BertConfig(dim=64, num_text_tokens=100, text_seq_len=8,
                           num_visuals=num_visuals, num_targets=num_targets,
                           num_image_tokens=1024, image_fmap_size=8,
                           image_size=16,
                           use_separate_visual_emb=bool(num_visuals),
                           clip=JaxClip(width=64, layers=2, heads=2))
    params = jax.jit(jbert.BertCore(cfg).init)(
        jax.random.PRNGKey(seed + 2),
        jnp.zeros((1, cfg.text_seq_len), jnp.int32),
        (jnp.zeros((1, cfg.visual_seq_len), jnp.int32) if num_visuals
         else None),
        jnp.zeros((1, cfg.target_seq_len), jnp.int32))['params']
    return jmmvid.MMVIDBert(cfg, vae, cvae=cvae, params=params)


def port_model(jmodel):
    """The port's model of ``jmodel``'s config, carrying its weights."""
    c = jmodel.cfg
    cfg = BertConfig(dim=64, num_text_tokens=100, text_seq_len=8,
                     num_visuals=c.num_visuals, num_targets=c.num_targets,
                     num_image_tokens=1024, image_fmap_size=8, image_size=16,
                     clip=ClipStackConfig(width=64, layers=2, heads=2))
    vae = VQGanVAE(image_size=16, cfg=VQGanConfig(**VQ_TINY))
    cvae = (VQGanVAE(image_size=16, cfg=VQGanConfig(**VQ_TINY))
            if jmodel.cvae is not None else None)
    model = pmmvid.MMVIDBert(cfg, vae, cvae=cvae).eval()
    load_jax_params(model, jmodel.params, jmodel.vae.params,
                    jmodel.cvae.params if cvae is not None else None)
    return model


@pytest.fixture(scope='module')
def pair():
    jmodel = jax_model(seed=21)
    return jmodel, port_model(jmodel)


def _deterministic(build_spec):
    def patched(*a, **k):
        return dataclasses.replace(build_spec(*a, **k), deterministic=True)
    return patched


@pytest.fixture
def hook(monkeypatch):
    monkeypatch.setattr(jmmvid, 'build_spec',
                        _deterministic(jmmvid.build_spec))
    monkeypatch.setattr(pmmvid, 'build_spec',
                        _deterministic(pmmvid.build_spec))


def _text(cfg, seed, b=2):
    return np.random.RandomState(seed).randint(
        1, cfg.num_text_tokens, (b, cfg.text_seq_len)).astype(np.int32)


MODES = [('long', 1), ('long', 2), ('interp', 1), ('interp_real', 1)]


@pytest.mark.parametrize('mode,overlap', MODES)
def test_preserve_layout_and_arrangement_match_jax(pair, mode, overlap):
    _, pmodel = pair
    cfg = pmodel.cfg
    for has in (False, True):
        (mj, nj), (mp_, np_) = (js.preserve_layout(cfg, mode, overlap, has),
                                ps.preserve_layout(cfg, mode, overlap, has))
        np.testing.assert_array_equal(mj, mp_)
        assert nj == np_
    assert int(mp_.sum()) == (64 * overlap if mode == 'long' else 2 * 64)
    src = np.random.RandomState(overlap).randint(
        0, 1024, (2, cfg.target_seq_len))
    want = js.arrange_preserve_tokens(cfg, jnp.asarray(src), mode, overlap)
    got = ps.arrange_preserve_tokens(cfg, torch.from_numpy(src), mode,
                                     overlap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ctrl(jmodel, text):
    return jmodel.core.apply({'params': jmodel.params}, jnp.asarray(text),
                             None, method=jbert.BertCore.control_embedding)


@pytest.mark.parametrize('preserve', [None, 'long'])
def test_mask_predict_trace_matches_jax(pair, preserve):
    jmodel, pmodel = pair
    cfg = jmodel.cfg
    ctrl = _ctrl(jmodel, _text(cfg, 3))
    pmask, N = js.preserve_layout(cfg, 'long', 2, preserve is not None)
    ptoks_j = ptoks_p = None
    if preserve:
        src = np.random.RandomState(4).randint(0, 1024,
                                               (2, cfg.target_seq_len))
        ptoks_j = js.arrange_preserve_tokens(cfg, jnp.asarray(src), 'long',
                                             2)
        ptoks_p = ps.arrange_preserve_tokens(cfg, torch.from_numpy(src),
                                             'long', 2)
    spec_j = dataclasses.replace(js.build_spec(
        jmmvid.DEFAULT_MP_CONFIG, N, steps=5, dynamic=False),
        deterministic=True)
    spec_p = dataclasses.replace(ps.build_spec(
        pmmvid.DEFAULT_MP_CONFIG, N, steps=5, dynamic=False),
        deterministic=True)
    want = js.mask_predict_trace(jmodel.core, jmodel.params, ctrl,
                                 jax.random.PRNGKey(0), spec_j, pmask,
                                 ptoks_j)
    ctrl_p = torch.from_numpy(np.array(ctrl))
    got = ps.mask_predict_trace(pmodel.core, ctrl_p, torch.Generator(),
                                spec_p, pmask, ptoks_p)
    assert got[0].shape == got[1].shape == (5, 2, cfg.target_seq_len)
    assert got[1].dtype == torch.bool
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # step t keeps the preserved slots and N - n_sched[t-1] others
    n_pres = int(pmask.sum())
    keeps = got[1].sum(-1)
    assert (keeps[0] == n_pres).all()
    for t in range(1, 5):
        assert (keeps[t] == n_pres + N - spec_p.n_sched[t - 1]).all()
    # the trace and mask_predict share one rule
    final = ps.mask_predict(pmodel.core, ctrl_p, torch.Generator(), spec_p,
                            pmask, ptoks_p)
    assert torch.equal(final, got[2]) and torch.equal(got[0][-1], got[2])
    if preserve:
        assert torch.equal(got[0][:, :, pmask],
                           ptoks_p[None, :, pmask].expand(5, -1, -1))


@pytest.mark.parametrize('mode,overlap', MODES)
def test_generate_images_preserve_matches_jax(pair, hook, mode, overlap):
    jmodel, pmodel = pair
    cfg = jmodel.cfg
    text = _text(cfg, 5)
    src = np.random.RandomState(6).randint(0, 1024, (2, cfg.target_seq_len))
    kw = dict(mask_predict_steps=STEPS, dynamic=False, long_mode=mode,
              t_overlap=overlap, decode=False)
    _, want = jmodel.generate_images(jax.random.PRNGKey(0),
                                     jnp.asarray(text),
                                     preserve=jnp.asarray(src), **kw)
    videos, got = pmodel.generate_images(
        torch.Generator(), torch.from_numpy(text),
        preserve=torch.from_numpy(src), **kw)
    assert videos is None
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pmask, _ = ps.preserve_layout(cfg, mode, overlap, True)
    arranged = ps.arrange_preserve_tokens(cfg, torch.from_numpy(src), mode,
                                          overlap)
    assert torch.equal(got[:, pmask], arranged[:, pmask])


def _recording(monkeypatch, model, calls):
    orig = model.generate_images

    def recorded(*a, **kw):
        out = orig(*a, **kw)
        calls.append(np.asarray(out[1]))
        return out
    monkeypatch.setattr(model, 'generate_images', recorded)


LONG = [('long', 1, 3, 4 + 2 * 3, 3), ('long', 2, 3, 4 + 2 * 2, 3),
        ('interp', 1, 3, 16, 7), ('interp_real', 1, 2, 7, 3)]


@pytest.mark.parametrize('mode,overlap,t_repeat,frames,calls', LONG)
def test_long_video_functions_match_jax(pair, hook, monkeypatch, mode,
                                        overlap, t_repeat, frames, calls):
    """Frame counts: long T + (t_repeat-1)(T - t_overlap); interp
    T * 2^(t_repeat-1); interp_real last_tt*T/2 + T - 1, last_tt =
    (T - T/2) // (T/4) = 2 at T 4."""
    jmodel, pmodel = pair
    cfg = jmodel.cfg
    text = _text(cfg, 7)
    jcalls, pcalls = [], []
    _recording(monkeypatch, jmodel, jcalls)
    _recording(monkeypatch, pmodel, pcalls)
    key, gen = jax.random.PRNGKey(1), torch.Generator()
    kw = dict(mask_predict_steps=STEPS)
    if mode == 'long':
        want = jviz.generate_long_video(
            jmodel, key, jnp.asarray(text), t_repeat=t_repeat,
            t_overlap=overlap, **kw)
        got = pviz.generate_long_video(
            pmodel, gen, torch.from_numpy(text), t_repeat=t_repeat,
            t_overlap=overlap, **kw)
    elif mode == 'interp':
        want = jviz.generate_interpolated_video(
            jmodel, key, jnp.asarray(text), levels=t_repeat - 1, **kw)
        got = pviz.generate_interpolated_video(
            pmodel, gen, torch.from_numpy(text), levels=t_repeat - 1, **kw)
    else:
        target = np.random.RandomState(8).rand(2, 4, 16, 16, 3).astype(
            np.float32)
        src_j = jmodel.get_image_tokens(jnp.asarray(target))
        src_p = pmodel.get_image_tokens(torch.from_numpy(target))
        np.testing.assert_array_equal(src_p.numpy(), np.asarray(src_j))
        want = jviz.generate_interp_real_video(
            jmodel, key, jnp.asarray(text), src_j, t_repeat=t_repeat, **kw)
        got = pviz.generate_interp_real_video(
            pmodel, gen, torch.from_numpy(text), src_p, t_repeat=t_repeat,
            **kw)
    assert len(pcalls) == len(jcalls) == calls
    for g, w in zip(pcalls, jcalls):
        np.testing.assert_array_equal(g, w)
    assert isinstance(got, np.ndarray)
    assert got.shape == np.asarray(want).shape == (2, frames, 16, 16, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=FRAME_TOL,
                               atol=FRAME_TOL)
    if mode == 'interp_real':   # the sources stay at the even slots
        first = pcalls[0].reshape(2, 4, 64)
        np.testing.assert_array_equal(first[:, ::2],
                                      src_p.numpy().reshape(2, 4, 64)[:, :2])


def _pixels(path):
    return np.asarray(Image.open(path).convert('RGB')).astype(np.int64)


def test_save_pnag_debug_grid_matches_jax(pair, tmp_path):
    jmodel, pmodel = pair
    rng = np.random.RandomState(9)
    real = rng.rand(4, 16, 16, 3).astype(np.float32)
    decodes = rng.rand(3, 4, 16, 16, 3).astype(np.float32)
    keeps = rng.rand(3, 4 * 64) < 0.6
    jviz.save_pnag_debug_grid(jmodel, str(tmp_path / 'j.png'), real,
                              decodes, keeps)
    pviz.save_pnag_debug_grid(pmodel, str(tmp_path / 'p.png'), real,
                              decodes, keeps)
    got, want = _pixels(tmp_path / 'p.png'), _pixels(tmp_path / 'j.png')
    # rows: real, the first decode, then a masked row and a decode a step
    assert got.shape == want.shape == (6 * 18, 4 * 16, 3)
    np.testing.assert_array_equal(got, want)


def _same_grids(jdir, pdir):
    jfiles, pfiles = (sorted(os.listdir(d)) for d in (jdir, pdir))
    assert jfiles == pfiles
    for f in jfiles:
        if f.endswith('.txt'):
            assert (jdir / f).read_text() == (pdir / f).read_text()
        elif os.path.isdir(jdir / f):
            _same_grids(jdir / f, pdir / f)
        else:
            got, want = _pixels(pdir / f), _pixels(jdir / f)
            assert got.shape == want.shape, f
            assert np.abs(got - want).max() <= 1, f
    return pfiles


def _batch(cfg, seed, b=2, visuals=0):
    rng = np.random.RandomState(seed)
    batch = {'text': _text(cfg, seed, b),
             'target': rng.rand(b, cfg.num_targets, 16, 16, 3).astype(
                 np.float32),
             'description': [f'clip {i}' for i in range(b)]}
    if visuals:
        batch['visual'] = rng.rand(b, visuals, 16, 16, 3).astype(np.float32)
        batch['visual_neg'] = rng.rand(b, visuals, 16, 16, 3).astype(
            np.float32)
    return batch


def _same_pages(jweb, pweb, names):
    """The web pages of both packages: the same images/ (each video a
    GIF of the same frame count and size) and the same index.html."""
    assert sorted(os.listdir(pweb / 'images')) == sorted(
        os.listdir(jweb / 'images')) == names
    for n in names:
        with Image.open(pweb / 'images' / n) as p, \
                Image.open(jweb / 'images' / n) as j:
            assert (p.n_frames, p.size) == (j.n_frames, j.size), n
    assert (pweb / 'index.html').read_text() == \
        (jweb / 'index.html').read_text()


def test_visualize_train_debug_matches_jax(pair, hook, tmp_path):
    """The sample grids in out_dir and, on the web page, the same GIFs
    and index.html as JAX's."""
    jmodel, pmodel = pair
    batch = _batch(jmodel.cfg, 10)
    kw = dict(n_per_sample=1, mask_predict_steps=STEPS, debug=True)
    jviz.visualize_train(jmodel, batch, jax.random.PRNGKey(0),
                         str(tmp_path / 'j'), 3,
                         webpage=jhtml.HTML(str(tmp_path / 'jweb'), 't'),
                         **kw)
    pviz.visualize_train(pmodel, batch, torch.Generator(),
                         str(tmp_path / 'p'), 3,
                         webpage=phtml.HTML(str(tmp_path / 'pweb'), 't'),
                         **kw)
    files = _same_grids(tmp_path / 'j', tmp_path / 'p')
    assert files == ['0000003_0.png', '0000003_1.png',
                     '0000003_captions.txt', '0000003_pnag']
    _same_pages(tmp_path / 'jweb', tmp_path / 'pweb',
                ['0000003_0.gif', '0000003_1.gif'])
    assert sorted(os.listdir(tmp_path / 'p' / '0000003_pnag')) == [
        '00.png', '01.png']
    # real, then the first decode and two rows a later step
    grid = _pixels(tmp_path / 'p' / '0000003_pnag' / '00.png')
    assert grid.shape == ((2 + 2 * (STEPS - 1)) * 18, 4 * 16, 3)


def test_visualize_long_page_matches_jax(pair, hook, tmp_path):
    """``--eval_mode long``'s writer: the same ``long_{i}.png`` strips and
    the same page (``long_{i}.gif``, index.html) as JAX's."""
    jmodel, pmodel = pair
    batch = _batch(jmodel.cfg, 11)
    kw = dict(long_mode='long', t_repeat=2, t_overlap=1,
              mask_predict_steps=STEPS)
    jviz.visualize_long(jmodel, batch, jax.random.PRNGKey(2),
                        str(tmp_path / 'j'),
                        webpage=jhtml.HTML(str(tmp_path / 'jweb'), 'long'),
                        **kw)
    pviz.visualize_long(pmodel, batch, torch.Generator(), str(tmp_path / 'p'),
                        webpage=phtml.HTML(str(tmp_path / 'pweb'), 'long'),
                        **kw)
    assert _same_grids(tmp_path / 'j', tmp_path / 'p') == [
        'long_0.png', 'long_1.png']
    _same_pages(tmp_path / 'jweb', tmp_path / 'pweb',
                ['long_0.gif', 'long_1.gif'])


@pytest.fixture(scope='module')
def shapes_pair(pair):
    jmodel = jax_model(seed=31, num_targets=2, num_visuals=3,
                       vae=pair[0].vae)
    return jmodel, port_model(jmodel)


def test_visualize_train_shapes_rows_match_jax(shapes_pair, hook, tmp_path):
    """Three control slots, each swapped alone for ``visual_neg``: three
    rows after the samples."""
    jmodel, pmodel = shapes_pair
    batch = _batch(jmodel.cfg, 11, visuals=3)
    kw = dict(n_per_sample=1, mask_predict_steps=STEPS,
              mask_predict_steps1=STEPS, test_mode='shapes')
    jviz.visualize_train(jmodel, batch, jax.random.PRNGKey(0),
                         str(tmp_path / 'j'), 0, **kw)
    pviz.visualize_train(pmodel, batch, torch.Generator(),
                         str(tmp_path / 'p'), 0, **kw)
    _same_grids(tmp_path / 'j', tmp_path / 'p')
    grid = _pixels(tmp_path / 'p' / '0000000_0.png')
    # real, recon, 1 sample, 3 slot rows
    assert grid.shape == (6 * 18, (3 + 2) * 16, 3)


# -- the test driver, --eval_mode long ----------------------------------------

DRIVER_HPARAMS = {'dim': 64, 'text_seq_len': 12, 'num_targets': 4,
                  'num_visuals': 0, 'image_size': 32,
                  'which_transformer': 'custom:64:2:2'}


@pytest.fixture(scope='module')
def driver_run(tmp_path_factory):
    """A clip tree (2 clips of 8 frames at 32 px) and a ``dalle.pt`` of
    the driver's tiny model at 4 frames without VQGAN weights (the driver
    keeps its own VQGAN)."""
    root = tmp_path_factory.mktemp('long')
    rng = np.random.RandomState(0)
    for i in range(2):
        key = f'id{i:05d}#c{i}#000'
        d = root / 'data' / 'video' / key
        d.mkdir(parents=True)
        for j in range(8):
            png.write_png(d / f'{j:03d}.png',
                          rng.randint(0, 255, (32, 32, 3)).astype(np.uint8))
        (root / 'data' / 'txt').mkdir(exist_ok=True)
        (root / 'data' / 'txt' / f'{key}.txt').write_text(
            f'a person number {i} is talking\n')
    args = process_args(train=False, argv=[
        '--image_text_folder', str(root / 'data'),
        '--which_transformer', 'custom:64:2:2', '--dim', '64',
        '--text_seq_len', '12', '--num_targets', '4', '--num_visuals', '0',
        '--image_size', '32', '--device', 'cpu'])
    model = factories.get_driver_model(args, 'cpu', training=False)
    weights = {k: v for k, v in model.state_dict().items()
               if not k.startswith('vae.')}
    torch.save({'iter': 1, 'hparams': DRIVER_HPARAMS, 'weights': weights},
               root / 'dalle.pt')
    return root


@pytest.mark.parametrize('mode,extra,frames', [
    ('long', ['--t_repeat', '3', '--t_overlap', '1'], 4 + 2 * 3),
    ('interp', ['--t_repeat', '3'], 16),
    ('interp_real', ['--t_repeat', '2'], 7)])
def test_test_driver_long_modes(driver_run, mode, extra, frames):
    logs = driver_run / mode
    out = ptest.main_worker(process_args(train=False, argv=[
        '--image_text_folder', str(driver_run / 'data'), '--dataset',
        'video_text', '--name', 'long', '--log_root', str(logs),
        '--dalle_path', str(driver_run / 'dalle.pt'), '--batch_size', '2',
        '--frame_num', '4', '--frame_step', '2', '--num_workers', '1',
        '--mask_predict_steps', '2', '--device', 'cpu', '--eval_mode',
        'long', '--long_mode', mode, '--save_codebook', *extra]))
    assert out['long_dir'] == str(logs / 'long' / 'long')
    assert out['video'].shape == (2, frames, 32, 32, 3)
    assert 0 <= out['video'].min() and out['video'].max() <= 1
    for i in range(2):
        strip = png.read_rgb(os.path.join(out['long_dir'], f'long_{i}.png'))
        assert strip.shape == (32, frames * 32, 3)
    codes = np.load(logs / 'long' / 'codebook_long.npy')
    # the full VQGAN at 32 px: 2 x 2 ids a frame
    assert codes.shape == (2, frames * 4)
    assert codes.dtype == np.int64 and 0 <= codes.min() and \
        codes.max() < 1024


@pytest.fixture(scope='module')
def shapes_run(driver_run):
    """A moving-shapes tree (9 clips of 12 frames at 32 px) and a
    ``dalle.pt`` of the driver's tiny model with 3 visual controls and a
    cvae, without VQGAN weights."""
    from chip_smoke import write_shapes_data
    root = driver_run / 'shapes_run'
    write_shapes_data(str(root / 'shapes'), 9, 12, 32)
    args = process_args(train=False, argv=[
        '--image_text_folder', str(root / 'shapes'),
        '--which_transformer', 'custom:64:2:2', '--dim', '64',
        '--text_seq_len', '12', '--num_targets', '4', '--visual',
        '--num_visuals', '3', '--image_size', '32', '--device', 'cpu'])
    model = factories.get_driver_model(args, 'cpu', use_cvae=True,
                                       training=False)
    weights = {k: v for k, v in model.state_dict().items()
               if not k.startswith(('vae.', 'cvae.'))}
    torch.save({'iter': 1, 'hparams': dict(DRIVER_HPARAMS, num_visuals=3),
                'weights': weights}, root / 'dalle.pt')
    return root


@pytest.mark.parametrize('dataset,extra,rows', [
    ('shape', [], 3), ('iper', ['--slow'], 3),
    ('shape_attr', ['--negvc', '--attr_mode', 'color+shape+background+rand',
                    '--use_cvae'], 8)])
def test_test_driver_shapes_datasets(driver_run, shapes_run, dataset, extra,
                                     rows):
    """The sampling grids over the shapes and iPER datasets with
    ``--test_mode shapes``: without visual controls the grid is real,
    reconstruction and the sample; with 3 controls and their negatives
    (shape_attr) the counterfactual and free rows and a row a slot
    follow."""
    dalle = shapes_run / 'dalle.pt' if dataset == 'shape_attr' else \
        driver_run / 'dalle.pt'
    logs = shapes_run / dataset
    out = ptest.main_worker(process_args(train=False, argv=[
        '--image_text_folder', str(shapes_run / 'shapes'), '--dataset',
        dataset, '--name', 'shapes', '--log_root', str(logs),
        '--dalle_path', str(dalle), '--batch_size', '2', '--frame_num', '4',
        '--frame_step', '2', '--num_workers', '1', '--n_per_sample', '1',
        '--mask_predict_steps', '2', '--mask_predict_steps1', '2',
        '--test_mode', 'shapes', '--device', 'cpu', *extra]))
    grid = png.read_rgb(os.path.join(out['sample_dir'], '0000000_0.png'))
    assert grid.shape[0] == rows * (32 + 2)
    caption = (logs / 'shapes' / 'samples' / '0000000_captions.txt'
               ).read_text().split('\n')[0]
    if dataset == 'iper':
        assert caption.endswith(' speed.')
    elif dataset == 'shape_attr':
        assert caption.startswith('An object with ')


def test_artv_takes_the_long_calls_without_preserving(monkeypatch):
    """ART-V's ``generate_images`` takes the mask-predict keywords and
    ignores them (``**unused``, as JAX's ``ArtvModel.generate_images``
    does): the long modes run, at their frame counts, and each window is
    a fresh sample whose first frame is not the previous window's last."""
    model, _ = factories.artv_tiny(device='cpu', seed=0)
    text = torch.randint(1, 50, (2, model.cfg.text_seq_len),
                         generator=torch.Generator().manual_seed(0))
    calls = []
    _recording(monkeypatch, model, calls)
    video = pviz.generate_long_video(model, torch.Generator(), text,
                                     t_repeat=2, t_overlap=1)
    assert video.shape == (2, 2 + 1, 32, 32, 3)
    n = model.cfg.image_seq_len
    assert not np.array_equal(calls[1][:, :n], calls[0][:, -n:])
    video = pviz.generate_interpolated_video(model, torch.Generator(), text,
                                             levels=1)
    assert video.shape == (2, 2 * 2, 32, 32, 3)
