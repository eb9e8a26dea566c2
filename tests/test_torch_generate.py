"""The port's whole sampling slices, entry points and packaging, on the CPU.

* ``MMVIDBert.generate_images`` vs the JAX package's, with ``build_spec``
  patched to the deterministic test hook in both: tokens equal, videos
  within 1e-4 (fp32 decode, sums in another order).  Text to video, and
  visual control (the text+mask recipe: cvae encode, ``mask_8x8`` erase,
  separate visual embedding) at the tiny size.
* The tokenizer, checkpoint interchange with the JAX package's writer and
  reader (encoder and cvae keys included), ``generate.main``, the import
  boundary (nothing of jax, flax, mmvid_tpu, regex, PIL or imageio on the
  card path), and the no-fallback rules.
"""

import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvid_tpu.models import mmvid as jmmvid
from mmvid_tpu.tokenizer import SimpleTokenizer as JaxTokenizer
from mmvid_tpu.utils.torch_compat import (
    bert_params_to_torch,
    load_dalle_checkpoint,
    save_dalle_checkpoint,
)
from mmvid_tpu_torch import factories, generate
from mmvid_tpu_torch.models import mmvid as pmmvid
from mmvid_tpu_torch.ops import _build
from mmvid_tpu_torch.ops import attention as A
from mmvid_tpu_torch.ops import codebook as C
from mmvid_tpu_torch.ops import sample_head as S
from mmvid_tpu_torch.tokenizer import SimpleTokenizer
from mmvid_tpu_torch.weights import read_dalle_checkpoint
from test_torch_clip_bert import jax_tiny, port_tiny
from test_torch_drivers import _one_thread  # noqa: F401 (module-wide)
from test_torch_encode import jax_tiny_visual, port_tiny_visual

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ['a woman with wavy hair is talking', 'un homme sourit à 3 h',
           'Ωμέγα: 東京 2024!!', "it's the man's 2nd take... (ok?)",
           'naïve café — résumé', '']


@pytest.fixture(scope='module')
def pair():
    jmodel, jvae = jax_tiny(seed=5)
    return jmodel, jvae, port_tiny(jmodel, jvae)


def _deterministic(build_spec):
    def patched(*a, **k):
        return dataclasses.replace(build_spec(*a, **k), deterministic=True)
    return patched


def test_generate_images_slice_matches_jax(pair, monkeypatch):
    jmodel, _, pmodel = pair
    monkeypatch.setattr(jmmvid, 'build_spec',
                        _deterministic(jmmvid.build_spec))
    monkeypatch.setattr(pmmvid, 'build_spec',
                        _deterministic(pmmvid.build_spec))
    cfg = jmodel.cfg
    text = np.random.RandomState(0).randint(
        0, cfg.num_text_tokens, (2, cfg.text_seq_len)).astype(np.int32)
    want_v, want_t = jmodel.generate_images(
        jax.random.PRNGKey(0), jnp.asarray(text), mask_predict_steps=6,
        dynamic=False)
    monkeypatch.setattr(A, 'launches', 0)
    monkeypatch.setattr(S, 'launches', 0)
    got_v, got_t = pmodel.generate_images(
        torch.Generator().manual_seed(0), torch.from_numpy(text),
        mask_predict_steps=6, dynamic=False)
    assert (A.launches, S.launches) == (0, 0)   # CPU: plain paths only
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert got_v.shape == (2, cfg.num_targets, 16, 16, 3)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope='module')
def visual_pair():
    jmodel, jvae, jcvae = jax_tiny_visual(seed=6)
    return jmodel, jvae, jcvae, port_tiny_visual(jmodel, jvae, jcvae)


def test_generate_images_visual_slice_matches_jax(visual_pair, monkeypatch):
    """The text+mask path: control frames -> cvae encode -> nearest code
    -> mask_8x8 erase (face_mode 'mask') -> visual_emb -> mask-predict ->
    decode."""
    jmodel, _, _, pmodel = visual_pair
    monkeypatch.setattr(jmmvid, 'build_spec',
                        _deterministic(jmmvid.build_spec))
    monkeypatch.setattr(pmmvid, 'build_spec',
                        _deterministic(pmmvid.build_spec))
    cfg = jmodel.cfg
    assert pmodel.cfg.total_seq_len == cfg.total_seq_len == 203
    rng = np.random.RandomState(1)
    text = rng.randint(0, cfg.num_text_tokens,
                       (2, cfg.text_seq_len)).astype(np.int32)
    visual = rng.rand(2, 1, 16, 16, 3).astype(np.float32)
    kw = dict(vc_mode='mask_8x8', face_mode='mask', mask_predict_steps=6,
              dynamic=False)
    want_v, want_t = jmodel.generate_images(
        jax.random.PRNGKey(0), jnp.asarray(text),
        visual=jnp.asarray(visual), **kw)
    for mod in (A, S, C):
        monkeypatch.setattr(mod, 'launches', 0)
    got_v, got_t = pmodel.generate_images(
        torch.Generator().manual_seed(0), torch.from_numpy(text),
        visual=torch.from_numpy(visual), **kw)
    assert (A.launches, S.launches, C.launches) == (0, 0, 0)  # CPU: plain
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert got_v.shape == (2, cfg.num_targets, 16, 16, 3)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=1e-4, atol=1e-4)
    # the control is what the JAX package builds, and it steers the tokens
    want_vis = jmodel.prepare_visual_tokens(
        jax.random.PRNGKey(0), jnp.asarray(visual), vc_mode='mask_8x8',
        face_mode='mask')
    got_vis = pmodel.prepare_visual_tokens(
        torch.Generator(), torch.from_numpy(visual), vc_mode='mask_8x8',
        face_mode='mask')
    np.testing.assert_array_equal(got_vis.numpy(), np.asarray(want_vis))
    _, no_vis = pmodel.generate_images(
        torch.Generator().manual_seed(0), torch.from_numpy(text),
        decode=False, **kw)
    assert not torch.equal(no_vis, got_t)


def test_generate_images_visual_not_ported(visual_pair):
    """What the visual path still lacks raises, pointing at the roadmap:
    erasers with insert_sep (unsupported in the JAX package too).  The
    motion-color augmentation is ported (models/warp.py, held to JAX in
    tests/test_torch_warp.py): it shifts the control frames after the
    first, as JAX's does, so this model's one control frame is kept."""
    _, _, _, pmodel = visual_pair
    frames = torch.rand((2, 1, 16, 16, 3),
                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(
        pmodel.prepare_visual_tokens(torch.Generator(), frames,
                                     visual_aug_mode='motion_color'),
        pmodel.prepare_visual_tokens(torch.Generator(), frames))
    sep_model, _ = factories.flagship(tiny=True, device='cpu',
                                      use_cvae=True)
    sep_model.cfg = dataclasses.replace(sep_model.cfg, insert_sep=True)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        sep_model.prepare_visual_tokens(torch.Generator(), frames,
                                        vc_mode='mask_8x8')


def test_cvae_forces_separate_visual_emb():
    model, _ = factories.flagship(tiny=True, device='cpu', use_cvae=True)
    assert model.cfg.use_separate_visual_emb and model.cfg.num_visuals == 1
    assert 'visual_emb.weight' in model.state_dict()
    assert any(k.startswith('cvae.model.encoder.')
               for k in model.state_dict())


def test_tokenizer_ids_match_jax_package():
    port, ref = SimpleTokenizer(), JaxTokenizer()
    corpus = PROMPTS + ['ПРИВЕТ мир', 'x² ½ Ⅻ ٣٤', 'tab\tnew\nline  end',
                        'ﬁne ＦＵＬＬ', '&amp; &lt;b&gt;', 'emoji 😀👍🏽!',
                        '<|startoftext|>hi<|endoftext|>', "we'll I'M",
                        'ͅab\x1cc\x1f d']
    for text in corpus:
        assert port.encode(text) == ref.encode(text), text
    np.testing.assert_array_equal(
        port.tokenize(corpus, 50, truncate_text=True),
        ref.tokenize(corpus, 50, truncate_text=True))


def test_card_path_imports_no_jax():
    """Every module of the port, and what generate.main imports lazily
    (its file writers), import no jax, flax, regex, PIL, imageio, cv2,
    sklearn, tensorflow, matplotlib, transformers, tokenizers or
    safetensors, and nothing of mmvid_tpu at all; and no import statement
    of PIL, imageio or cv2 stands anywhere in the port's source or in
    chip_smoke.py, inside functions included (the card's host has none of
    them)."""
    code = (
        'import importlib, pkgutil, sys\n'
        'import mmvid_tpu_torch\n'
        'for m in pkgutil.walk_packages(mmvid_tpu_torch.__path__, '
        "'mmvid_tpu_torch.'):\n"
        '    importlib.import_module(m.name)\n'
        'from mmvid_tpu_torch import generate, weights\n'
        'import mmvid_tpu_torch.utils.html as html\n'
        'assert generate.save_gif is html.save_gif\n'
        "assert weights.bert_params_to_torch.__module__ == "
        "'mmvid_tpu_torch.utils.torch_compat'\n"
        "weights.bert_params_to_torch({'text_emb': {'embedding': [[0.0]]}})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'regex', 'PIL', 'imageio', 'cv2', 'sklearn', "
        "'tensorflow', 'matplotlib', 'transformers', 'tokenizers', "
        "'safetensors', 'mmvid_tpu')]\n"
        'assert not bad, bad\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    import ast
    import glob
    files = glob.glob(os.path.join(REPO, 'mmvid_tpu_torch', '**', '*.py'),
                      recursive=True) + [os.path.join(REPO, 'chip_smoke.py')]
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ''] if isinstance(node, ast.ImportFrom)
                     else [])
            found += [f'{os.path.relpath(path, REPO)}:{node.lineno} {n}'
                      for n in names
                      if n.split('.')[0] in ('PIL', 'imageio', 'cv2')]
            if isinstance(node, ast.Call) and getattr(
                    node.func, 'id', getattr(node.func, 'attr', '')) in (
                    '__import__', 'import_module') and node.args and \
                    isinstance(node.args[0], ast.Constant) and str(
                        node.args[0].value).split('.')[0] in (
                        'PIL', 'imageio', 'cv2'):
                found.append(f'{os.path.relpath(path, REPO)}:{node.lineno}')
    assert len(files) > 50 and not found, found


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_checkpoint_interchange_with_jax(visual_pair, tmp_path):
    """A text+mask checkpoint crosses both ways with every key: the BERT,
    vae.model.* and cvae.model.*, encoders included; none is dropped."""
    jmodel, jvae, jcvae, _ = visual_pair
    # JAX writer -> port reader
    path = tmp_path / 'jax_dalle.pt'
    save_dalle_checkpoint(str(path), params=jmodel.params,
                          vae_params=jvae.params, cvae_params=jcvae.params,
                          hparams={'dim': 64})
    ckpt = read_dalle_checkpoint(str(path))
    assert ckpt['hparams'] == {'dim': 64}
    pmodel, _ = factories.flagship(tiny=True, device='cpu', seed=9,
                                   use_cvae=True)
    from mmvid_tpu_torch.weights import load_weights
    load_weights(pmodel, ckpt['weights'])
    want = bert_params_to_torch(jmodel.params, jvae.params, jcvae.params)
    got = pmodel.state_dict()
    assert set(got) == set(want)
    assert any(k.startswith('vae.model.encoder.') for k in got)
    assert any(k.startswith('cvae.model.quant_conv.') for k in got)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    # port writer -> JAX reader
    path2 = tmp_path / 'port_dalle.pt'
    torch.save({'iter': 3, 'hparams': {}, 'weights': pmodel.state_dict()},
               path2)
    back = load_dalle_checkpoint(str(path2))
    assert back['iter'] == 3
    for tree, key in ((jmodel.params, 'params'), (jvae.params, 'vae'),
                      (jcvae.params, 'cvae')):
        for p, v in _flat(tree):
            node = back[key]
            for k in p:
                node = node[k]
            np.testing.assert_array_equal(np.asarray(node), v,
                                          err_msg=f'{key}: {"/".join(p)}')


def test_load_weights_rejects_mismatch(pair):
    _, _, pmodel = pair
    sd = dict(pmodel.state_dict())
    sd.pop('to_logits.1.bias')
    from mmvid_tpu_torch.weights import load_weights
    with pytest.raises(KeyError, match='to_logits.1.bias'):
        load_weights(pmodel, sd)


@pytest.mark.parametrize('vae_in_dalle', [True, False])
def test_generate_main_writes_pngs(tmp_path, vae_in_dalle):
    hparams = {'dim': 64, 'text_seq_len': 12, 'num_targets': 2,
               'num_visuals': 0, 'image_size': 32,
               'which_transformer': 'custom:64:2:2'}
    args = SimpleNamespace(image_size=32, which_transformer='custom:64:2:2',
                           dim=64, text_seq_len=12, num_targets=2,
                           num_visuals=0, insert_sep=False,
                           use_separate_visual_emb=False,
                           fixed_language_model=None,
                           text_emb_bottleneck=None)
    model = factories.get_dalle(
        args, factories.get_vae_model(args, device='cpu'), device='cpu')
    factories.init_weights(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    argv = []
    if not vae_in_dalle:
        vae_sd = {k[len('vae.model.'):]: v for k, v in sd.items()
                  if k.startswith('vae.model.')}
        vae_sd['loss.discriminator.weight'] = torch.zeros(1)
        torch.save({'state_dict': vae_sd}, tmp_path / 'vae.ckpt')
        sd = {k: v for k, v in sd.items() if not k.startswith('vae.')}
        argv = ['--vae_path', str(tmp_path / 'vae.ckpt')]
    torch.save({'iter': 1, 'hparams': hparams, 'weights': sd},
               tmp_path / 'dalle.pt')
    (tmp_path / 'prompts.txt').write_text('a person is talking\n'
                                          'a man smiles\nshe laughs\n')
    generate.main(generate.parse_args(argv + [
        '--dalle_path', str(tmp_path / 'dalle.pt'),
        '--prompt_file', str(tmp_path / 'prompts.txt'),
        '--out_dir', str(tmp_path / 'out'), '--batch_size', '2',
        '--mask_predict_steps', '2', '--format', 'png', '--device', 'cpu',
        '--no-bf16']))
    pngs = sorted((tmp_path / 'out').glob('*.png'))
    txts = sorted((tmp_path / 'out').glob('*.txt'))
    assert len(pngs) == 3 and len(txts) == 3
    assert txts[0].read_text() == 'a person is talking'
    from PIL import Image
    assert Image.open(pngs[0]).size == (2 * 32, 32)   # 2 frames in a row


def test_checkpoint_vqgan_takes_precedence_over_vae_path(tmp_path):
    """A dalle.pt that holds its own VQGAN, given a different
    ``--vae_path``, decodes with the checkpoint's, as the root
    ``generate.py`` does (its ``get_vae_model`` loads the file, then the
    checkpoint's VQGAN replaces it); ``--cvae_path`` parses and, as there,
    changes nothing."""
    hparams = {'dim': 64, 'text_seq_len': 12, 'num_targets': 2,
               'num_visuals': 0, 'image_size': 32,
               'which_transformer': 'custom:64:2:2'}
    args = SimpleNamespace(**hparams, insert_sep=False,
                           use_separate_visual_emb=False,
                           fixed_language_model=None,
                           text_emb_bottleneck=None)
    model = factories.get_dalle(
        args, factories.get_vae_model(args, device='cpu'), device='cpu')
    factories.init_weights(model, torch.Generator().manual_seed(0))
    torch.save({'iter': 1, 'hparams': hparams,
                'weights': model.state_dict()}, tmp_path / 'dalle.pt')
    other = factories.get_vae_model(args, device='cpu')
    factories.init_weights(other, torch.Generator().manual_seed(1))
    torch.save({'state_dict': other.model.state_dict()},
               tmp_path / 'vae.ckpt')
    base = ['--dalle_path', str(tmp_path / 'dalle.pt'), '--device', 'cpu',
            '--no-bf16']
    loaded, _ = generate.load_model(generate.parse_args(base + [
        '--vae_path', str(tmp_path / 'vae.ckpt'),
        '--cvae_path', str(tmp_path / 'absent.ckpt')]))
    alone, _ = generate.load_model(generate.parse_args(base))
    assert loaded.cvae is None
    want = model.vae.model.state_dict()
    for k, v in loaded.vae.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert not torch.equal(other.model.decoder.conv_in.weight,
                           want['decoder.conv_in.weight'])
    ids = torch.randint(0, 1024, (2, loaded.cfg.image_seq_len),
                        generator=torch.Generator().manual_seed(2))
    assert torch.equal(loaded.vae.decode(ids), alone.vae.decode(ids))


def test_generate_main_artv_checkpoint(tmp_path):
    """A dalle.pt whose hparams say ``ar`` loads as ART-V (one visual
    block of pad ids, as get_dalle raises num_visuals to 1) and writes
    videos through the same CLI."""
    hparams = {'dim': 64, 'text_seq_len': 6, 'num_targets': 2,
               'num_visuals': 0, 'image_size': 32, 'ar': True,
               'which_transformer': 'custom:64:2:2'}
    args = SimpleNamespace(**hparams, loss_img_weight=7)
    model = factories.get_dalle(
        args, factories.get_vae_model(args, device='cpu'), device='cpu')
    assert type(model).__name__ == 'ArtvModel'
    factories.init_weights(model, torch.Generator().manual_seed(0))
    torch.save({'iter': 1, 'hparams': hparams,
                'weights': model.state_dict()}, tmp_path / 'dalle.pt')
    loaded, _ = generate.load_model(generate.parse_args(
        ['--dalle_path', str(tmp_path / 'dalle.pt'), '--device', 'cpu',
         '--no-bf16']))
    assert type(loaded).__name__ == 'ArtvModel'
    assert loaded.cfg.num_visuals == 1 and loaded.cfg.total_seq_len == 18
    generate.main(generate.parse_args([
        '--dalle_path', str(tmp_path / 'dalle.pt'), '--prompts',
        'a person is talking', 'she laughs', '--out_dir',
        str(tmp_path / 'out'), '--batch_size', '2', '--format', 'png',
        '--device', 'cpu', '--no-bf16']))
    pngs = sorted((tmp_path / 'out').glob('*.png'))
    assert len(pngs) == 2
    from PIL import Image
    assert Image.open(pngs[0]).size == (2 * 32, 32)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No nvcc means an error, never a stub library or a silent plain
    path."""
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setattr(_build, '_lib', None)
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.build()
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.library()
    assert _build._lib is None
