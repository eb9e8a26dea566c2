"""The port's whole sampling slice, entry points and packaging, on the CPU.

* ``MMVIDBert.generate_images`` vs the JAX package's, with ``build_spec``
  patched to the deterministic test hook in both: tokens equal, videos
  within 1e-4 (fp32 decode, sums in another order).
* The tokenizer, checkpoint interchange with the JAX package's writer and
  reader, ``generate.main``, the import boundary (no jax, flax, regex, PIL
  or imageio on the card path), and the no-fallback rules.
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
from mmvid_tpu_torch.ops import sample_head as S
from mmvid_tpu_torch.tokenizer import SimpleTokenizer
from mmvid_tpu_torch.weights import ENCODER_PREFIXES, read_dalle_checkpoint
from test_torch_clip_bert import jax_tiny, port_tiny

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


def test_generate_images_visual_not_ported(pair):
    _, _, pmodel = pair
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        pmodel.generate_images(torch.Generator(),
                               torch.ones((1, 8), dtype=torch.long),
                               visual=torch.zeros((1, 1, 16, 16, 3)))


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
    """Every module of the port, plus the JAX-params bridge it loads on
    demand, imports no jax, flax, regex, PIL or imageio, and nothing of
    mmvid_tpu beyond the numpy-only torch_compat."""
    code = (
        'import importlib, pkgutil, sys\n'
        'import mmvid_tpu_torch\n'
        'for m in pkgutil.walk_packages(mmvid_tpu_torch.__path__, '
        "'mmvid_tpu_torch.'):\n"
        '    importlib.import_module(m.name)\n'
        'import mmvid_tpu.utils.torch_compat\n'
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'regex', 'PIL', 'imageio')]\n"
        "bad += [m for m in sys.modules if m.split('.')[0] == 'mmvid_tpu' "
        "and m not in ('mmvid_tpu', 'mmvid_tpu.utils', "
        "'mmvid_tpu.utils.torch_compat')]\n"
        'assert not bad, bad\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_checkpoint_interchange_with_jax(pair, tmp_path):
    jmodel, jvae, _ = pair
    # JAX writer -> port reader
    path = tmp_path / 'jax_dalle.pt'
    save_dalle_checkpoint(str(path), params=jmodel.params,
                          vae_params=jvae.params, hparams={'dim': 64})
    ckpt = read_dalle_checkpoint(str(path))
    assert ckpt['hparams'] == {'dim': 64}
    pmodel, _ = factories.flagship(tiny=True, seed=9)
    from mmvid_tpu_torch.weights import load_weights
    load_weights(pmodel, ckpt['weights'])
    want = bert_params_to_torch(jmodel.params, jvae.params)
    got = pmodel.state_dict()
    assert set(got) == {k for k in want if not k.startswith(
        ENCODER_PREFIXES)}
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    # port writer -> JAX reader
    path2 = tmp_path / 'port_dalle.pt'
    torch.save({'iter': 3, 'hparams': {}, 'weights': pmodel.state_dict()},
               path2)
    back = load_dalle_checkpoint(str(path2))
    assert back['iter'] == 3
    for p, v in _flat(jmodel.params):
        node = back['params']
        for k in p:
            node = node[k]
        np.testing.assert_array_equal(np.asarray(node), v,
                                      err_msg='/'.join(p))
    for p, v in _flat(jvae.params):
        if p[0] in ('encoder', 'quant_conv'):
            continue
        node = back['vae']
        for k in p:
            node = node[k]
        np.testing.assert_array_equal(np.asarray(node), v,
                                      err_msg='/'.join(p))


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
    model = factories.get_dalle(args, factories.get_vae_model(args))
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
