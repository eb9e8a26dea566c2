"""The port's fixed language model (``--fixed_language_model
roberta-large``: ``roberta_tokenizer.py``, ``models/roberta.py``,
``utils/hf_archive.py``, ``factories.get_fixed_language_model``) and the
feature text of the model (``BertCore.text_feature_mapping``, the loss,
``generate_images``, int8 calibration) against the JAX package's, on the
CPU, fp32, at a tiny size.

One synthetic RoBERTa folder (``chip_smoke.write_roberta_archive``: the
256 byte symbols plus 50 merges learned on the recipe's captions, 2
layers of 32, N(0, 0.02) weights, a ``RobertaForMaskedLM`` archive) and
one JAX baseline a module (``mmvid_tpu.factories.get_fixed_language_model``
through ``transformers``' ``AutoTokenizer`` and ``FlaxRobertaModel``).

Tolerances: token ids and masks exact; features rtol 1e-5 / atol 1e-6
(fp32 on both sides, sums in another order); ``control_embedding`` and
logits 1e-5; losses 1e-5 (tests/test_torch_training.py's ``LOSS_TOL``);
tokens equal under the deterministic sampler hook, videos within 1e-4
(tests/test_torch_generate.py's); calibrated scales within their rounding
step (tests/test_torch_int8.py's ``SCALE_STEP``).
"""

import inspect
import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import ROBERTA_CAPTIONS, write_roberta_archive
from mmvid_tpu import factories as jfactories
from mmvid_tpu.models import bert as jbert
from mmvid_tpu.models import mmvid as jmmvid
from mmvid_tpu.models.clip import ClipStackConfig as JaxClip
from mmvid_tpu.models.vqgan import VQGanConfig as JaxVQCfg
from mmvid_tpu.models.vqgan import VQGanVAE as JaxVAE
from mmvid_tpu.ops import int8 as jint8
from mmvid_tpu.utils.torch_compat import convert_vqgan
from mmvid_tpu_torch import factories
from mmvid_tpu_torch.models import bert as pbert
from mmvid_tpu_torch.models import mmvid as pmmvid
from mmvid_tpu_torch.models.clip import ClipStackConfig
from mmvid_tpu_torch.models.roberta import RobertaConfig
from mmvid_tpu_torch.models.vqgan import VQGanConfig, VQGanVAE
from mmvid_tpu_torch.ops import int8 as pint8
from mmvid_tpu_torch.roberta_tokenizer import RobertaTokenizer, pre_tokenize
from mmvid_tpu_torch.utils import hf_archive
from mmvid_tpu_torch.weights import load_jax_params, roberta_params_to_torch
from test_torch_eval import one_thread  # noqa: F401 (a fixture)
from test_torch_generate import _deterministic
from test_torch_int8 import SCALE_STEP
from test_torch_training import LOSS_TOL, _jax_msm_mask
from test_torch_warp import jax_warp_draws

TINY = RobertaConfig(hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=64,
                     max_position_embeddings=134, type_vocab_size=1,
                     layer_norm_eps=1e-5)
FEAT_RTOL, FEAT_ATOL = 1e-5, 1e-6
CAPTIONS = list(ROBERTA_CAPTIONS) + [
    "It's a man's hat; they're here, we've seen it, I'm sure he'll go.",
    "I'M SURE IT'S 'S", "don't won't can't", 'Room 101: 3 doors, 2.5 m, '
    '1999-2024', 'a  b', 'two   spaces  ', 'tab\there\t\tand\tthere',
    'new\nline\n\nparagraph\n', 'trailing ', '  leading', ' ', '', '\t',
    'Café naïve résumé Zoë', '東京タワー と 大阪', 'emoji 😀 and 👍🏽!',
    'mixed123abc 456def', 'punctuation!!! ...?? ---',
    'quotes "double" and \'single\'', 'Ⅻ ½ ² ٣', 'a b　c',
    'x' * 300, 'a ' * 100]


def _base_state(folder):
    return hf_archive.read_state_dict(folder, prefix='roberta')


@pytest.fixture(scope='module')
def archives(tmp_path_factory):
    """{kind: folder}: the writer's RobertaForMaskedLM ``pytorch_model.bin``
    (``roberta.`` prefix, an ``lm_head``), and the same weights as a base
    model's ``model.safetensors`` and ``pytorch_model.bin``."""
    from safetensors.torch import save_file
    root = tmp_path_factory.mktemp('roberta')
    masked = str(root / 'masked_lm')
    write_roberta_archive(masked, TINY, seed=3)
    sd = _base_state(masked)
    out = {'masked_lm': masked}
    for kind in ('safetensors', 'bin'):
        folder = root / kind
        folder.mkdir()
        for name in ('config.json', 'vocab.json', 'merges.txt'):
            shutil.copy(os.path.join(masked, name), folder / name)
        if kind == 'safetensors':
            save_file({k: v.contiguous() for k, v in sd.items()},
                      str(folder / 'model.safetensors'))
        else:
            torch.save(sd, folder / 'pytorch_model.bin')
        out[kind] = str(folder)
    yield out
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope='module')
def jax_lm(archives):
    """JAX's encode on the masked-LM folder: (features of CAPTIONS, the
    FlaxRobertaModel's params, the AutoTokenizer it tokenizes with)."""
    prev = os.environ.get('ROBERTA_PATH')
    os.environ['ROBERTA_PATH'] = archives['masked_lm']
    try:
        encode, dim = jfactories.get_fixed_language_model(
            types.SimpleNamespace(fixed_language_model='roberta-large'))
    finally:
        if prev is None:
            os.environ.pop('ROBERTA_PATH')
        else:
            os.environ['ROBERTA_PATH'] = prev
    assert dim == TINY.hidden_size
    free = inspect.getclosurevars(encode).nonlocals
    return encode(CAPTIONS), free['model'].params, free['tok']


def _port_encode(folder, monkeypatch):
    monkeypatch.setenv('ROBERTA_PATH', folder)
    return factories.get_fixed_language_model(
        types.SimpleNamespace(fixed_language_model='roberta-large'), 'cpu')


# -- (a) the tokenizer ------------------------------------------------------

def test_tokenizer_matches_autotokenizer(archives, jax_lm):
    """Ids and masks of the ~30 captions (the recipe's; contractions,
    digits, runs of spaces, tabs, newlines, trailing spaces; accents, CJK,
    an emoji; two longer than 128 ids) equal AutoTokenizer's, called as
    JAX calls it, batched and one at a time."""
    _, _, hf = jax_lm
    port = RobertaTokenizer(archives['masked_lm'])
    want = hf(CAPTIONS, padding=True, truncation=True, max_length=128,
              return_tensors='np')
    ids, mask = port(CAPTIONS)
    assert ids.shape == want['input_ids'].shape == (len(CAPTIONS), 128)
    np.testing.assert_array_equal(ids, want['input_ids'])
    np.testing.assert_array_equal(mask, want['attention_mask'])
    for text in CAPTIONS[:-2]:
        assert [0] + port.encode(text) + [2] == hf(text)['input_ids'], text


def test_tokenizer_reads_tokenizer_json(archives, jax_lm, tmp_path):
    """A folder with only ``tokenizer.json`` (AutoTokenizer's own save):
    the same ids, with its merges as pairs and as ``"a b"`` strings."""
    _, _, hf = jax_lm
    hf.save_pretrained(str(tmp_path))
    for name in ('vocab.json', 'merges.txt'):
        (tmp_path / name).unlink(missing_ok=True)
    want, _ = RobertaTokenizer(archives['masked_lm'])(CAPTIONS)
    path = tmp_path / 'tokenizer.json'
    spec = json.loads(path.read_text())
    for form in ('as saved', 'strings'):
        if form == 'strings':
            spec['model']['merges'] = [
                m if isinstance(m, str) else ' '.join(m)
                for m in spec['model']['merges']]
            path.write_text(json.dumps(spec))
        got, _ = RobertaTokenizer(str(tmp_path))(CAPTIONS)
        np.testing.assert_array_equal(got, want, err_msg=form)


def test_tokenizer_refuses_special_token_strings(archives):
    tok = RobertaTokenizer(archives['masked_lm'])
    for text in ('a <mask> b', '</s>', 'x<s>'):
        with pytest.raises(ValueError, match='special token'):
            tok([text])


def test_pre_tokenizer_matches_regex():
    """The scanner against ``regex.findall`` of the GPT-2 pattern, on 200
    strings drawn over letters, digits, marks, symbols, apostrophes and
    every kind of whitespace.  Code points that Python's ``unicodedata``
    has unassigned (category Cn) are left out: a newer ``regex`` may class
    them as letters, a difference of Unicode versions, not of the
    scanner (as ``tokenizer.py``'s docstring says of CLIP's pattern)."""
    regex = pytest.importorskip('regex')
    from hypothesis import given, settings
    from hypothesis import strategies as st
    pattern = regex.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"""
        r"""|\s+(?!\S)|\s+""")
    alphabet = st.one_of(
        st.sampled_from(list(" '\t\n\r\x0b\x0c\x1c\x1f\x85\xa0 　"
                             'sStTdmlrve')),
        st.characters(exclude_categories=('Cn',)))

    @settings(max_examples=200, deadline=None, database=None,
              derandomize=True)
    @given(st.text(alphabet, max_size=24))
    def check(text):
        assert pre_tokenize(text) == pattern.findall(text)

    check()


# -- (b), (c) the features ---------------------------------------------------

@pytest.mark.parametrize('kind', ['safetensors', 'bin', 'masked_lm'])
def test_features_match_jax(archives, jax_lm, kind, monkeypatch):
    """The port's encode on each archive kind equals JAX's
    get_fixed_language_model: [B, 32] fp32 within rtol 1e-5 / atol 1e-6."""
    want, _, _ = jax_lm
    encode, dim = _port_encode(archives[kind], monkeypatch)
    got = encode(CAPTIONS)
    assert dim == TINY.hidden_size and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=FEAT_RTOL,
                               atol=FEAT_ATOL)


def test_roberta_params_to_torch_gives_jax_features(archives, jax_lm):
    """JAX's FlaxRobertaModel params carried over by
    roberta_params_to_torch give JAX's features (every key, the pooler
    left out)."""
    from mmvid_tpu_torch.models.roberta import RobertaModel
    want, params, _ = jax_lm
    folder = archives['masked_lm']
    model = RobertaModel(RobertaConfig.from_json(
        hf_archive.read_config(folder)), RobertaTokenizer(folder))
    sd = roberta_params_to_torch(jax.tree_util.tree_map(np.asarray, params))
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    got = model.eval().encode(CAPTIONS)
    np.testing.assert_allclose(got.numpy(), want, rtol=FEAT_RTOL,
                               atol=FEAT_ATOL)


def test_archive_normalisation(archives, tmp_path, monkeypatch):
    """The loader's key rules: ``roberta.`` stripped, ``lm_head.*`` and
    ``pooler.*`` and the position-id buffer dropped, LayerNorm gamma/beta
    renamed; a folder with only ``flax_model.msgpack`` raises naming the
    two formats read; a missing ROBERTA_PATH raises naming the variable."""
    sd = _base_state(archives['masked_lm'])
    raw = {f'roberta.{k}'.replace('LayerNorm.weight', 'LayerNorm.gamma')
           .replace('LayerNorm.bias', 'LayerNorm.beta'): v
           for k, v in sd.items()}
    raw['roberta.embeddings.position_ids'] = torch.arange(3)
    raw['roberta.pooler.dense.weight'] = torch.zeros(2, 2)
    raw['lm_head.bias'] = torch.zeros(4)
    got = hf_archive.normalize_keys(raw, 'roberta')
    assert sorted(got) == sorted(sd)
    (tmp_path / 'flax_model.msgpack').write_bytes(b'')
    with pytest.raises(FileNotFoundError, match='model.safetensors or '
                       'pytorch_model.bin.*flax_model.msgpack'):
        hf_archive.read_state_dict(str(tmp_path), 'roberta')
    with pytest.raises(FileNotFoundError, match='ROBERTA_PATH'):
        _port_encode(str(tmp_path / 'absent'), monkeypatch)


# -- (d)-(f) feature text in the model ---------------------------------------

VQ = dict(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1,
          z_channels=64, embed_dim=64, n_embed=1024, attn_resolutions=())

_MODELS = {}


def _vae_params():
    """A tiny VQGAN's params in JAX's form: the port's initialisation
    from a seed, the codebook spread (randn), through JAX's
    ``convert_vqgan`` (no flax init to compile)."""
    if 'vae' not in _MODELS:
        vae = VQGanVAE(image_size=16, cfg=VQGanConfig(**VQ))
        factories.init_weights(vae, torch.Generator().manual_seed(2))
        sd = {k: v.numpy() for k, v in vae.model.state_dict().items()}
        sd['quantize.embedding.weight'] = np.random.RandomState(3).randn(
            *sd['quantize.embedding.weight'].shape).astype(np.float32)
        _MODELS['vae'] = jax.tree_util.tree_map(jnp.asarray,
                                                convert_vqgan(sd))
    return _MODELS['vae']


def _models(bottleneck):
    """(JAX MMVIDBert, the port's MMVIDBert with its weights) of a tiny
    fixed-LM model: 32 features (the tiny RoBERTa's width) through one
    Linear, or the LN-Linear-LN-Linear-LN bottleneck of ``bottleneck``;
    JAX's init carried to the port by bert_params_to_torch."""
    if bottleneck in _MODELS:
        return _MODELS[bottleneck]
    k_bert = jax.random.PRNGKey(11)
    vae_params = _vae_params()
    jvae = JaxVAE(image_size=16, cfg=JaxVQCfg(**VQ), params=vae_params)
    kw = dict(dim=64, num_text_tokens=100, text_seq_len=1, num_visuals=0,
              num_targets=2, num_image_tokens=1024, image_fmap_size=8,
              image_size=16, fixed_language_model='roberta-large',
              text_feature_dim=TINY.hidden_size,
              text_emb_bottleneck=bottleneck)
    jcfg = jbert.BertConfig(**kw, clip=JaxClip(width=64, layers=2, heads=2))
    params = jax.jit(jbert.BertCore(jcfg).init)(
        k_bert, jnp.zeros((1, jcfg.text_feature_dim)), None,
        jnp.zeros((1, jcfg.target_seq_len), jnp.int32))['params']
    jmodel = jmmvid.MMVIDBert(jcfg, jvae, params=params)
    pcfg = pbert.BertConfig(**kw, clip=ClipStackConfig(width=64, layers=2,
                                                       heads=2))
    pmodel = pmmvid.MMVIDBert(pcfg, VQGanVAE(image_size=16,
                                             cfg=VQGanConfig(**VQ)))
    load_jax_params(pmodel, params, vae_params)
    _MODELS[bottleneck] = jmodel, pmodel.eval()
    return _MODELS[bottleneck]


def _features(b=4, seed=0):
    return np.random.RandomState(seed).randn(
        b, TINY.hidden_size).astype(np.float32)


@pytest.mark.parametrize('bottleneck', [None, '64'])
def test_bert_core_on_features_matches_jax(bottleneck, one_thread):
    """control_embedding (one text token) and the forward's logits on
    [B, 32] features, with text_feature_mapping as one Linear and as the
    64-wide bottleneck, the params carried over by bert_params_to_torch;
    ids fed to a fixed-LM core raise."""
    jmodel, pmodel = _models(bottleneck)
    cfg = jmodel.cfg
    assert pmodel.cfg.control_seq_len == cfg.control_seq_len == 4
    feats = _features()
    target = np.random.RandomState(1).randint(
        0, 1025, (4, cfg.target_seq_len)).astype(np.int32)
    apply = lambda method, *a: jmodel.core.apply(
        {'params': jmodel.params}, *a, method=method)
    want_c = apply(jbert.BertCore.control_embedding, jnp.asarray(feats))
    want_l = apply(jbert.BertCore.__call__, jnp.asarray(feats), None,
                   jnp.asarray(target))[0]
    with torch.no_grad():
        got_c = pmodel.core.control_embedding(torch.from_numpy(feats))
        got_l = pmodel.core(torch.from_numpy(feats), None,
                            torch.from_numpy(target).long())[0]
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError, match='float features'):
        pmodel.core.control_embedding(torch.zeros((1, 1), dtype=torch.long))


def test_loss_on_features_matches_jax(one_thread):
    """MMVIDBert.loss on features and frames (rel with not-fully-masked
    weighting, vid), the port fed JAX's draws for its key: the three
    losses within LOSS_TOL."""
    jmodel, pmodel = _models(None)
    cfg, b = jmodel.cfg, 4
    feats = _features(b, 2)
    frames = np.random.RandomState(3).uniform(
        0, 1, (b, 2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    kw = dict(rel=True, vid=True, rel_no_fully_masked=True)
    want = jax.jit(lambda p, k, t, f: jmodel.loss(p, k, text=t, target=f,
                                                  **kw))(
        jmodel.params, key, jnp.asarray(feats), jnp.asarray(frames))
    _, k_mask, k_warp = jax.random.split(key, 3)
    keep, nfm = _jax_msm_mask(k_mask, cfg, (0.7, 0.1, 0.1, 0.1),
                              (0.2, 0.5), 0.0, b)
    draws = {'keep': torch.from_numpy(np.array(keep)),
             'nfm': torch.from_numpy(np.array(nfm)),
             'warp': jax_warp_draws(k_warp, b, 2)}
    with torch.no_grad():
        got = pmodel.loss(torch.Generator(), text=torch.from_numpy(feats),
                          target=torch.from_numpy(frames), draws=draws,
                          **kw)
    for name, g, w in zip(('msm', 'rel', 'vid'), got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=0,
                                   atol=LOSS_TOL, err_msg=name)


def test_slice_generates_as_jax(archives, jax_lm, monkeypatch, one_thread):
    """The whole slice: captions -> each package's fixed LM -> its
    model's generate_images under the deterministic sampler hook: tokens
    equal, videos within 1e-4."""
    jmodel, pmodel = _models(None)
    monkeypatch.setattr(jmmvid, 'build_spec',
                        _deterministic(jmmvid.build_spec))
    monkeypatch.setattr(pmmvid, 'build_spec',
                        _deterministic(pmmvid.build_spec))
    caps = list(ROBERTA_CAPTIONS[:3])
    encode, _ = _port_encode(archives['masked_lm'], monkeypatch)
    want_v, want_t = jmodel.generate_images(
        jax.random.PRNGKey(0), jnp.asarray(jax_lm[0][:3]),
        mask_predict_steps=6, dynamic=False)
    got_v, got_t = pmodel.generate_images(
        torch.Generator().manual_seed(0), encode(caps),
        mask_predict_steps=6, dynamic=False)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=1e-4, atol=1e-4)


def test_int8_calibration_on_features_matches_jax(one_thread):
    """The whole-model calibration forwards of a fixed-LM model on the
    same features (all-[MASK] and random targets): abs-max scales within
    their rounding step of JAX's; quantize_for_serving draws its own
    features (no ids) and the quantized copy samples."""
    jmodel, pmodel = _models(None)
    cfg = jmodel.cfg
    feats = _features(4, 5)
    rng = np.random.RandomState(6)
    targets = (np.full((4, cfg.target_seq_len), cfg.mask_token, np.int32),
               rng.randint(0, 1024, (4, cfg.target_seq_len)).astype(
                   np.int32))
    trees, recs = [], []
    for target in targets:
        _, aux = jmodel.core.apply({'params': jmodel.params},
                                   jnp.asarray(feats), None,
                                   jnp.asarray(target),
                                   mutable=[jint8.CALIB_COL])
        trees.append(aux[jint8.CALIB_COL])
        with torch.no_grad(), pint8.recording() as r:
            pmodel.core(torch.from_numpy(feats), None,
                        torch.from_numpy(target).long())
        recs.append(r)
    got = pint8.calibrate_int8_scales(recs, cfg.clip.layers, None)
    want = jint8.calibrate_int8_scales(trees, cfg.clip.layers, None)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=SCALE_STEP)
    q = pint8.quantize_for_serving(pmodel, decoder=False)
    videos, tokens = q.generate_images(
        torch.Generator().manual_seed(0), torch.from_numpy(feats[:2]),
        mask_predict_steps=2, dynamic=False)
    assert tokens.shape == (2, cfg.target_seq_len)
    assert bool(torch.isfinite(videos).all())


def test_get_dalle_builds_the_feature_layout():
    """get_dalle with --fixed_language_model: one text token of the LM's
    width, no text embedding; ART-V refuses the flag."""
    args = factories.text_and_mask_args()
    args = types.SimpleNamespace(**{
        **vars(args), 'which_transformer': 'custom:64:2:2', 'dim': 64,
        'num_visuals': 0, 'image_size': 16,
        'fixed_language_model': 'roberta-large', 'text_emb_bottleneck': '8'})
    vae = VQGanVAE(image_size=16, cfg=VQGanConfig(**VQ))
    model = factories.get_dalle(args, vae, device='cpu',
                                text_feature_dim=24)
    assert model.cfg.text_seq_len == 1 and model.cfg.text_feature_dim == 24
    keys = [k for k in model.state_dict() if k.startswith('text_')]
    assert sorted(keys) == sorted(
        f'text_feature_mapping.{i}.{leaf}' for i in range(5)
        for leaf in ('weight', 'bias'))
    assert model.state_dict()['text_feature_mapping.1.weight'].shape == (
        8, 24)
    with pytest.raises(ValueError, match='ART-V'):
        factories.get_dalle(types.SimpleNamespace(**{**vars(args),
                                                     'ar': True}),
                            vae, device='cpu', text_feature_dim=24)
