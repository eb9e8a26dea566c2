"""The port's full CLIP (``models/clip_full.py``), its archive reader
(``utils/torch_compat.py``, ``models/clip.py::load_openai_clip_stack``)
and the pretrained-stack graft (``factories.get_driver_model``) against
the JAX package's, on one tiny ``ViT-B-32.pt``-format torch.jit archive
that the port's own :class:`CLIP` makes from a seed and traces, so that
both packages read the same file.

Tolerances: the scorer's embeddings within 1e-5 of their largest
magnitude (fp32, products summed in another order); the resblocks read
from the archive, the graft and the converters exact; ``clip_preprocess``
exact (the same nearest rows); the CLIP score within 1e-5.
"""

import types
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from mmvid_tpu.eval import evaluate as jeval
from mmvid_tpu.models import clip_full as jclip
from mmvid_tpu.models.clip import load_openai_clip_stack as jax_stack
from mmvid_tpu.models.mmvid import DEFAULT_MP_CONFIG
from mmvid_tpu.utils.torch_compat import load_torchjit_state_dict
from mmvid_tpu_torch import factories, weights
from mmvid_tpu_torch.config import process_args
from mmvid_tpu_torch.eval import evaluate as peval
from mmvid_tpu_torch.models import clip_full
from mmvid_tpu_torch.models.clip import load_openai_clip_stack
from mmvid_tpu_torch.utils.torch_compat import stack_params_to_torch

SMALL = clip_full.ClipConfig(
    embed_dim=32, image_resolution=32, vision_width=64, vision_layers=2,
    vision_patch_size=16, context_length=12, vocab_size=100,
    transformer_width=64, transformer_layers=2)
TOL = 1e-5


def make_archive(cfg, path, seed):
    """A torch.jit archive of the port's CLIP at ``cfg``, weights from
    ``seed``; returns the module."""
    model = clip_full.CLIP(cfg).eval()
    clip_full.init_random(model, torch.Generator().manual_seed(seed))
    img = torch.zeros(1, 3, cfg.image_resolution, cfg.image_resolution)
    txt = torch.zeros(1, cfg.context_length, dtype=torch.long)
    txt[0, -1] = cfg.vocab_size - 1
    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter('ignore', torch.jit.TracerWarning)
        traced = torch.jit.trace(model, (img, txt), check_trace=False)
    torch.jit.save(traced, str(path))
    return model


@pytest.fixture(scope='module')
def archive(tmp_path_factory):
    path = tmp_path_factory.mktemp('clip') / 'tiny-clip.pt'
    return str(path), make_archive(SMALL, path, 11)


def _tokens(b, seed):
    text = np.random.RandomState(seed).randint(1, 90, (b, 12))
    text[:, -1] = 99
    return text


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize('size', [20, 48])
def test_scorer_matches_jax(archive, size):
    """Text, and frames up-sampled (20 -> 32) and down-sampled (48 -> 32)
    by the nearest resize; the traced archive computes what the module
    computes."""
    path, module = archive
    jscorer = jclip.load_clip_scorer(path)
    pscorer = clip_full.load_clip_scorer(path, device='cpu')
    assert pscorer.cfg == clip_full.ClipConfig(**vars(jscorer.cfg))
    text = _tokens(3, size)
    frames = np.random.RandomState(size).uniform(
        0, 1, (3, size, size, 3)).astype(np.float32)
    _close(pscorer.encode_text(text).numpy(),
           np.asarray(jscorer.encode_text(jnp.asarray(text))), 'text')
    _close(pscorer.encode_image(frames).numpy(),
           np.asarray(jscorer.encode_image(jnp.asarray(frames))), 'image')
    x = clip_full.clip_preprocess(torch.from_numpy(frames), 32).permute(
        0, 3, 1, 2)
    with torch.no_grad():
        traced = torch.jit.load(path)(x, torch.from_numpy(text))[0]
        want = module(x, torch.from_numpy(text))[0]
    np.testing.assert_allclose(traced.numpy(), want.numpy(), rtol=0,
                               atol=TOL)


def test_clip_preprocess_matches_jax_not_torch_default():
    """JAX resizes 128 -> 224 with ``jax.image.resize('nearest')``: the
    port takes the same rows (``nearest-exact``'s); torch's default
    ``'nearest'``, which the reference used, takes other rows in 64 of
    224 (ROADMAP.md queue C)."""
    img = np.random.RandomState(0).uniform(0, 1, (1, 128, 128, 3)).astype(
        np.float32)
    want = np.asarray(jclip.clip_preprocess(jnp.asarray(img)))
    got = clip_full.clip_preprocess(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    t = torch.from_numpy(img).permute(0, 3, 1, 2)
    exact = F.interpolate(t, (224, 224), mode='nearest-exact')
    default = F.interpolate(t, (224, 224), mode='nearest')
    mean = torch.tensor(clip_full.CLIP_MEAN).view(1, 3, 1, 1)
    std = torch.tensor(clip_full.CLIP_STD).view(1, 3, 1, 1)
    np.testing.assert_allclose(((exact - mean) / std).permute(0, 2, 3, 1),
                               got, rtol=0, atol=1e-6)
    assert not torch.equal(exact, default)
    i = torch.arange(224, dtype=torch.float32)
    rows_exact = ((i + 0.5) * 128 / 224).floor()
    rows_default = (i * 128 / 224).floor()
    assert int((rows_exact != rows_default).sum()) == 64


@pytest.mark.parametrize('which,prefix', [
    ('openai_clip_visual', 'visual.transformer'),
    ('openai_clip_text', 'transformer')])
def test_load_openai_clip_stack_matches_jax(archive, which, prefix):
    path, _ = archive
    jcfg, jparams = jax_stack(path, which)
    cfg, sd = load_openai_clip_stack(path, which)
    assert (cfg.width, cfg.layers, cfg.heads) == (jcfg.width, jcfg.layers,
                                                  jcfg.heads) == (64, 2, 1)
    want = stack_params_to_torch(jparams, 'resblocks')
    assert sorted(sd) == sorted(want)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_clip_full_params_to_torch_roundtrip(archive):
    """JAX's converted params of the archive, carried back by
    ``weights.clip_full_params_to_torch``, are the archive's weights."""
    path, _ = archive
    sd = load_torchjit_state_dict(path)
    _, visual, text = jclip.convert_clip_full(sd)
    back = weights.clip_full_params_to_torch(visual, text)
    assert sorted(back) == sorted(k for k in sd if k != 'logit_scale')
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)


def _graft_argv(path, which='openai_clip_visual'):
    return ['--name', 't', '--image_text_folder', '.', '--dataset',
            'video_text', '--dim', '64', '--which_transformer', which,
            '--openai_clip_model_path', path, '--text_seq_len', '8',
            '--num_targets', '2', '--image_size', '32']


def test_graft_matches_jax(archive):
    """JAX's ``get_dalle`` and the port's ``get_driver_model`` build their
    backbones from the same archive: the same transformer weights."""
    from mmvid_tpu import factories as jfactories
    from mmvid_tpu.config import process_args as jax_args
    from mmvid_tpu.models.vqgan import VQGanConfig, VQGanVAE
    path, _ = archive
    vq = VQGanConfig(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                     z_channels=64, embed_dim=64, n_embed=1024,
                     attn_resolutions=())
    vae = VQGanVAE(image_size=32, cfg=vq, params=jax.jit(VQGanVAE(
        image_size=32, cfg=vq, params={}).init_params)(
            jax.random.PRNGKey(0)))
    jmodel = jfactories.get_dalle(jax_args(train=True,
                                           argv=_graft_argv(path)), vae)
    want = stack_params_to_torch(jmodel.params['transformer'], 'resblocks')
    model = factories.get_driver_model(process_args(
        train=True, argv=_graft_argv(path) + ['--device', 'cpu']), 'cpu')
    got = model.transformer['transformer'].state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_graft_reads_either_stack_and_warns_without_archive(archive,
                                                            tmp_path):
    path, module = archive
    model = factories.get_driver_model(process_args(
        train=True, argv=_graft_argv(path, 'openai_clip_text')
        + ['--device', 'cpu']), 'cpu')
    for k, v in model.transformer['transformer'].state_dict().items():
        assert torch.equal(v, module.state_dict()[f'transformer.{k}']), k
    missing = str(tmp_path / 'ViT-B-32.pt')
    with pytest.warns(UserWarning, match='RANDOMLY initialized'):
        cfg, sd = factories.load_pretrained_stack(process_args(
            train=True, argv=_graft_argv(missing)))
    assert sd is None and (cfg.width, cfg.layers, cfg.heads) == (768, 12, 12)


class _PortStub(torch.nn.Module):
    def __init__(self, fakes):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))
        self.fakes = list(fakes)

    def generate_images(self, generator, text, **kw):
        return torch.from_numpy(self.fakes.pop(0)), None


class _JaxStub:
    def __init__(self, fakes):
        self.fakes = list(fakes)

    def generate_images(self, key, text, **kw):
        return jnp.asarray(self.fakes.pop(0)), None


def test_evaluate_clip_matches_jax(archive, tmp_path):
    """Both packages' ``evaluate_clip`` on the same generated videos (the
    generation stubbed), each with its own scorer of the archive."""
    path, _ = archive
    rng = np.random.RandomState(3)
    names = ['a man talks', 'a woman smiles', 'a person nods']
    table = dict(zip(names, _tokens(3, 7)))
    samples = [{'text': rng.randint(1, 100, (3, 8)), 'description': names}
               for _ in range(2)]
    fakes = [rng.uniform(0, 1, (3, 2, 24, 24, 3)).astype(np.float32)
             for _ in range(2)]

    def args(d):
        return types.SimpleNamespace(
            log_metric_dir=str(tmp_path / d), seed=0, eval_num=6,
            batch_size=3, mask_predict_steps=[2], mp_config=DEFAULT_MP_CONFIG)

    def tokens(descriptions):
        return np.stack([table[d] for d in descriptions])

    js = jclip.load_clip_scorer(path)
    ps = clip_full.load_clip_scorer(path, device='cpu')
    want = jeval.evaluate_clip(
        args('jax'), _JaxStub(fakes), iter(samples),
        (lambda d: np.asarray(js.encode_text(jnp.asarray(tokens(d)))),
         js.encode_image), key=jax.random.PRNGKey(0))
    got = peval.evaluate_clip(
        args('port'), _PortStub(fakes), iter(samples),
        (lambda d: ps.encode_text(tokens(d)).numpy(), ps.encode_image))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for d in ('jax', 'port'):
        assert '+/-' in (tmp_path / d / 'clip_score.txt').read_text()
