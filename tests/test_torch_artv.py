"""The port's ART-V (mmvid_tpu_torch.models.artv) against the JAX package's,
at the tiny config of tests/test_artv.py (dim 64, 2 layers, 2 heads, 6
text positions, one visual block, 2 frames: sequence 198, control prefix
71, vocabulary 2168), fp32 on the CPU, JAX weights carried over through
``weights.load_jax_params``.

Tolerances: the forward is fp32 with sums in another order (and flax's
one-pass LayerNorm variance), so 1e-4.  Greedy sampling (temperature
1e-6, a Gumbel-argmax that the logits decide) must give the same tokens,
token for token, on every decode path.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvid_tpu.models import artv as jartv
from mmvid_tpu.models.clip import ClipStackConfig as JaxClip
from mmvid_tpu.models.vqgan import VQGanConfig as JaxVQCfg
from mmvid_tpu.models.vqgan import VQGanVAE as JaxVAE
from mmvid_tpu.utils.torch_compat import convert_bert
from mmvid_tpu_torch import factories
from mmvid_tpu_torch.models import artv as partv
from mmvid_tpu_torch.ops import artv_decode as AD
from mmvid_tpu_torch.ops import codebook as C
from mmvid_tpu_torch.weights import load_jax_params
from test_torch_drivers import _one_thread  # noqa: F401 (module-wide)

JCFG = jartv.ArtvConfig(dim=64, num_text_tokens=50, text_seq_len=6,
                        num_visuals=1, num_targets=2, num_image_tokens=1024,
                        image_fmap_size=8, image_size=32,
                        clip=JaxClip(width=64, layers=2, heads=2))
PROPS = ('image_seq_len', 'visual_seq_len', 'target_seq_len',
         'effective_num_text_tokens', 'num_visual_tokens',
         'num_control_tokens', 'total_tokens', 'control_seq_len',
         'total_seq_len')


VQ_TINY = dict(resolution=32, ch=32, ch_mult=(1, 2, 2), num_res_blocks=1,
               z_channels=64, embed_dim=64, n_embed=1024,
               attn_resolutions=())


def jax_tiny_artv(seed=0):
    """(ArtvCore, params, VQGAN params) of the JAX package at the tiny
    size, from jitted inits (the eager ones take several seconds)."""
    core = jartv.ArtvCore(JCFG)
    k_core, k_vae = jax.random.split(jax.random.PRNGKey(seed))
    params = jax.jit(core.init)(
        k_core, jnp.zeros((1, JCFG.text_seq_len), jnp.int32),
        jnp.zeros((1, JCFG.visual_seq_len), jnp.int32),
        jnp.zeros((1, JCFG.target_seq_len), jnp.int32))['params']
    vae = JaxVAE(image_size=32, cfg=JaxVQCfg(**VQ_TINY), params={})
    return core, params, jax.jit(vae.init_params)(k_vae)


def port_tiny_artv(params, vae_params, use_cvae=False):
    model, _ = factories.artv_tiny(device='cpu', seed=1,
                                   use_cvae=use_cvae)
    load_jax_params(model, params, vae_params,
                    vae_params if use_cvae else None)
    return model


@pytest.fixture(scope='module')
def pair():
    core, params, vae_params = jax_tiny_artv()
    return core, params, vae_params, port_tiny_artv(params, vae_params)


def _inputs(b=2, seed=43):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, 50, (b, JCFG.text_seq_len)).astype(np.int32)
    text[:, 4:] = 0                                   # padding positions
    visual = rng.randint(0, 1024, (b, JCFG.visual_seq_len)).astype(np.int32)
    visual[:, :8] = -1                                # absent positions
    return text, visual


def test_config_and_block_mask_match_jax():
    full = jartv.ArtvConfig(dim=768, num_text_tokens=49408, text_seq_len=50,
                            num_visuals=1, num_targets=8,
                            clip=JaxClip(width=768, layers=12, heads=12))
    tiny, _ = factories.artv_tiny(device='cpu')
    for jcfg, pcfg in ((JCFG, tiny.cfg),
                       (full, partv.ArtvConfig(dim=768, num_text_tokens=49408,
                                               text_seq_len=50,
                                               num_visuals=1,
                                               num_targets=8))):
        for prop in PROPS:
            assert getattr(pcfg, prop) == getattr(jcfg, prop), prop
        np.testing.assert_array_equal(partv.logits_block_mask(pcfg),
                                      jartv.logits_block_mask(jcfg))
    assert (tiny.cfg.total_seq_len, tiny.cfg.control_seq_len + 1,
            tiny.cfg.total_tokens) == (198, 71, 2168)


def test_forward_logits_match_jax(pair):
    core, params, _, pmodel = pair
    text, visual = _inputs(seed=33)
    image = np.random.RandomState(34).randint(
        0, 1024, (2, JCFG.target_seq_len)).astype(np.int32)
    want = np.asarray(core.apply({'params': params}, jnp.asarray(text),
                                 jnp.asarray(visual), jnp.asarray(image)))
    with torch.no_grad():
        got = pmodel.core(torch.from_numpy(text).long(),
                          torch.from_numpy(visual).long(),
                          torch.from_numpy(image).long())
    assert got.shape == want.shape == (2, 198, 2168)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('env', [{}, {'MMVID_ARTV_WINDOW': '0'},
                                 {'MMVID_ARTV_FUSED': '1'}],
                         ids=['default', 'window_off', 'fused'])
def test_ar_sample_greedy_matches_jax(pair, monkeypatch, env):
    """Both packages read the flags at call time; with MMVID_ARTV_FUSED=1
    the JAX package runs its Pallas kernel in interpret mode and the port
    its plain decode step (the wrapper on a CPU tensor)."""
    core, params, _, pmodel = pair
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    text, visual = _inputs()
    want = np.asarray(jartv.ar_sample(core, params, jnp.asarray(text),
                                      jnp.asarray(visual),
                                      jax.random.PRNGKey(1),
                                      temperature=1e-6))
    monkeypatch.setattr(AD, 'launches', 0)
    got = partv.ar_sample(pmodel.core, torch.from_numpy(text).long(),
                          torch.from_numpy(visual).long(),
                          torch.Generator().manual_seed(1),
                          temperature=1e-6)
    assert AD.launches == 0                      # CPU: the plain step
    assert got.shape == (2, JCFG.target_seq_len) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('weights_only', [False, True],
                         ids=['int8_caches', 'MMVID_ARTV_INT8_WEIGHTS_ONLY'])
def test_ar_sample_int8_greedy_matches_jax(pair, monkeypatch, weights_only):
    """ar_sample(int8=True): int8 weights and head (dot8), and int8 K/V
    caches unless MMVID_ARTV_INT8_WEIGHTS_ONLY=1, token for token with
    JAX's; no decode kernel runs (JAX: fused = not int8), even with
    MMVID_ARTV_FUSED=1; and the tokens are not the unquantized ones."""
    core, params, _, pmodel = pair
    if weights_only:
        monkeypatch.setenv('MMVID_ARTV_INT8_WEIGHTS_ONLY', '1')
    monkeypatch.setenv('MMVID_ARTV_FUSED', '1')
    text, visual = _inputs()
    want = np.asarray(jartv.ar_sample(core, params, jnp.asarray(text),
                                      jnp.asarray(visual),
                                      jax.random.PRNGKey(1),
                                      temperature=1e-6, int8=True))
    monkeypatch.setattr(AD, 'launches', 0)
    args = (pmodel.core, torch.from_numpy(text).long(),
            torch.from_numpy(visual).long())
    got = partv.ar_sample(*args, torch.Generator().manual_seed(1),
                          temperature=1e-6, int8=True)
    assert AD.launches == 0
    np.testing.assert_array_equal(got.numpy(), want)
    base = partv.ar_sample(*args, torch.Generator().manual_seed(1),
                           temperature=1e-6)
    assert (base != got).any()


@pytest.mark.parametrize('flag,device,want', [
    (None, 'cuda', True), (None, 'cpu', False), ('1', 'cuda', True),
    ('1', 'cpu', True), ('0', 'cuda', False), ('0', 'cpu', False)])
def test_fused_decode_rule(monkeypatch, flag, device, want):
    """The decode path by device: unset, the stacked step (kernel B5) for
    CUDA tensors and the per-layer step (the JAX-parity path) on the CPU;
    MMVID_ARTV_FUSED=1 or =0 chooses either on any device.  The rule
    reads a torch.device, so it needs no card."""
    if flag is None:
        monkeypatch.delenv('MMVID_ARTV_FUSED', raising=False)
    else:
        monkeypatch.setenv('MMVID_ARTV_FUSED', flag)
    assert partv.fused_decode(torch.device(device)) is want


def test_fused_decode_rejects_other_flags(monkeypatch):
    monkeypatch.setenv('MMVID_ARTV_FUSED', 'yes')
    with pytest.raises(ValueError, match='MMVID_ARTV_FUSED'):
        partv.fused_decode(torch.device('cpu'))


@pytest.mark.parametrize('filter_thres,k', [(0.5, 1024), (0.95, 108)])
def test_sample_tok_matches_filtered_softmax(filter_thres, k):
    """k_img = min(int((1 - filter_thres) * 2168), 1024): the filter is off
    at 0.5 and keeps 108 columns at 0.95.  Draws from one logits row: no
    token outside the top k, and the histogram within TV 0.04 of the exact
    filtered softmax at temperature 0.7 (expected TV of a correct sampler
    over 100000 draws 0.013 with the filter off and 0.008 at k 108; a
    sampler that ignores the temperature is 0.33 and 0.27 away, one that
    ignores the filter draws outside the top k)."""
    cfg = factories.artv_tiny(device='cpu')[0].cfg
    k_img = min(max(int((1 - filter_thres) * cfg.total_tokens), 1),
                cfg.num_image_tokens)
    assert k_img == k
    logits = torch.from_numpy(
        np.random.RandomState(5).randn(1, 1024).astype(np.float32) * 2.0)
    temp, n, reps = 0.7, 20000, 5
    gen = torch.Generator().manual_seed(0)
    counts = torch.zeros(1024)
    for _ in range(reps):
        tok = partv.sample_tok(gen, logits.expand(n, 1024), k_img, temp)
        counts += torch.bincount(tok, minlength=1024).float()
    top = torch.topk(logits[0], k_img).indices
    keep = torch.zeros(1024, dtype=torch.bool)
    keep[top] = True
    want = torch.softmax(logits[0].masked_fill(~keep, float('-inf'))
                         / temp, -1)
    assert counts[~keep].sum() == 0
    tv = 0.5 * (counts / (n * reps) - want).abs().sum().item()
    assert tv < 0.04, tv


def test_generate_images_with_cvae_and_frames(pair):
    """Visual control frames go through the cvae (and the nearest-code
    path); mask-predict keywords are taken and ignored."""
    _, params, vae_params, _ = pair
    model = port_tiny_artv(params, vae_params, use_cvae=True)
    frames = torch.from_numpy(
        np.random.RandomState(2).rand(2, 1, 32, 32, 3).astype(np.float32))
    text = torch.from_numpy(_inputs()[0]).long()
    before = C.launches
    videos, seq = model.generate_images(
        torch.Generator().manual_seed(0), text, visual=frames,
        temperature=1e-6, mask_predict_steps=4, dynamic=False,
        mp_config=None)
    assert C.launches == before
    assert videos.shape == (2, 2, 32, 32, 3)
    assert torch.isfinite(videos).all() and 0 <= videos.min()
    assert videos.max() <= 1
    assert seq.shape == (2, 128) and 0 <= seq.min() and seq.max() < 1024
    vtok = model.get_image_tokens(frames, which_vae='cvae')
    assert vtok.shape == (2, 64)
    _, seq_ids = model.generate_images(torch.Generator().manual_seed(0),
                                       text, visual=vtok, temperature=1e-6,
                                       decode=False)
    assert torch.equal(seq_ids, seq)
    recon = model.recon_images(frames, which_vae='cvae')
    assert recon.shape == (2, 1, 32, 32, 3)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_weights_round_trip_through_jax_converter(pair):
    """JAX params -> port -> state_dict() -> the JAX package's
    convert_bert gives the same params back; the port adds only the
    reference's unused special_emb and estimation_pos_emb."""
    _, params, vae_params, pmodel = pair
    sd = {k: v.numpy() for k, v in pmodel.state_dict().items()}
    back = convert_bert(sd)
    for path, v in _flat(vae_params):
        node = back['_vae']
        for k in path:
            node = node[k]
        np.testing.assert_array_equal(np.asarray(node), v)
    back = back['params']
    assert set(back) - set(params) == {'special_emb', 'estimation_pos_emb'}
    for path, v in _flat(params):
        node = back
        for k in path:
            node = node[k]
        np.testing.assert_array_equal(np.asarray(node), v,
                                      err_msg='/'.join(path))
    with pytest.raises(KeyError, match='to_logits.1.bias'):
        from mmvid_tpu_torch.weights import load_weights
        load_weights(pmodel, {k: v for k, v in sd.items()
                              if k != 'to_logits.1.bias'})
