"""The port's encode path (mmvid_tpu_torch.ops.codebook and the VQGAN
encode half of mmvid_tpu_torch.models.vqgan) vs the JAX package, fp32, on
the CPU, with JAX weights carried over through the port's own converter.

Tolerances: encoder latents 1e-4 (fp32 convolutions summed in another
order, flax's one-pass GroupNorm variance); code ids exactly equal on a
codebook with spread (randn).  The random-init codebook is
U(-1/1024, 1/1024), whose scores differ by about 1e-5 between codes, so a
change of summation order can flip a near-tie: there the chosen code's
score must be within 1e-5 of the best instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvid_tpu.models import bert as jbert
from mmvid_tpu.models.clip import ClipStackConfig as JaxClip
from mmvid_tpu.models.vqgan import VQGanConfig as JaxVQCfg
from mmvid_tpu.models.vqgan import VQGanVAE as JaxVAE
from mmvid_tpu.ops.codebook import (
    nearest_codebook_indices,
    nearest_codebook_indices_pallas,
)
from mmvid_tpu.utils import torch_compat as jax_compat
from mmvid_tpu_torch import factories
from mmvid_tpu_torch.models.vqgan import VQGanConfig, VQGanVAE
from mmvid_tpu_torch.ops import codebook as C
from mmvid_tpu_torch.utils import torch_compat as port_compat
from mmvid_tpu_torch.weights import load_jax_params, load_weights

TOL = 1e-4
VQ_TINY = dict(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1,
               z_channels=64, embed_dim=64, n_embed=1024,
               attn_resolutions=())
CONFIGS = {'tiny': VQ_TINY,
           'tiny_attn': dict(VQ_TINY, n_embed=128, attn_resolutions=(8,))}


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def spread_codebook(n, d, seed):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def jax_vae(kw, seed, spread=False):
    """A JAX VQGanVAE at 16 px with params from a jitted init; ``spread``
    swaps its codebook for a randn one."""
    vae = JaxVAE(image_size=16, cfg=JaxVQCfg(**kw), params={})
    params = jax.jit(vae.init_params)(jax.random.PRNGKey(seed))
    if spread:
        params = {**params, 'quantize': {'embedding': jnp.asarray(
            spread_codebook(kw['n_embed'], kw['embed_dim'], seed))}}
    vae.params = params
    return vae


def port_vae(jvae, kw):
    pvae = VQGanVAE(image_size=16, cfg=VQGanConfig(**kw))
    load_weights(pvae.model, port_compat.vqgan_params_to_torch(jvae.params))
    return pvae


def jax_tiny_visual(seed=0):
    """The JAX tiny flagship with one visual control and a cvae (the
    text+mask layout at the tiny size); the cvae's codebook has spread."""
    from mmvid_tpu.models.mmvid import MMVIDBert
    vae = jax_vae(VQ_TINY, seed)
    cvae = jax_vae(VQ_TINY, seed + 1, spread=True)
    cfg = jbert.BertConfig(dim=64, num_text_tokens=100, text_seq_len=8,
                           num_visuals=1, num_targets=2,
                           num_image_tokens=1024, image_fmap_size=8,
                           image_size=16, use_separate_visual_emb=True,
                           clip=JaxClip(width=64, layers=2, heads=2))
    params = jax.jit(jbert.BertCore(cfg).init)(
        jax.random.PRNGKey(seed + 2),
        jnp.zeros((1, cfg.text_seq_len), jnp.int32),
        jnp.zeros((1, cfg.visual_seq_len), jnp.int32),
        jnp.zeros((1, cfg.target_seq_len), jnp.int32))['params']
    return MMVIDBert(cfg, vae, cvae=cvae, params=params), vae, cvae


def port_tiny_visual(jmodel, jvae, jcvae):
    pmodel, _ = factories.flagship(tiny=True, device='cpu', seed=1,
                                   use_cvae=True)
    load_jax_params(pmodel, jmodel.params, jvae.params, jcvae.params)
    return pmodel


def _images(b, seed):
    return np.random.RandomState(seed).rand(b, 16, 16, 3).astype(np.float32)


@pytest.mark.parametrize('route', ['jnp', 'pallas_interpret'])
def test_nearest_code_plain_matches_jax(route):
    rng = np.random.RandomState(0)
    z = rng.randn(300, 64).astype(np.float32)
    cb = spread_codebook(1024, 64, 1)
    cb[7] = cb[3]     # an exact tie: the lowest index wins in both
    z[0] = cb[3]
    if route == 'jnp':
        want = nearest_codebook_indices(jnp.asarray(z), jnp.asarray(cb))
    else:
        import mmvid_tpu.ops.codebook as cbmod
        orig = cbmod.pl.pallas_call

        def patched(*args, **kw):
            kw['interpret'] = True
            return orig(*args, **kw)

        cbmod.pl.pallas_call = patched
        try:
            want = nearest_codebook_indices_pallas(
                jnp.asarray(z), jnp.asarray(cb), block_m=128)
        finally:
            cbmod.pl.pallas_call = orig
    got = C.nearest_codebook_reference(torch.from_numpy(z),
                                       torch.from_numpy(cb))
    assert got.dtype == torch.int64 and int(got[0]) == 3
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nearest_code_wrapper_takes_plain_on_cpu(monkeypatch):
    monkeypatch.setattr(C, 'launches', 0)
    z = torch.randn(2, 8, 8, 64)
    cb = torch.randn(1024, 64)
    got = C.nearest_codebook_indices(z, cb)
    assert got.shape == (2, 8, 8) and C.launches == 0
    assert torch.equal(got, C.nearest_codebook_reference(z, cb))


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_encoder_latents_match_jax(name):
    kw = CONFIGS[name]
    jvae = jax_vae(kw, seed=2)
    pvae = port_vae(jvae, kw)
    x = 2 * _images(3, seed=4) - 1
    want = jvae.module.apply({'params': jvae.params}, jnp.asarray(x),
                             method=lambda m, v: m.quant_conv(m.encoder(v)))
    with torch.no_grad():
        got = pvae.model.encode_latents(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == want.shape == (3, 8, 8, kw['embed_dim'])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_get_codebook_indices_match_jax(name):
    kw = CONFIGS[name]
    jvae = jax_vae(kw, seed=3, spread=True)
    pvae = port_vae(jvae, kw)
    img = _images(4, seed=5)
    want = np.asarray(jvae.get_codebook_indices(jnp.asarray(img)))
    got = pvae.get_codebook_indices(torch.from_numpy(img))
    assert got.shape == (4, 64) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_init_codebook_near_ties():
    """U(-1/n, 1/n) codebook: the port's and the JAX package's codes score
    within 1e-5 of the best (in float64 on the port's latents)."""
    jvae = jax_vae(VQ_TINY, seed=6)
    pvae = port_vae(jvae, VQ_TINY)
    img = _images(4, seed=7)
    want = np.asarray(jvae.get_codebook_indices(jnp.asarray(img)))
    got = pvae.get_codebook_indices(torch.from_numpy(img)).numpy()
    with torch.no_grad():
        z = pvae.model.encode_latents(
            torch.from_numpy(2 * img - 1).permute(0, 3, 1, 2))
    z = z.reshape(-1, z.shape[-1]).double()
    cb = pvae.model.quantize.embedding.weight.double()
    scores = z @ cb.t() - 0.5 * (cb * cb).sum(-1)[None]
    best = scores.max(-1).values
    for ids in (got, want):
        chosen = scores.gather(
            1, torch.tensor(ids, dtype=torch.long).reshape(-1, 1))[:, 0]
        assert (best - chosen).max().item() <= 1e-5


def test_encoder_state_dict_uses_taming_names():
    jvae = jax_vae(CONFIGS['tiny_attn'], seed=8)
    pvae = VQGanVAE(image_size=16, cfg=VQGanConfig(**CONFIGS['tiny_attn']))
    keys = set(pvae.model.state_dict())
    assert keys == set(jax_compat.vqgan_params_to_torch(jvae.params))
    for k in ('encoder.conv_in.weight', 'encoder.down.0.block.0.conv1.weight',
              'encoder.down.0.downsample.conv.weight',
              'encoder.down.1.block.0.nin_shortcut.weight',
              'encoder.down.1.attn.0.q.weight', 'encoder.mid.attn_1.k.bias',
              'encoder.norm_out.weight', 'encoder.conv_out.weight',
              'quant_conv.weight', 'quant_conv.bias'):
        assert k in keys, k


def test_port_converter_matches_jax_package():
    """mmvid_tpu_torch.utils.torch_compat gives the JAX package's
    converter's output, key for key and value for value, cvae included."""
    jmodel, jvae, jcvae = jax_tiny_visual(seed=9)
    want = jax_compat.bert_params_to_torch(jmodel.params, jvae.params,
                                           jcvae.params)
    got = port_compat.bert_params_to_torch(jmodel.params, jvae.params,
                                           jcvae.params)
    assert set(got) == set(want)
    assert any(k.startswith('cvae.model.encoder.') for k in got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_image_tokens_and_recon_match_jax():
    jmodel, jvae, jcvae = jax_tiny_visual(seed=10)
    pmodel = port_tiny_visual(jmodel, jvae, jcvae)
    frames = _images(6, seed=11).reshape(2, 3, 16, 16, 3)
    for which in ('vae', 'cvae'):
        want = np.asarray(jmodel.get_image_tokens(jnp.asarray(frames),
                                                  which_vae=which,
                                                  insert_sep=True))
        got = pmodel.get_image_tokens(torch.from_numpy(frames),
                                      which_vae=which, insert_sep=True)
        assert got.shape == (2, 3 * 65)
        if which == 'cvae':   # the cvae's codebook has spread
            np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jmodel.recon_images(jnp.asarray(frames), 'cvae'))
    got = pmodel.recon_images(torch.from_numpy(frames), 'cvae')
    assert got.shape == (2, 3, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
