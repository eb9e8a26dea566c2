"""Port's VQGAN decoder (mmvid_tpu_torch.models.vqgan) vs the JAX package:
ids [B, n] -> images [B, H, W, 3] in [0, 1], fp32, weights carried over
from JAX (the encode half is held in tests/test_torch_encode.py).
Tolerance 1e-4: fp32 convolutions summed in another order, and flax's
one-pass GroupNorm variance against torch's two-pass."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvid_tpu.models.vqgan import VQGanConfig as JaxVQCfg
from mmvid_tpu.models.vqgan import VQGanVAE as JaxVAE
from mmvid_tpu.utils.torch_compat import vqgan_params_to_torch
from mmvid_tpu_torch.models.vqgan import VQGanConfig, VQGanVAE
from mmvid_tpu_torch.weights import load_weights

TOL = 1e-4
# the tiny flagship VQGAN; with attention at res 8 the up path gets
# AttnBlocks too
CONFIGS = {
    'tiny': dict(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                 z_channels=64, embed_dim=64, n_embed=1024,
                 attn_resolutions=()),
    'tiny_attn': dict(resolution=16, ch=32, ch_mult=(1, 2),
                      num_res_blocks=1, z_channels=64, embed_dim=64,
                      n_embed=128, attn_resolutions=(8,)),
}


@pytest.fixture(autouse=True)
def _no_tf32():
    """fp32 results are compared: no TF32 in matmuls or convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_decode_matches_jax(name):
    kw = CONFIGS[name]
    jvae = JaxVAE(image_size=16, cfg=JaxVQCfg(**kw), params={})
    jvae.params = jax.jit(jvae.init_params)(jax.random.PRNGKey(2))
    pvae = VQGanVAE(image_size=16, cfg=VQGanConfig(**kw))
    load_weights(pvae.model, vqgan_params_to_torch(jvae.params))
    ids = np.random.RandomState(0).randint(
        0, kw['n_embed'], (3, pvae.image_seq_len)).astype(np.int32)
    want = np.asarray(jvae.decode(jnp.asarray(ids)))
    got = pvae.decode(torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (3, 16, 16, 3)
    assert got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_nearest_upsample_matches_jax_resize():
    x = np.random.RandomState(1).randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 14, 3),
                                       method='nearest'))
    got = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
        mode='nearest').permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_state_dict_uses_taming_names():
    pvae = VQGanVAE(image_size=16, cfg=VQGanConfig(**CONFIGS['tiny_attn']))
    keys = set(pvae.state_dict())
    for k in ('model.quantize.embedding.weight',
              'model.post_quant_conv.weight',
              'model.decoder.mid.attn_1.q.weight',
              'model.decoder.up.1.attn.0.proj_out.bias',
              'model.decoder.up.1.upsample.conv.weight',
              'model.decoder.up.0.block.0.nin_shortcut.weight',
              'model.decoder.norm_out.weight'):
        assert k in keys, k
