"""Port's backbone and BERT (mmvid_tpu_torch.models.clip / bert) vs the JAX
package, at the tiny flagship config (dim 64, 2 layers, 2 heads, L=139),
fp32, JAX weights carried over through ``weights.load_jax_params``.

Tolerances: embeddings are table lookups and sums, so exact; the stack and
heads are fp32 with sums in another order (and flax's one-pass LayerNorm
variance), so 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvid_tpu.models import bert as jbert
from mmvid_tpu.models.clip import TransformerStack as JaxStack
from mmvid_tpu.models.clip import build_attention_mask as jax_mask
from mmvid_tpu.utils.torch_compat import bert_params_to_torch
from mmvid_tpu_torch import factories
from mmvid_tpu_torch.models import bert as pbert
from mmvid_tpu_torch.models.clip import ClipStackConfig, build_attention_mask
from mmvid_tpu_torch.weights import load_jax_params, load_weights

TOL = 1e-4


def port_config(jcfg):
    """The port's BertConfig with the JAX config's values."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(pbert.BertConfig) if f.name != 'clip'}
    clip = ClipStackConfig(jcfg.clip.width, jcfg.clip.layers,
                           jcfg.clip.heads)
    return pbert.BertConfig(clip=clip, **kw)


def jax_tiny(seed=0):
    """The JAX package's tiny flagship model and VQGAN: the configs of
    ``__graft_entry__._flagship(tiny=True)`` with params from a jitted init
    (its eager init takes about 25 s on the CPU)."""
    from mmvid_tpu.models.mmvid import MMVIDBert
    from mmvid_tpu.models.vqgan import VQGanConfig, VQGanVAE
    from mmvid_tpu.models.clip import ClipStackConfig as JaxClip
    vq_cfg = VQGanConfig(resolution=16, ch=32, ch_mult=(1, 2),
                         num_res_blocks=1, z_channels=64, embed_dim=64,
                         n_embed=1024, attn_resolutions=())
    k_vae, k_bert = jax.random.split(jax.random.PRNGKey(seed))
    vae = VQGanVAE(image_size=16, cfg=vq_cfg,
                   params=jax.jit(VQGanVAE(image_size=16, cfg=vq_cfg,
                                           params={}).init_params)(k_vae))
    cfg = jbert.BertConfig(dim=64, num_text_tokens=100, text_seq_len=8,
                           num_visuals=0, num_targets=2,
                           num_image_tokens=1024, image_fmap_size=8,
                           image_size=16, clip=JaxClip(width=64, layers=2,
                                                       heads=2))
    core = jbert.BertCore(cfg)
    params = jax.jit(core.init)(
        k_bert, jnp.zeros((1, cfg.text_seq_len), jnp.int32), None,
        jnp.zeros((1, cfg.target_seq_len), jnp.int32))['params']
    return MMVIDBert(cfg, vae, params=params), vae


def port_tiny(jmodel, jvae):
    """The port's tiny flagship carrying the JAX weights."""
    pmodel, _ = factories.flagship(tiny=True, device='cpu', seed=1)
    load_jax_params(pmodel, jmodel.params, jvae.params)
    return pmodel


@pytest.fixture(scope='module')
def pair():
    jmodel, jvae = jax_tiny()
    return jmodel, port_tiny(jmodel, jvae)


def _inputs(cfg, seed=0, b=2):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, cfg.num_text_tokens, (b, cfg.text_seq_len))
    text[:, cfg.text_seq_len // 2:] = 0        # padding, remapped per slot
    target = rng.randint(0, cfg.num_image_tokens + 1,
                         (b, cfg.target_seq_len))   # includes [MASK]
    return text.astype(np.int32), target.astype(np.int32)


def _apply(jmodel, method, *args):
    return jmodel.core.apply({'params': jmodel.params}, *args, method=method)


def test_config_properties_match(pair):
    jmodel, pmodel = pair
    jcfg, pcfg = jmodel.cfg, pmodel.cfg
    for name in ('effective_text_seq_len', 'effective_num_text_tokens',
                 'image_seq_len', 'visual_seq_len', 'target_seq_len',
                 'control_seq_len', 'total_seq_len', 'rel_tok_index',
                 'st1_tok_index', 'vid_tok_index', 'txt_tok_index',
                 'mask_token', 'sep_token'):
        assert getattr(pcfg, name) == getattr(jcfg, name), name
    assert pcfg.total_seq_len == 139


def test_transformer_stack(pair):
    jmodel, pmodel = pair
    cfg = jmodel.cfg
    rng = np.random.RandomState(3)
    x = rng.randn(2, cfg.total_seq_len, cfg.dim).astype(np.float32)
    idx = (cfg.st1_tok_index, cfg.vid_tok_index)
    want = JaxStack(cfg.clip).apply(
        {'params': jmodel.params['transformer']}, jnp.asarray(x),
        jax_mask(cfg.total_seq_len, 'mask_prev', index=idx))
    with torch.no_grad():
        got = pmodel.transformer['transformer'](
            torch.from_numpy(x),
            build_attention_mask(cfg.total_seq_len, 'mask_prev', index=idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_embeddings(pair):
    jmodel, pmodel = pair
    text, target = _inputs(jmodel.cfg)
    want_c = _apply(jmodel, jbert.BertCore.control_embedding,
                    jnp.asarray(text), None)
    want_t = _apply(jmodel, jbert.BertCore.target_embedding,
                    jnp.asarray(target))
    got_c = pmodel.core.control_embedding(torch.from_numpy(text))
    got_t = pmodel.core.target_embedding(torch.from_numpy(target))
    np.testing.assert_array_equal(got_c.detach().numpy(),
                                  np.asarray(want_c))
    np.testing.assert_array_equal(got_t.detach().numpy(),
                                  np.asarray(want_t))


def test_forward_full_and_hidden(pair):
    jmodel, pmodel = pair
    text, target = _inputs(jmodel.cfg, seed=1)
    ctrl = _apply(jmodel, jbert.BertCore.control_embedding,
                  jnp.asarray(text), None)
    tgt = _apply(jmodel, jbert.BertCore.target_embedding,
                 jnp.asarray(target))
    want_full = _apply(jmodel, jbert.BertCore.forward_full, ctrl, tgt)
    want_hidden = _apply(jmodel, jbert.BertCore.forward_hidden, ctrl, tgt)
    with torch.no_grad():
        pc = torch.from_numpy(np.array(ctrl))
        pt = torch.from_numpy(np.array(tgt))
        got_full = pmodel.core.forward_full(pc, pt)
        got_hidden = pmodel.core.forward_hidden(pc, pt)
    for got, want in zip(list(got_full) + list(got_hidden),
                         list(want_full) + list(want_hidden)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


def _core_pair(jcfg, seed):
    """A fresh JAX BertCore (params from a key) and the port's BertCore
    with those weights."""
    core = jbert.BertCore(jcfg)
    vis = (jnp.zeros((1, jcfg.visual_seq_len), jnp.int32)
           if jcfg.num_visuals else None)
    params = jax.jit(core.init)(jax.random.PRNGKey(seed),
                       jnp.zeros((1, jcfg.text_seq_len), jnp.int32), vis,
                       jnp.zeros((1, jcfg.target_seq_len), jnp.int32)
                       )['params']
    pcore = pbert.BertCore(port_config(jcfg))
    load_weights(pcore, bert_params_to_torch(params))
    return core, params, pcore


def test_stable_divide_max(pair):
    jmodel, _ = pair
    jcfg = dataclasses.replace(jmodel.cfg, stable=True)
    core, params, pcore = _core_pair(jcfg, seed=4)
    rng = np.random.RandomState(4)
    x = rng.randn(2, jcfg.total_seq_len, jcfg.dim).astype(np.float32)
    want = core.apply({'params': params}, jnp.asarray(x),
                      method=jbert.BertCore.transformer_forward)
    with torch.no_grad():
        got = pcore.transformer_forward(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_control_embedding_with_visual_tokens(pair):
    """num_visuals > 0: the visual segment and its per-frame axial
    embedding (AxialPositionalEmbeddingList) match too."""
    jmodel, _ = pair
    jcfg = dataclasses.replace(jmodel.cfg, num_visuals=2)
    core, params, pcore = _core_pair(jcfg, seed=5)
    text, _ = _inputs(jcfg, seed=5)
    vis = np.random.RandomState(6).randint(
        0, jcfg.num_image_tokens + 2, (2, jcfg.visual_seq_len)).astype(
        np.int32)
    want = core.apply({'params': params}, jnp.asarray(text),
                      jnp.asarray(vis),
                      method=jbert.BertCore.control_embedding)
    got = pcore.control_embedding(torch.from_numpy(text),
                                  torch.from_numpy(vis))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
