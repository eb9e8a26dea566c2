"""The port's attention backward (ops/attention.py's FusedAttention), negvc's
negative control and ART-V's loss and step against the JAX package's, on
the CPU, fp32, JAX weights carried over through ``weights.
load_jax_params``: the rest of tests/test_torch_training.py's parity
checks, with its tolerances and helpers.  The attention backward is held
to ``jax.grad`` through the Pallas kernel in interpret mode within 1e-5;
ART-V at tests/test_artv.py's tiny size (dim 64, 2 layers, 6 text
positions, one visual block, 2 frames at 32 px).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvid_tpu import training as jtrain
from mmvid_tpu.models import artv as jartv
from mmvid_tpu.models import bert as jbert
from mmvid_tpu.models.clip import ClipStackConfig as JaxClip
from mmvid_tpu.models.clip import build_attention_mask as jax_mask
from mmvid_tpu.models.vqgan import VQGanConfig as JaxVQCfg
from mmvid_tpu.models.vqgan import VQGanVAE as JaxVAE
from mmvid_tpu.ops.attention import fused_attention_blhd as jax_attention
from mmvid_tpu_torch import factories, training, weights
from mmvid_tpu_torch.models import artv as partv
from mmvid_tpu_torch.models import bert as pbert
from mmvid_tpu_torch.models.clip import (
    ClipStackConfig,
    MultiHeadAttention,
    build_attention_mask,
)
from mmvid_tpu_torch.ops import attention as A
from mmvid_tpu_torch.utils.torch_compat import bert_params_to_torch
from test_torch_training import (
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_TOL,
    _close,
    _hold_params,
    _port_tc,
    _spread,
)


# -- the attention backward (B1-bwd) ---------------------------------------

def _attn_inputs(b, l, h, d, seed):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(b, l, 3 * h * d).astype(np.float32)
    cot = rng.randn(b, l, h, d).astype(np.float32)
    return qkv, cot


@pytest.mark.parametrize('kind', ['mask_prev', 'causal'])
def test_attention_backward_matches_jax_on_packed_views(kind):
    """The Function's dq, dk, dv, on q, k, v as strided views of one packed
    projection (models/clip.py's layout), against jax.grad through the
    Pallas kernel in interpret mode and its custom_vjp."""
    b, l, h, d = 2, 29, 2, 32
    qkv, cot = _attn_inputs(b, l, h, d, 1 if kind == 'causal' else 2)
    mask = np.array(jax_mask(l, kind, index=(9, 10)))

    def jax_loss(qkv_):
        q, k, v = (qkv_[..., i * h * d:(i + 1) * h * d].reshape(b, l, h, d)
                   for i in range(3))
        out = jax_attention(q, k, v, jnp.asarray(mask), interpret=True)
        return jnp.sum(out * cot)

    want = np.asarray(jax.jit(jax.grad(jax_loss))(jnp.asarray(qkv)))
    x = torch.from_numpy(qkv).requires_grad_(True)
    q, k, v = (x[..., i * h * d:(i + 1) * h * d].view(b, l, h, d)
               for i in range(3))
    out = A.fused_attention_blhd(q, k, v, torch.from_numpy(mask))
    (out * torch.from_numpy(cot)).sum().backward()
    _close(x.grad, want, 0, 1e-5, 'd qkv')


def test_attention_backward_is_the_reference_vjp():
    """attention_backward equals autograd through attention_reference (its
    forward's plain version), and the Function saves q, k, v and the mask
    only: no [B, H, L, L] tensor outlives the forward."""
    b, l, h, d = 2, 17, 2, 32
    qkv, cot = _attn_inputs(b, l, h, d, 3)
    mask = build_attention_mask(l, 'mask_prev', index=(5, 6))
    x = torch.from_numpy(qkv).requires_grad_(True)
    q, k, v = (x[..., i * h * d:(i + 1) * h * d].view(b, l, h, d)
               for i in range(3))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        out = A.fused_attention_blhd(q, k, v, mask)
    assert sorted(saved) == sorted([(b, l, h, d)] * 3 + [(l, l)])
    (out * torch.from_numpy(cot)).sum().backward()
    y = torch.from_numpy(qkv).requires_grad_(True)
    q2, k2, v2 = (y[..., i * h * d:(i + 1) * h * d].view(b, l, h, d)
                  for i in range(3))
    ref = A.attention_reference(q2, k2, v2, mask, d ** -0.5)
    (ref * torch.from_numpy(cot)).sum().backward()
    _close(x.grad, y.grad, 0, 1e-6, 'd qkv')


def test_attention_grads_reach_in_proj_weight():
    """MultiHeadAttention's packed in_proj gets the gradients of the plain
    autograd path through the strided q, k, v views."""
    torch.manual_seed(0)
    mha = MultiHeadAttention(64, 2)
    x = torch.randn(2, 11, 64)
    mask = build_attention_mask(11, 'causal')
    mha(x, mask).square().sum().backward()
    got = mha.in_proj_weight.grad.clone(), mha.out_proj.weight.grad.clone()
    mha.zero_grad()
    qkv = torch.nn.functional.linear(x, mha.in_proj_weight,
                                     mha.in_proj_bias)
    q, k, v = (qkv[..., i * 64:(i + 1) * 64].view(2, 11, 2, 32)
               for i in range(3))
    out = A.attention_reference(q, k, v, mask, 32 ** -0.5).reshape(2, 11, 64)
    mha.out_proj(out).square().sum().backward()
    _close(got[0], mha.in_proj_weight.grad, 0, 1e-5, 'in_proj_weight')
    _close(got[1], mha.out_proj.weight.grad, 0, 1e-5, 'out_proj')


@pytest.mark.parametrize('flag', ['MMVID_ATTN_BF16', 'MMVID_ATTN_INT8'])
def test_quantized_attention_refuses_grad(monkeypatch, flag):
    monkeypatch.setenv(flag, '1')
    q, k, v = (torch.randn(1, 5, 2, 32, requires_grad=True)
               for _ in range(3))
    with pytest.raises(RuntimeError, match='serving only'):
        A.fused_attention_blhd(q, k, v)
    with torch.no_grad():
        assert A.fused_attention_blhd(q, k, v).shape == (1, 5, 2, 32)


def test_negvc_control_drops_the_visual_segment():
    """negvc's negative control, [REL] | text | [ST1][VID] without the
    visual segment, and the REL logit of its shorter sequence (the
    full-layout mask sliced [:L, :L], as the reference does), against
    JAX's on a model with a control frame."""
    jcfg = jbert.BertConfig(dim=64, num_text_tokens=100, text_seq_len=8,
                            num_visuals=1, num_targets=2,
                            num_image_tokens=1024, image_fmap_size=8,
                            image_size=16, use_separate_visual_emb=True,
                            clip=JaxClip(width=64, layers=2, heads=2))
    core = jbert.BertCore(jcfg)
    params = jax.jit(core.init)(
        jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32),
        jnp.zeros((1, 64), jnp.int32), jnp.zeros((1, 128), jnp.int32))[
            'params']
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(pbert.BertConfig) if f.name != 'clip'}
    pcore = pbert.BertCore(pbert.BertConfig(
        clip=ClipStackConfig(64, 2, 2), **kw))
    pcore.load_state_dict({k: torch.from_numpy(v) for k, v in
                           bert_params_to_torch(jax.tree_util.tree_map(
                               np.array, params)).items()})
    rng = np.random.RandomState(8)
    text_neg = rng.randint(0, 100, (2, 8)).astype(np.int32)
    tgt = rng.randint(0, 1025, (2, 128)).astype(np.int32)

    def jax_rel(p):
        apply = lambda m, *a, **k: core.apply({'params': p}, *a, method=m,
                                              **k)
        ctrl = apply(jbert.BertCore.control_embedding, jnp.asarray(text_neg),
                     None, drop_visual=True)
        emb = apply(jbert.BertCore.target_embedding, jnp.asarray(tgt))
        return ctrl, apply(jbert.BertCore.forward_rel_logit, ctrl, emb)

    want_ctrl, want = jax.jit(jax_rel)(params)
    with torch.no_grad():
        ctrl = pcore.control_embedding(torch.from_numpy(text_neg).long(),
                                       None, drop_visual=True)
        got = pcore.forward_rel_logit(ctrl, pcore.target_embedding(
            torch.from_numpy(tgt).long()))
    assert ctrl.shape[1] == jcfg.control_seq_len - jcfg.visual_seq_len
    _close(ctrl, want_ctrl, 0, 0, 'control')
    _close(got, want, 0, 1e-4, 'rel logit')


@pytest.fixture(scope='module')
def artv():
    jcfg = jartv.ArtvConfig(dim=64, num_text_tokens=50, text_seq_len=6,
                            num_visuals=1, num_targets=2,
                            num_image_tokens=1024, image_fmap_size=8,
                            image_size=32,
                            clip=JaxClip(width=64, layers=2, heads=2))
    core = jartv.ArtvCore(jcfg)
    k_core, k_vae = jax.random.split(jax.random.PRNGKey(0))
    params = jax.jit(core.init)(
        k_core, jnp.zeros((1, jcfg.text_seq_len), jnp.int32),
        jnp.zeros((1, jcfg.visual_seq_len), jnp.int32),
        jnp.zeros((1, jcfg.target_seq_len), jnp.int32))['params']
    vq = JaxVQCfg(resolution=32, ch=32, ch_mult=(1, 2, 2), num_res_blocks=1,
                  z_channels=64, embed_dim=64, n_embed=1024,
                  attn_resolutions=())
    vae_params = _spread(jax.jit(JaxVAE(image_size=32, cfg=vq,
                                        params={}).init_params)(k_vae), 2)
    jmodel = jartv.ArtvModel(jcfg, JaxVAE(image_size=32, cfg=vq,
                                          params=vae_params), params=params)
    pmodel, _ = factories.artv_train(tiny=True, dtype=torch.float32,
                                     device='cpu', seed=1)
    weights.load_jax_params(pmodel, params, vae_params)
    return jmodel, pmodel


def _artv_inputs(b=2, seed=43):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, 50, (b, 6)).astype(np.int32)
    text[:, 4:] = 0
    visual = rng.randint(0, 1024, (b, 64)).astype(np.int32)
    visual[:, :8] = -1
    image = rng.randint(0, 1024, (b, 128)).astype(np.int32)
    return text, visual, image


def test_artv_loss_and_gradients_match_jax(artv):
    jmodel, pmodel = artv
    text, visual, image = _artv_inputs()
    loss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jartv.artv_loss(jmodel.core, p, jnp.asarray(text),
                                  jnp.asarray(visual),
                                  jnp.asarray(image))[0]))(jmodel.params)
    t = lambda a: torch.from_numpy(a).long()
    params = training.trainable_parameters(pmodel)
    got, z1, z2 = partv.artv_loss(pmodel.core, t(text), t(visual), t(image))
    assert float(z1) == 0 and float(z2) == 0
    _close(got.detach(), loss, 0, LOSS_TOL, 'loss')
    grads = torch.autograd.grad(got, list(params.values()))
    want_g = bert_params_to_torch(jax.tree_util.tree_map(np.asarray,
                                                         jgrads))
    assert sorted(want_g) == sorted(params)
    for (name, _), g in zip(params.items(), grads):
        _close(g, want_g[name], GRAD_RTOL, GRAD_ATOL, name)


def test_artv_step_matches_jax(artv):
    """One ART-V step (beta_msm 1, as JAX's config forces in AR mode) from
    the same weights: parameters within 1e-5."""
    jmodel, pmodel = artv
    tc = jtrain.TrainConfig(beta_msm=1.0, lr_scheduler='none',
                            learning_rate=1e-3, dropout_vc=0.0)
    text, visual, image = _artv_inputs(seed=7)
    jbatch = {'text': jnp.asarray(text), 'visual': jnp.asarray(visual),
              'target': jnp.asarray(image)}
    jstate, jm = jax.jit(jtrain.make_train_step(jmodel, tc))(
        jtrain.create_train_state(jmodel, tc), jbatch, jax.random.PRNGKey(0))
    snapshot = {k: v.clone() for k, v in pmodel.state_dict().items()}
    try:
        state = training.create_train_state(pmodel, _port_tc(tc))
        t = lambda a: torch.from_numpy(a).long()
        state, pm = training.make_train_step(pmodel, _port_tc(tc))(
            state, {'text': t(text), 'visual': t(visual),
                    'target': t(image)}, None)
        _close(pm['loss'], jm['loss'], 0, LOSS_TOL, 'loss')
        _hold_params(state.params, jstate.params, 64, tc.learning_rate)
    finally:
        pmodel.load_state_dict(snapshot)
