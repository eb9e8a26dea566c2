"""The port's int8 serving path (mmvid_tpu_torch.ops.int8, the w8a8 sites
of models/clip.py and models/vqgan.py, ``generate --int8``) against the
JAX package's (mmvid_tpu.ops.int8), at the tiny flagship config with JAX
weights carried over, fp32 on the CPU.  Inputs come from numpy at fixed
seeds.

Tolerances, each with its reason:
* the quantized integers and the int32 accumulations of ``quantized_dense``
  and ``quantized_conv`` are compared bitwise; their outputs within 1e-6
  relative (one fp32 product and sum);
* ``calib_stats`` within 1e-6 of ``jnp.quantile`` (the same fp32 index
  arithmetic; the final weighted sum may be fused differently);
* calibrated scales within one step of their 4-decimal rounding (1e-4): the
  recorded activations differ from JAX's in the last fp32 bits (sums in
  another order), which can carry a value across a rounding boundary;
* with the JAX scales carried over, backbone logits within 2e-3 (a last-bit
  difference of an activation can flip one int8 rounding, which moves a
  product by one quantization step), and generated tokens equal under the
  deterministic sampler hook, with ``MMVID_ATTN_INT8=1`` in both (the JAX
  package's kernel in interpret mode); the decoder site by site, and
  whole (test_decoder_sites_with_jax_scales_match_jax says why).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvid_tpu.models import mmvid as jmmvid
from mmvid_tpu.models.vqgan import VQGanConfig as JaxVQCfg
from mmvid_tpu.models.vqgan import VQGanVAE as JaxVAE
from mmvid_tpu.ops import int8 as jint8
from mmvid_tpu.utils.torch_compat import vqgan_params_to_torch
from mmvid_tpu_torch.models import mmvid as pmmvid
from mmvid_tpu_torch.models.clip import ClipStackConfig, TransformerStack
from mmvid_tpu_torch.models.vqgan import SiteConv, VQGanConfig, VQGanVAE
from mmvid_tpu_torch.ops import attention as A
from mmvid_tpu_torch.ops import attention_int8 as A8
from mmvid_tpu_torch.ops import int8 as pint8
from mmvid_tpu_torch.weights import int8_scales_from_jax, load_weights
from test_torch_clip_bert import jax_tiny, port_tiny
from test_torch_drivers import _one_thread  # noqa: F401 (module-wide)

SCALE_STEP = 1e-4 + 1e-9


@pytest.fixture(scope='module')
def pair():
    jmodel, jvae = jax_tiny(seed=7)
    return jmodel, port_tiny(jmodel, jvae)


@pytest.fixture(scope='module')
def jax_quantized(pair):
    """The JAX package's quantize_for_serving of the tiny model (backbone
    and decoder), its scales, and the port's model carrying them."""
    jmodel, pmodel = pair
    text = jnp.asarray(np.random.RandomState(2).randint(
        1, 100, (4, jmodel.cfg.text_seq_len)), jnp.int32)
    jq = jint8.quantize_for_serving(jmodel, text=text)
    backbone, decoder = int8_scales_from_jax(jq.cfg.clip.int8_scales,
                                             jq.vae.cfg.int8_scales)
    pq = pint8.quantized_model(pmodel, backbone,
                               pint8.quantized_vae(pmodel.vae, decoder))
    return jq, pq


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_quantized_dense_matches_jax(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 37, 64).astype(np.float32) * 2
    w = (rng.randn(64, 48) * 0.1).astype(np.float32)   # JAX [in, out]
    w[:, 5] = 0.0                                      # a dead channel
    b = (rng.randn(48) * 0.01).astype(np.float32)
    a_scale = 5.4321                                   # some saturate
    jx = jnp.asarray(x).astype(dtype)
    want = jint8.quantized_dense(jx, jnp.asarray(w), jnp.asarray(b), a_scale)
    # JAX's integers, by its own formulas
    w_s = jnp.maximum(jnp.max(jnp.abs(w), axis=0) / 127.0, 1e-8)
    jw_q = jnp.round(jnp.asarray(w) / w_s[None]).astype(jnp.int8)
    jx_q = jnp.round(jnp.clip(jx.astype(jnp.float32) * (127.0 / a_scale),
                              -127.0, 127.0)).astype(jnp.int8)
    jacc = jax.lax.dot_general(jx_q, jw_q, (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)

    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = torch.from_numpy(w.T.copy())                  # port [out, in]
    w_q, w_scale = pint8.quantize_weight(tw)
    x_q = pint8.quantize_activation(tx, a_scale)
    np.testing.assert_array_equal(w_q.t().numpy(), np.asarray(jw_q))
    np.testing.assert_array_equal(w_scale.numpy(), np.asarray(w_s))
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(jx_q))
    acc = pint8.int_mm(x_q.reshape(-1, 64), w_q).view(3, 37, 48)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    got = pint8.quantized_dense(tx, tw, torch.from_numpy(b), a_scale)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('k', [3, 1])
def test_quantized_conv_matches_jax(k):
    rng = np.random.RandomState(k)
    x = rng.randn(3, 9, 7, 16).astype(np.float32)      # NHWC, odd sizes
    w = (rng.randn(k, k, 16, 24) * 0.2).astype(np.float32)   # HWIO
    b = (rng.randn(24) * 0.01).astype(np.float32)
    a_scale = 2.5
    want = jint8.quantized_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), a_scale)
    w_s = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2)) / 127.0, 1e-8)
    jw_q = jnp.round(jnp.asarray(w) / w_s).astype(jnp.int8)
    jx_q = jnp.round(jnp.clip(jnp.asarray(x) * (127.0 / a_scale), -127.0,
                              127.0)).astype(jnp.int8)
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                        ('NHWC', 'HWIO', 'NHWC'))
    jacc = jax.lax.conv_general_dilated(jx_q, jw_q, (1, 1), 'SAME',
                                        dimension_numbers=dn,
                                        preferred_element_type=jnp.int32)

    tx = torch.from_numpy(x).permute(0, 3, 1, 2)       # NCHW
    tw = torch.from_numpy(w).permute(3, 2, 0, 1)       # OIHW
    w_mat, w_scale = pint8.quantize_weight(tw)
    # JAX's int8 HWIO weights laid out as the port's [O, (kh, kw, C)]
    np.testing.assert_array_equal(
        w_mat.numpy(), np.asarray(jw_q).transpose(3, 0, 1, 2).reshape(24, -1))
    np.testing.assert_array_equal(w_scale.numpy(), np.asarray(w_s))
    x_q = pint8.quantize_activation(tx, a_scale).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(jx_q))
    acc = pint8.int8_conv(x_q, w_mat, k, k)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    got = pint8.quantized_conv(tx, tw, torch.from_numpy(b), a_scale)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


def test_quantized_conv_chunks_frames(monkeypatch):
    """Chunks of frames (the decoder's memory bound) give the same
    integers as one pass."""
    rng = np.random.RandomState(5)
    x_q = torch.from_numpy(rng.randint(-127, 128, (5, 6, 6, 8))).to(
        torch.int8)
    w_mat = torch.from_numpy(rng.randint(-127, 128, (4, 72))).to(
        torch.int8)
    whole = pint8.int8_conv(x_q, w_mat, 3, 3)
    monkeypatch.setattr(pint8, '_CONV_CHUNK_BYTES', 2 * 9 * 8 * 36)
    np.testing.assert_array_equal(pint8.int8_conv(x_q, w_mat, 3, 3).numpy(),
                                  whole.numpy())


def test_quantized_weights_follow_updates():
    """A serving copy quantizes its int8 sites' weights once, when
    quantized_vae builds it (ops.int8.freeze_weights): each scaled site
    holds quantize_weight of its shared weight, and computes what
    quantizing at the call computes; the unquantized model and unscaled
    sites hold none.  After an in-place update of the shared weights, a
    copy built anew follows it.  The backbone's sites (Mlp,
    MultiHeadAttention) freeze the same way."""
    from mmvid_tpu_torch.models.clip import Mlp, MultiHeadAttention

    torch.manual_seed(0)
    vae = VQGanVAE(image_size=64, cfg=VQGanConfig(**VQ_ATTN)).eval()
    site = 'decoder/conv_in'
    conv = pint8.quantized_vae(vae, ((site, 1.0),)).model.decoder.conv_in
    assert conv.weight is vae.model.decoder.conv_in.weight
    for got, want in zip(conv.w8, pint8.quantize_weight(conv.weight)):
        assert torch.equal(got, want)
    assert all(m.w8 is None for m in vae.modules()
               if isinstance(m, SiteConv))
    x = torch.randn(2, conv.in_channels, 5, 5)
    torch.testing.assert_close(
        conv(x), pint8.quantized_conv(x, conv.weight, conv.bias, 1.0),
        rtol=0, atol=0)
    with torch.no_grad():
        conv.weight.mul_(2.0)
        conv.weight[0, 0, 0, 0] = 100.0
    conv = pint8.quantized_vae(vae, ((site, 1.0),)).model.decoder.conv_in
    assert conv.w8[1][0].item() == pytest.approx(100.0 / 127.0)

    mlp, mha = Mlp(16), MultiHeadAttention(16, 2)
    assert mlp.w8 == {} and mha.w8 == {}
    pint8.freeze_weights(torch.nn.ModuleList([mlp, mha]))
    for w8, w in ((mlp.w8['c_fc'], mlp.c_fc.weight),
                  (mlp.w8['c_proj'], mlp.c_proj.weight),
                  (mha.w8['in_proj'], mha.in_proj_weight),
                  (mha.w8['out_proj'], mha.out_proj.weight)):
        for got, want in zip(w8, pint8.quantize_weight(w)):
            assert torch.equal(got, want)


@pytest.mark.parametrize('n', [1, 1000, 12345, (1 << 24) + 3])
def test_calib_stats_matches_jnp_quantile(n):
    x = np.random.RandomState(n % 97).randn(n).astype(np.float32) * 3
    want = np.asarray(jint8.calib_stats(jnp.asarray(x)))
    got = pint8.calib_stats(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if n > 1 << 24:   # the trap the top-k route avoids
        with pytest.raises(RuntimeError, match='too large'):
            torch.quantile(torch.from_numpy(x).abs(), 0.5)


def test_stat_index_and_safe_scale_match_jax():
    for p in (None, 99.9, 99.99):
        assert pint8._stat_index(p) == jint8._stat_index(p)
    with pytest.raises(ValueError, match='unsupported'):
        pint8._stat_index(95.0)
    for v in (0.0, 3e-5, 0.12345678, 7.00005, 123.45675):
        assert pint8._safe_scale(v) == jint8._safe_scale(v)
    recs = [np.array([1.0, 2.0, 3.0]), np.array([4.0, 1.5, 2.5])]
    for p in (None, 99.9, 99.99):
        assert (pint8._site_scale(recs, p, 1.25)
                == jint8._site_scale(recs, p, 1.25))


def _jax_records(tree):
    """A sowed CALIB_COL tree as the port's {path: [records]} dict."""
    return {p: [np.asarray(r) for r in v]
            for p, v in jint8._flatten_calib(tree).items()}


@pytest.mark.parametrize('percentile', [None, 99.9, 99.99])
def test_backbone_calibration_matches_jax(pair, percentile):
    """The stack's four sites a block record what JAX's sow records (the
    stack alone, on the same input and mask), and the scales agree to their
    rounding step; fed JAX's own records, calibrate_int8_scales gives
    JAX's scales exactly."""
    from mmvid_tpu.models.clip import TransformerStack as JaxStack
    from mmvid_tpu.models.clip import build_attention_mask as jax_mask
    from mmvid_tpu_torch.models.clip import build_attention_mask
    jmodel, pmodel = pair
    cfg = jmodel.cfg
    idx = (cfg.st1_tok_index, cfg.vid_tok_index)
    rng = np.random.RandomState(4)
    trees, recs = [], []
    for seed in range(2):
        x = rng.randn(4, cfg.total_seq_len, cfg.dim).astype(np.float32)
        _, aux = JaxStack(cfg.clip).apply(
            {'params': jmodel.params['transformer']}, jnp.asarray(x),
            jax_mask(cfg.total_seq_len, 'mask_prev', index=idx),
            mutable=[jint8.CALIB_COL])
        trees.append(aux[jint8.CALIB_COL])
        with torch.no_grad(), pint8.recording() as r:
            pmodel.transformer['transformer'](
                torch.from_numpy(x),
                build_attention_mask(cfg.total_seq_len, 'mask_prev',
                                     index=idx))
        recs.append(r)
    assert sorted(recs[0]) == sorted(
        f'blocks_{i}/{part}/{site}' for i in range(cfg.clip.layers)
        for part, site in (('attn', 'qkv_in'), ('attn', 'out_in'),
                           ('mlp', 'fc_in'), ('mlp', 'proj_in')))
    want = jint8.calibrate_int8_scales(trees, cfg.clip.layers, percentile)
    got = pint8.calibrate_int8_scales(recs, cfg.clip.layers, percentile)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=SCALE_STEP)
    assert all(v > 0 for layer in got for v in layer)
    assert pint8.calibrate_int8_scales(
        [_jax_records(t) for t in trees], cfg.clip.layers,
        percentile) == want


def _model_calibration(pair, percentile):
    """(port, JAX) scales of the whole-model calibration forwards
    (all-[MASK] and random targets) on the same text and weights."""
    jmodel, pmodel = pair
    cfg = jmodel.cfg
    rng = np.random.RandomState(4)
    text = rng.randint(1, 100, (4, cfg.text_seq_len)).astype(np.int32)
    targets = (np.full((4, cfg.target_seq_len), cfg.mask_token, np.int32),
               rng.randint(0, 1024, (4, cfg.target_seq_len)).astype(
                   np.int32))
    trees, recs = [], []
    for target in targets:
        _, aux = jmodel.core.apply({'params': jmodel.params},
                                   jnp.asarray(text), None,
                                   jnp.asarray(target),
                                   mutable=[jint8.CALIB_COL])
        trees.append(aux[jint8.CALIB_COL])
        with torch.no_grad(), pint8.recording() as r:
            pmodel.core(torch.from_numpy(text).long(), None,
                        torch.from_numpy(target).long())
        recs.append(r)
    return (pint8.calibrate_int8_scales(recs, cfg.clip.layers, percentile),
            jint8.calibrate_int8_scales(trees, cfg.clip.layers, percentile))


def test_model_calibration_abs_max_matches_jax(pair):
    """Whole-model calibration forwards (all-[MASK] and random targets):
    abs-max scales agree to their rounding step.  (While recording, the
    port pads the sequence to a multiple of 64 as JAX's BertCore does, so
    both record the same rows; the percentile test below compares the
    quantiles that the pad rows move.)"""
    got, want = _model_calibration(pair, None)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=SCALE_STEP)


@pytest.mark.parametrize('percentile', [99.9, 99.99])
def test_model_calibration_percentile_matches_jax(pair, percentile):
    """C3: whole-model percentile calibration gives JAX's scales (within
    their rounding step).  JAX's BertCore pads the sequence to a multiple
    of 64 and its sites record the pad rows; the port pads the same way
    while recording, so the quantiles are taken over the same rows.
    Serving forwards stay unpadded (test_serving_forward_is_unpadded)."""
    got, want = _model_calibration(pair, percentile)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=SCALE_STEP)


def test_serving_forward_is_unpadded(pair):
    """Outside recording(), the stack runs the true length: the mask that
    reaches attention is [L, L]; while recording it is the padded one."""
    _, pmodel = pair
    cfg = pmodel.cfg
    seen = []
    attn = pmodel.transformer['transformer'].resblocks[0].attn
    hook = attn.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].shape[1]))
    try:
        text = torch.randint(1, 100, (1, cfg.text_seq_len),
                             generator=torch.Generator().manual_seed(0))
        target = torch.full((1, cfg.target_seq_len), cfg.mask_token)
        with torch.no_grad():
            pmodel.core(text, None, target)
            with pint8.recording():
                pmodel.core(text, None, target)
    finally:
        hook.remove()
    assert seen == [cfg.total_seq_len, -(-cfg.total_seq_len // 64) * 64]


# the JAX package's decoder test config (tests/test_int8.py): resnet
# blocks with nin_shortcut, attention blocks and an upsample
VQ_ATTN = dict(resolution=64, ch=32, ch_mult=(1, 2), num_res_blocks=1,
               z_channels=64, embed_dim=64, n_embed=256,
               attn_resolutions=(32,))


@pytest.fixture(scope='module')
def vae_pair():
    jvae = JaxVAE(image_size=64, cfg=JaxVQCfg(**VQ_ATTN), params={})
    jvae = JaxVAE(image_size=64, cfg=JaxVQCfg(**VQ_ATTN),
                  params=jax.jit(jvae.init_params)(jax.random.PRNGKey(3)))
    pvae = VQGanVAE(image_size=64, cfg=VQGanConfig(**VQ_ATTN))
    load_weights(pvae.model, vqgan_params_to_torch(jvae.params))
    return jvae, pvae.eval()


@pytest.mark.parametrize('percentile', [None, 99.99])
def test_quantize_vae_decoder_matches_jax(vae_pair, percentile):
    jvae, pvae = vae_pair
    toks = np.random.RandomState(6).randint(0, 256, (2, 256)).astype(
        np.int32)
    jq = jint8.quantize_vae_decoder(jvae, sample_tokens=jnp.asarray(toks),
                                    percentile=percentile)
    pq = pint8.quantize_vae_decoder(pvae, sample_tokens=torch.from_numpy(
        toks).long(), percentile=percentile)
    want, got = dict(jq.cfg.int8_scales), dict(pq.cfg.int8_scales)
    assert sorted(got) == sorted(want)          # every site, JAX's names
    assert {'decoder/conv_in', 'decoder/conv_out', 'decoder/mid_attn_1/q',
            'decoder/up_1_upsample/conv',
            'decoder/up_0_block_0/nin_shortcut'} <= set(got)
    for path, v in want.items():
        assert abs(got[path] - v) <= SCALE_STEP, (path, got[path], v)
    # each site of the copy holds its scale; the parameters are shared
    sites = {m.site: m.a_scale for m in pq.modules()
             if isinstance(m, SiteConv) and m.site}
    assert sites == got
    assert pq.model.decoder.conv_in.weight is pvae.model.decoder.conv_in.weight
    assert all(m.a_scale is None for m in pvae.modules()
               if isinstance(m, SiteConv))
    # the encoder is never a site
    assert not any(isinstance(m, SiteConv) and m.site
                   for m in pq.model.encoder.modules())
    # the quantized decoder close to the unquantized one (JAX's own
    # bounds, tests/test_int8.py)
    t = torch.from_numpy(toks).long()
    base = pvae.decode(t).numpy()
    got_img = pq.decode(t).numpy()
    assert np.mean(np.abs(got_img - base)) < 0.02
    assert np.max(np.abs(got_img - base)) < 0.2


# one site of each kind
DECODER_SITES = ('decoder/conv_in', 'decoder/mid_block_1/conv2',
                 'decoder/up_0_block_0/nin_shortcut', 'decoder/mid_attn_1/q',
                 'decoder/up_1_attn_0/proj_out', 'decoder/up_1_upsample/conv',
                 'decoder/conv_out')


def test_decoder_sites_with_jax_scales_match_jax(vae_pair):
    """JAX's decoder scales carried over.  Site by site (that site alone
    quantized), the port's images are within a tenth of what the
    quantization itself moves them, and 5e-3: a last-bit difference of an
    input can flip an int8 rounding (a step of a_scale / 127 times a
    weight), as it does between any two fp32 implementations.  All sites
    at once, such flips cascade through the decoder's quantized convs
    (measured here: mean 0.0117, max 0.071 on [0, 1]), so the whole
    decoder is held to JAX's own int8 bounds against JAX's int8 images."""
    jvae, pvae = vae_pair
    toks = np.random.RandomState(6).randint(0, 256, (2, 256)).astype(
        np.int32)
    t = torch.from_numpy(toks).long()
    jq = jint8.quantize_vae_decoder(jvae, sample_tokens=jnp.asarray(toks))
    scales = dict(jq.cfg.int8_scales)
    base = pvae.decode(t).numpy()
    for site in DECODER_SITES:
        one = ((site, scales[site]),)
        want = np.asarray(JaxVAE(
            params=jvae.params, image_size=64,
            cfg=dataclasses.replace(jvae.cfg, int8_scales=one)).decode(
                jnp.asarray(toks)))
        got = pint8.quantized_vae(pvae, one).decode(t).numpy()
        err, moved = np.abs(got - want).max(), np.abs(got - base).max()
        assert err <= min(5e-3, 0.25 * moved), (site, err, moved)
    got = pint8.quantized_vae(pvae, jq.cfg.int8_scales).decode(t).numpy()
    want = np.asarray(jq.decode(jnp.asarray(toks)))
    assert np.mean(np.abs(got - want)) < 0.02
    assert np.max(np.abs(got - want)) < 0.2


def test_quantized_backbone_logits_match_jax(pair, jax_quantized):
    jmodel, pmodel = pair
    jq, pq = jax_quantized
    cfg = jmodel.cfg
    assert pq.cfg.clip.int8_scales == jq.cfg.clip.int8_scales
    rng = np.random.RandomState(8)
    text = rng.randint(1, 100, (2, cfg.text_seq_len)).astype(np.int32)
    target = rng.randint(0, 1025, (2, cfg.target_seq_len)).astype(np.int32)
    want = np.asarray(jq.core.apply({'params': jq.params}, jnp.asarray(text),
                                    None, jnp.asarray(target))[0])
    base = np.asarray(jmodel.core.apply({'params': jmodel.params},
                                        jnp.asarray(text), None,
                                        jnp.asarray(target))[0])
    with torch.no_grad():
        got = pq.core(torch.from_numpy(text).long(), None,
                      torch.from_numpy(target).long())[0].numpy()
    assert _rel(got, want) < 2e-3
    # the quantization is real: further from the unquantized logits
    assert _rel(got, base) > 10 * _rel(got, want)


def _deterministic(build_spec):
    def patched(*a, **k):
        return dataclasses.replace(build_spec(*a, **k), deterministic=True)
    return patched


def test_generate_images_int8_matches_jax(jax_quantized, monkeypatch):
    """w8a8 backbone and decoder with JAX's scales carried over, and
    MMVID_ATTN_INT8=1 in both packages: the same tokens under the
    deterministic hook, the same videos."""
    import mmvid_tpu.ops.attention as jattn
    jq, pq = jax_quantized
    monkeypatch.setenv('MMVID_ATTN_INT8', '1')
    monkeypatch.setenv('MMVID_PALLAS_ATTN', '1')
    orig = jattn.fused_attention_blhd
    monkeypatch.setattr(jattn, 'fused_attention_blhd',
                        lambda q, k, v, m, sm_scale=None: orig(
                            q, k, v, m, sm_scale, interpret=True))
    monkeypatch.setattr(jmmvid, 'build_spec',
                        _deterministic(jmmvid.build_spec))
    monkeypatch.setattr(pmmvid, 'build_spec',
                        _deterministic(pmmvid.build_spec))
    cfg = jq.cfg
    text = np.random.RandomState(9).randint(
        0, cfg.num_text_tokens, (2, cfg.text_seq_len)).astype(np.int32)
    jq._gen_cache.clear()
    want_v, want_t = jq.generate_images(
        jax.random.PRNGKey(0), jnp.asarray(text), mask_predict_steps=4,
        dynamic=False)
    for mod in (A, A8):
        monkeypatch.setattr(mod, 'launches', 0)
    got_v, got_t = pq.generate_images(
        torch.Generator().manual_seed(0), torch.from_numpy(text).long(),
        mask_predict_steps=4, dynamic=False)
    assert (A.launches, A8.launches) == (0, 0)     # CPU: plain versions
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=2e-3)


def test_quantize_for_serving(pair):
    """The port's own calibration: a new model sharing the parameters,
    positive scales for every block and every decoder site, and one that
    samples; ``decoder=False`` keeps the model's vae."""
    _, pmodel = pair
    g = torch.Generator().manual_seed(0)
    q = pint8.quantize_for_serving(pmodel, generator=g)
    assert q is not pmodel and q.cfg.clip.int8_scales is not None
    assert pmodel.cfg.clip.int8_scales is None     # the original untouched
    scales = q.cfg.clip.int8_scales
    assert len(scales) == 2 and all(len(s) == 4 and min(s) > 0
                                    for s in scales)
    assert q.transformer['transformer'].cfg.int8_scales == scales
    for (k, a), (k2, b) in zip(q.state_dict(keep_vars=True).items(),
                               pmodel.state_dict(keep_vars=True).items()):
        assert k == k2 and a is b, k
    sites = [m.site for m in pmodel.vae.modules()
             if isinstance(m, SiteConv) and m.site]
    assert sorted(p for p, _ in q.vae.cfg.int8_scales) == sorted(sites)
    assert q.cvae is pmodel.cvae
    videos, toks = q.generate_images(torch.Generator().manual_seed(1),
                                     torch.ones((2, 8), dtype=torch.long),
                                     mask_predict_steps=2, dynamic=False)
    assert torch.isfinite(videos).all() and videos.min() >= 0
    assert videos.max() <= 1 and toks.max() < 1024
    q2 = pint8.quantize_for_serving(pmodel, decoder=False, generator=g)
    assert q2.vae is pmodel.vae


def test_int8_stack_is_serving_only():
    """A quantized stack refuses grad (rounding has none), as JAX refuses
    int8 under remat or training; under no_grad it runs."""
    cfg = ClipStackConfig(width=64, layers=2, heads=2,
                          int8_scales=((1.0, 1.0, 1.0, 1.0),) * 2)
    stack = TransformerStack(cfg)
    x = torch.randn(1, 8, 64)
    with pytest.raises(RuntimeError, match='serving-only'):
        stack(x)
    with torch.no_grad():
        assert torch.isfinite(stack(x)).all()


def test_fused_lnqkv_gate_skipped_by_int8_and_calibration(pair,
                                                           monkeypatch):
    """MMVID_FUSED_LNQKV=1 (width 128) still records every site and runs
    the int8 sites, as JAX's gate skips the fused block there."""
    from mmvid_tpu_torch.ops import fused_ln_qkv as Q
    monkeypatch.setenv('MMVID_FUSED_LNQKV', '1')
    calls = []
    monkeypatch.setattr('mmvid_tpu_torch.models.clip.fused_ln_qkv',
                        lambda *a: calls.append(1) or Q.fused_ln_qkv(*a))
    stack = TransformerStack(ClipStackConfig(width=128, layers=1, heads=2))
    x = torch.randn(1, 5, 128)
    with torch.no_grad():
        stack(x)
        assert len(calls) == 1                  # the gate itself works
        with pint8.recording() as r:
            stack(x)
        assert len(calls) == 1 and len(r) == 4
        stack.cfg = dataclasses.replace(stack.cfg,
                                        int8_scales=((4.0,) * 4,))
        stack(x)
        assert len(calls) == 1


def test_cpu_attention_keeps_autograd():
    """C1: on the CPU the plain versions keep autograd (on the card the
    LN+QKV kernel refuses grad, and attention's kernel forward carries
    FusedAttention's backward; tests/test_torch_kernels.py)."""
    from mmvid_tpu_torch.ops.fused_ln_qkv import fused_ln_qkv
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 9, 2, 32, generator=g, requires_grad=True)
               for _ in range(3))
    A.fused_attention_blhd(q, k, v).sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (q, k, v))
    x = torch.randn(3, 128, generator=g, requires_grad=True)
    w = torch.randn(384, 128, generator=g, requires_grad=True)
    fused_ln_qkv(x, torch.ones(128), torch.zeros(128), w,
                 torch.zeros(384)).square().sum().backward()
    assert x.grad.abs().sum() > 0 and w.grad.abs().sum() > 0


def test_int8_scales_from_jax_forms():
    backbone, decoder = int8_scales_from_jax(
        ((np.float32(1.5), 2, 3.25, 4),),
        (('decoder/conv_out', 0.5), ('decoder/conv_in', np.float64(2.0))))
    assert backbone == ((1.5, 2.0, 3.25, 4.0),)
    assert decoder == (('decoder/conv_in', 2.0), ('decoder/conv_out', 0.5))
    assert int8_scales_from_jax() == (None, None)


def _tiny_checkpoint(tmp_path, ar):
    """A reference-format dalle.pt of a tiny custom model (hparams without
    ``ar``), weights from a seed."""
    from types import SimpleNamespace
    from mmvid_tpu_torch import factories
    hparams = {'dim': 64, 'text_seq_len': 6, 'num_targets': 2,
               'num_visuals': 0, 'image_size': 32,
               'which_transformer': 'custom:64:2:2'}
    args = SimpleNamespace(**hparams, ar=ar, loss_img_weight=7,
                           insert_sep=False, use_separate_visual_emb=False,
                           fixed_language_model=None,
                           text_emb_bottleneck=None)
    model = factories.get_dalle(
        args, factories.get_vae_model(args, device='cpu'), device='cpu')
    factories.init_weights(model, torch.Generator().manual_seed(0))
    torch.save({'iter': 1, 'hparams': hparams,
                'weights': model.state_dict()}, tmp_path / 'dalle.pt')
    return tmp_path / 'dalle.pt'


@pytest.mark.parametrize('ar', [False, True], ids=['mask_predict', 'artv'])
def test_generate_main_int8(tmp_path, monkeypatch, ar):
    """``generate --int8`` on the CPU: a mask-predict model is calibrated
    at load (its backbone and decoder carry scales) and writes videos;
    ``--ar`` samples a checkpoint whose hparams lack ``ar`` as ART-V, and
    with ``--int8`` through its int8 decode."""
    from mmvid_tpu_torch import generate
    from mmvid_tpu_torch.models import artv as partv
    path = _tiny_checkpoint(tmp_path, ar)
    argv = ['--dalle_path', str(path), '--device', 'cpu', '--no-bf16',
            '--int8'] + (['--ar'] if ar else [])
    model, _ = generate.load_model(generate.parse_args(argv))
    assert type(model).__name__ == ('ArtvModel' if ar else 'MMVIDBert')
    if not ar:
        assert model.cfg.clip.int8_scales is not None
        assert model.vae.cfg.int8_scales
    seen = []
    real = partv.ar_sample
    monkeypatch.setattr(partv, 'ar_sample', lambda *a, **k: (
        seen.append(k.get('int8')), real(*a, **k))[1])
    monkeypatch.setenv('MMVID_ATTN_INT8', '1')
    generate.main(generate.parse_args(argv + [
        '--prompts', 'a person is talking', 'she laughs', '--out_dir',
        str(tmp_path / 'out'), '--batch_size', '2', '--format', 'png',
        '--mask_predict_steps', '2']))
    assert len(sorted((tmp_path / 'out').glob('*.png'))) == 2
    assert seen == ([True] if ar else [])
