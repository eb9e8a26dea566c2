"""The port's fused LN+QKV (mmvid_tpu_torch.ops.fused_ln_qkv and its gate in
models/clip.py) vs the JAX package's Pallas kernel run in interpret mode,
on the CPU.

Tolerances: the plain version against the kernel at fp32 within 2e-5,
the bound of tests/test_fused_ln_qkv.py (one product summed in another
order); a 2-layer width-128 stack with MMVID_FUSED_LNQKV=1 in both
packages within 1e-4, the bound of the port's other stack tests.  In bf16
both round h and the output to bf16, and a last-bit difference of the
fp32 statistics can flip one rounding: 2e-2, a few bf16 ulps at |qkv|
about 2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvid_tpu.models.clip import ClipStackConfig as JaxClip
from mmvid_tpu.models.clip import TransformerStack as JaxStack
from mmvid_tpu.models.clip import build_attention_mask as jax_mask
from mmvid_tpu.utils.torch_compat import convert_clip_resblocks
from mmvid_tpu_torch.models import clip as pclip
from mmvid_tpu_torch.ops import fused_ln_qkv as Q
from mmvid_tpu_torch.utils.torch_compat import bert_params_to_torch


def _inputs(b, l, d, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, l, d).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    bias = (0.1 * rng.randn(d)).astype(np.float32)
    ws = [(0.05 * rng.randn(d, d)).astype(np.float32) for _ in range(3)]
    bs = [(0.05 * rng.randn(d)).astype(np.float32) for _ in range(3)]
    return x, scale, bias, ws, bs


def _jax_interpret(x, scale, bias, ws, bs):
    from mmvid_tpu.ops.fused_ln_qkv import fused_ln_qkv
    args = [jnp.asarray(a) for a in (x, scale, bias, ws[0], bs[0], ws[1],
                                     bs[1], ws[2], bs[2])]
    return np.concatenate([np.asarray(o, np.float32) for o in
                           fused_ln_qkv(*args, interpret=True)], axis=-1)


def _port(x, scale, bias, ws, bs, dtype=torch.float32):
    # the packed in_proj layout: W [3D, D] = [Wq^T; Wk^T; Wv^T]
    w = torch.from_numpy(np.concatenate([w.T for w in ws], axis=0))
    b = torch.from_numpy(np.concatenate(bs))
    return Q.fused_ln_qkv(torch.from_numpy(x).to(dtype),
                          torch.from_numpy(scale), torch.from_numpy(bias),
                          w.to(dtype), b.to(dtype))


def test_plain_matches_jax_kernel_interpret():
    ins = _inputs(2, 37, 128)
    want = _jax_interpret(*ins)
    got = _port(*ins)
    assert got.shape == (2, 37, 384) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_plain_matches_jax_kernel_interpret_bf16():
    x, scale, bias, ws, bs = _inputs(2, 37, 128, seed=1)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    want = _jax_interpret(bf(x), scale, bias, [bf(w) for w in ws],
                          [bf(b) for b in bs])
    got = _port(x, scale, bias, ws, bs, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_wrapper_takes_plain_on_cpu(monkeypatch):
    monkeypatch.setattr(Q, 'launches', 0)
    x, scale, bias, ws, bs = _inputs(1, 5, 64, seed=2)
    got = _port(x, scale, bias, ws, bs)
    assert got.shape == (1, 5, 192) and Q.launches == 0


def _stack_pair(width, seed=2):
    cfg = JaxClip(width=width, layers=2, heads=2)
    x = np.random.RandomState(seed).randn(2, 23, width).astype(np.float32)
    mask = jax_mask(23, 'mask_prev', index=[3])
    params = jax.jit(JaxStack(cfg).init)(jax.random.PRNGKey(seed),
                                         jnp.asarray(x), mask)['params']
    port = pclip.TransformerStack(pclip.ClipStackConfig(width, 2, 2))
    sd = bert_params_to_torch({'transformer': params})
    port.load_state_dict({k[len('transformer.transformer.'):]:
                          torch.from_numpy(np.array(v))
                          for k, v in sd.items()})
    return cfg, params, port, x


def test_stack_with_fused_lnqkv_matches_jax(monkeypatch):
    cfg, params, port, x = _stack_pair(128)
    mask = jax_mask(23, 'mask_prev', index=[3])
    import mmvid_tpu.ops.attention as attn_mod
    import mmvid_tpu.ops.fused_ln_qkv as lq_mod
    orig_a, orig_q = attn_mod.fused_attention_blhd, lq_mod.fused_ln_qkv
    monkeypatch.setattr(attn_mod, 'fused_attention_blhd',
                        lambda q, k, v, m, sm_scale=None: orig_a(
                            q, k, v, m, sm_scale, interpret=True))
    monkeypatch.setattr(lq_mod, 'fused_ln_qkv',
                        lambda *a, **kw: orig_q(*a, interpret=True))
    monkeypatch.setenv('MMVID_FUSED_LNQKV', '1')
    monkeypatch.setenv('MMVID_PALLAS_ATTN', '1')
    want = JaxStack(cfg).apply({'params': params}, jnp.asarray(x), mask)
    calls = []
    monkeypatch.setattr(pclip, 'fused_ln_qkv',
                        lambda *a: calls.append(1) or Q.fused_ln_qkv(*a))
    with torch.no_grad():
        got = port(torch.from_numpy(x),
                   pclip.build_attention_mask(23, 'mask_prev', index=[3]))
    assert len(calls) == 2   # one per block
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # the fused path computes what the unfused one does
    monkeypatch.delenv('MMVID_FUSED_LNQKV')
    with torch.no_grad():
        base = port(torch.from_numpy(x),
                    pclip.build_attention_mask(23, 'mask_prev', index=[3]))
    assert len(calls) == 2
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize('flag,width', [('0', 128), ('1', 64)])
def test_gate_stays_off(monkeypatch, flag, width):
    """Off unless MMVID_FUSED_LNQKV=1 and the width is a multiple of 128,
    as in the JAX package."""
    _, _, port, x = _stack_pair(width, seed=3)
    monkeypatch.setenv('MMVID_FUSED_LNQKV', flag)

    def refuse(*a):
        raise AssertionError('fused LN+QKV taken with the gate off')

    monkeypatch.setattr(pclip, 'fused_ln_qkv', refuse)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.shape == x.shape


def test_converter_round_trip_of_the_stack():
    """The packed in_proj the port loads is the JAX package's q/k/v."""
    _, params, port, _ = _stack_pair(128, seed=4)
    sd = {f'transformer.{k}': v.numpy()
          for k, v in port.state_dict().items()}
    back = convert_clip_resblocks(sd, 'transformer')
    for blk in params:
        for proj in ('query', 'key', 'value'):
            np.testing.assert_array_equal(
                back[blk]['attn'][proj]['kernel'],
                np.asarray(params[blk]['attn'][proj]['kernel']))
