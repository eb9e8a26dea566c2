"""The port's fused LN+QKV (mmvid_tpu_torch.ops.fused_ln_qkv and its gate in
models/clip.py) vs the JAX package's Pallas kernel run in interpret mode,
on the CPU.

Tolerances: the plain version against the kernel at fp32 within 2e-5,
the bound of tests/test_fused_ln_qkv.py (one product summed in another
order); a 2-layer width-128 stack with MMVID_FUSED_LNQKV=1 in both
packages within 1e-4, the bound of the port's other stack tests.  In bf16
both round h and the output to bf16, and a last-bit difference of the
fp32 statistics can flip one rounding: 2e-2, a few bf16 ulps at |qkv|
about 2.  A CPU emulation of the CUDA kernel's statistics, normalisation
and product order is held against the Pallas kernel within one bf16 ulp
of max(|out|, 1).
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


def bf16_ulp(x):
    """One bf16 ulp at the larger of |x| and 1 (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1.0))) - 7)


def _f32(x):
    return np.asarray(x, np.float64).astype(np.float32)


def kernel_emulation(x, ln_w, ln_b, w, b):
    """csrc/fused_ln_qkv_sm90.cu's arithmetic on the CPU: x [M, D], w
    [3D, D], b [3D] bf16 (numpy fp32 arrays of bf16 values), ln_w, ln_b
    fp32 -> qkv [M, 3D] as fp32 values of bf16.  The statistics pass: lane
    l of a warp sums the 8-value chunks l, l + 32, ... of its row in order
    (x by adds, x^2 by fmas), the 32 lanes by a butterfly, var = s2 / D -
    mu * mu with one rounding (the compiler's fma); h = bf16((x - mu) *
    rstd * ln_w + ln_b), each op rounded; the product in 64-deep slabs of
    four 16-deep wgmma steps, the fp32 sum updated once a step (the
    step's 16 products and the sum rounded once); b added in fp32."""
    m, d = x.shape
    s = np.zeros((m, 32), np.float32)
    s2 = np.zeros((m, 32), np.float32)
    for c in range(d // 8):
        for e in range(8):
            val = x[:, 8 * c + e]
            s[:, c % 32] = s[:, c % 32] + val
            s2[:, c % 32] = _f32(val.astype(np.float64) ** 2
                                 + s2[:, c % 32])
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, lanes ^ off]
        s2 = s2 + s2[:, lanes ^ off]
    mu = s[:, :1] / np.float32(d)
    var = _f32(s2[:, :1] / np.float32(d) - mu.astype(np.float64) ** 2)
    rstd = (np.float32(1) / np.sqrt(var + np.float32(1e-5))).astype(
        np.float32)
    h = ((x - mu) * rstd) * ln_w + ln_b
    h = torch.from_numpy(h.astype(np.float32)).bfloat16().float().numpy()
    acc = np.zeros((m, w.shape[0]), np.float32)
    for k0 in range(0, d, 16):
        acc = _f32(acc + h[:, k0:k0 + 16].astype(np.float64)
                   @ w[:, k0:k0 + 16].T.astype(np.float64))
    out = acc + b
    return torch.from_numpy(out).bfloat16().float().numpy()


@pytest.mark.parametrize('b,l,d', [(2, 37, 128), (3, 100, 256)])
def test_kernel_emulation_matches_jax_kernel_interpret(b, l, d):
    """The wgmma kernel's statistics, normalisation and product order
    (kernel_emulation; ragged M against the 128-row tile and 3D against
    the 256-column tile) against the JAX package's Pallas kernel in
    interpret mode, bf16: within one bf16 ulp of max(|out|, 1) (a
    last-bit difference of the statistics or of an fp32 sum flips one
    rounding of h or of the output)."""
    x, scale, bias, ws, bs = _inputs(b, l, d, seed=3)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    xb, wsb, bsb = bf(x), [bf(w) for w in ws], [bf(v) for v in bs]
    want = _jax_interpret(xb, scale, bias, wsb, bsb)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    got = kernel_emulation(
        f32(xb).reshape(-1, d), scale, bias,
        f32(np.concatenate([w.T for w in wsb], axis=0)),
        f32(np.concatenate(bsb))).reshape(want.shape)
    assert (np.abs(got - want) <= bf16_ulp(want)).all()
    assert np.mean(got != want) <= 0.01
