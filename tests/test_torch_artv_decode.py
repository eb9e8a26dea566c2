"""The port's plain ART-V decode step (ops/artv_decode.py) against the JAX
package's Pallas kernel in interpret mode, on the same stacked params and
caches, and the grid-step probe's plain version (ops/gridstep.py), on the
CPU.

Shapes: 2 layers, B 2, W 256 (a multiple of the JAX kernel's 128-row
chunk at B 2), head dims 32 (D 64, 2 heads) and 64 (D 128, 2 heads); pos
0 (no cache row), 1, 128 (a chunk boundary) and 255 (the last row).  The
streaming bf16 kernel's order of sums (csrc/artv_decode_sm90.cu: the proj
product split along K into 4 partials added in chunk order) is emulated
here and held against the same JAX kernel at B 1, 2 and 5.  Tolerances:
fp32 1e-5 (sums in another order); bf16 2e-2 relative (rtol = atol): the bf16
roundings of h, the probabilities and the MLP activations fall on the
same values, but a last-bit difference of an fp32 sum before a rounding
flips it by one bf16 ulp (2^-8 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmvid_tpu.ops import artv_decode as jdec
from mmvid_tpu_torch.ops import artv_decode as AD
from mmvid_tpu_torch.ops import gridstep as G

LAYERS, B, W = 2, 2, 256
TOL = {'float32': 1e-5, 'bfloat16': 2e-2}


def _weights(d, seed):
    """Per-layer numpy weights in the JAX layout ([in, out] kernels)."""
    rng = np.random.RandomState(seed)

    def dense(i, o):
        return {'kernel': (rng.randn(i, o) * i ** -0.5).astype(np.float32),
                'bias': (0.1 * rng.randn(o)).astype(np.float32)}

    def ln():
        return {'scale': (1 + 0.1 * rng.randn(d)).astype(np.float32),
                'bias': (0.1 * rng.randn(d)).astype(np.float32)}
    return [{'ln_1': ln(), 'ln_2': ln(),
             'attn': {'qkv': dense(d, 3 * d), 'out': dense(d, d)},
             'mlp': {'fc': dense(d, 4 * d), 'proj': dense(4 * d, d)}}
            for _ in range(LAYERS)]


def _port_params(blocks, dtype):
    """The same weights as the port's DecodeParams ([out, in] weights in
    ``dtype``, LayerNorm params and biases fp32)."""
    def stk(fn, w=False):
        t = torch.from_numpy(np.stack([fn(b) for b in blocks]))
        return t.to(dtype).contiguous() if w else t

    def wt(path):
        return stk(lambda b: b[path[0]][path[1]]['kernel'].T.copy(), True)

    def bias(path):
        return stk(lambda b: b[path[0]][path[1]]['bias'])
    return AD.DecodeParams(
        stk(lambda b: b['ln_1']['scale']), stk(lambda b: b['ln_1']['bias']),
        stk(lambda b: b['ln_2']['scale']), stk(lambda b: b['ln_2']['bias']),
        wt(('attn', 'qkv')), bias(('attn', 'qkv')),
        wt(('attn', 'out')), bias(('attn', 'out')),
        wt(('mlp', 'fc')), bias(('mlp', 'fc')),
        wt(('mlp', 'proj')), bias(('mlp', 'proj')))


def _jax_stacked(blocks, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def cast(b):
        def c(sub):
            return {'kernel': jnp.asarray(sub['kernel']).astype(jdt),
                    'bias': jnp.asarray(sub['bias'])}
        return {'ln_1': b['ln_1'], 'ln_2': b['ln_2'],
                'attn': {k: c(v) for k, v in b['attn'].items()},
                'mlp': {k: c(v) for k, v in b['mlp'].items()}}
    d = blocks[0]['ln_1']['scale'].shape[0]
    return jdec.stack_decode_params([cast(b) for b in blocks], d)


def _step_inputs(d, dtype, seed, b=B):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, d).astype(np.float32)
    ck, cv = (torch.from_numpy(rng.randn(LAYERS, b, W, d).astype(np.float32)
                               ).to(dtype) for _ in range(2))
    return x, ck, cv


def _stream_order_step(x, p, cache_k, cache_v, pos, heads):
    """decode_token_step_reference with the streaming kernel's order of
    the fp32 sums: the proj product as 4 partials of D columns of g each,
    added in chunk order, then (R + sum) + b; the bf16 rounding points
    unchanged."""
    n_layers, b, _, d = cache_k.shape
    hd, dt = d // heads, cache_k.dtype

    def rnd(t):
        return t.to(dt).float()

    def split_sum(a, w, parts):
        kc = a.shape[1] // parts
        out = None
        for s in range(parts):
            cols = slice(s * kc, (s + 1) * kc)
            part = a[:, cols] @ w[:, cols].float().t()
            out = part if out is None else out + part
        return out

    x = x.float()
    k_out, v_out = [], []
    for i in range(n_layers):
        h = rnd(AD._ln(x, p.ln1_w[i], p.ln1_b[i]))
        qkv = h @ p.w_qkv[i].float().t() + p.b_qkv[i]
        q = qkv[:, :d] * (hd ** -0.5)
        k_new, v = qkv[:, d:2 * d].to(dt), qkv[:, 2 * d:]
        qh = q.view(b, heads, hd)
        s_cur = (qh * k_new.float().view(b, heads, hd)).sum(-1)
        kc = cache_k[i, :, :pos].float().view(b, pos, heads, hd)
        vc = cache_v[i, :, :pos].float().view(b, pos, heads, hd)
        sc = torch.einsum('bhd,bjhd->bhj', rnd(qh), kc)
        m = torch.maximum(s_cur, sc.amax(-1)) if pos else s_cur
        p_cur = torch.exp(s_cur - m)
        p_row = torch.exp(sc - m[..., None])
        acc = (p_cur[..., None] * v.view(b, heads, hd)
               + torch.einsum('bhj,bjhd->bhd', rnd(p_row), vc))
        ctx = rnd((acc / (p_cur + p_row.sum(-1))[..., None]).reshape(b, d))
        x = x + (ctx @ p.w_out[i].float().t() + p.b_out[i])
        h2 = rnd(AD._ln(x, p.ln2_w[i], p.ln2_b[i]))
        f = h2 @ p.w_fc[i].float().t() + p.b_fc[i]
        g = rnd(f * torch.sigmoid(1.702 * f))
        x = (x + split_sum(g, p.w_proj[i], 4)) + p.b_proj[i]
        k_out.append(k_new)
        v_out.append(v.to(dt))
    return x, torch.stack(k_out), torch.stack(v_out)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['float32', 'bfloat16'])
@pytest.mark.parametrize('d,heads', [(64, 2), (128, 2)],
                         ids=['hd32', 'hd64'])
@pytest.mark.parametrize('pos', [1, 128, 255, 0])
def test_decode_step_reference_matches_jax_kernel(dtype, d, heads, pos):
    blocks = _weights(d, seed=d + pos)
    x, ck, cv = _step_inputs(d, dtype, seed=pos)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jdec.decode_token_step(
        jnp.asarray(x), _jax_stacked(blocks, dtype),
        jnp.asarray(ck.float().numpy()).astype(jdt),
        jnp.asarray(cv.float().numpy()).astype(jdt), pos, heads,
        interpret=True)
    got = AD.decode_token_step_reference(
        torch.from_numpy(x), _port_params(blocks, dtype), ck, cv, pos, heads)
    tol = TOL[str(dtype).split('.')[-1]]
    assert got[0].dtype == torch.float32 and got[1].dtype == dtype
    for name, g, w in zip(('y', 'k_new', 'v_new'), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w).astype(np.float32),
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['float32', 'bfloat16'])
@pytest.mark.parametrize('d,heads', [(96, 3), (128, 2)],
                         ids=['hd32', 'hd64'])
@pytest.mark.parametrize('b,pos', [(1, 0), (1, 255), (5, 1), (5, 128),
                                   (2, 200)])
def test_stream_kernel_order_matches_jax_kernel(dtype, d, heads, b, pos):
    """The streaming kernel's arithmetic (its fixed order of split-K
    sums, emulated on the CPU) against the JAX kernel in interpret mode,
    at the tolerance of test_decode_step_reference_matches_jax_kernel."""
    blocks = _weights(d, seed=d + pos + b)
    x, ck, cv = _step_inputs(d, dtype, seed=pos + 7 * b, b=b)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jdec.decode_token_step(
        jnp.asarray(x), _jax_stacked(blocks, dtype),
        jnp.asarray(ck.float().numpy()).astype(jdt),
        jnp.asarray(cv.float().numpy()).astype(jdt), pos, heads,
        interpret=True)
    got = _stream_order_step(torch.from_numpy(x),
                             _port_params(blocks, dtype), ck, cv, pos,
                             heads)
    tol = TOL[str(dtype).split('.')[-1]]
    for name, g, w in zip(('y', 'k_new', 'v_new'), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w).astype(np.float32),
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize('dtype,d,pos,stream_ok', [
    (torch.bfloat16, 768, 370, True),     # ART-V's step
    (torch.bfloat16, 1024, 4096, True),
    (torch.bfloat16, 768, 5000, False),   # beyond the streaming logits
    (torch.bfloat16, 1280, 0, False),     # beyond an LN row in registers
    (torch.float32, 768, 370, False)])    # the streaming kernel is bf16
def test_decode_kernel_rule(dtype, d, pos, stream_ok):
    """The shapes each CUDA kernel takes: the phased one (the default)
    every one here, the streaming one (taken only when asked for) bf16 with
    D <= 1024 and pos <= 4096; the others raise before a launch."""
    args = (12, 16, 8192, d, dtype, pos, d // 64)
    AD._check_shape(*args, 'phased')
    if stream_ok:
        AD._check_shape(*args, 'stream')
    else:
        with pytest.raises(ValueError, match='streaming'):
            AD._check_shape(*args, 'stream')


def test_stream_kernel_stamps_rise_across_layouts():
    """The streaming kernel's first stamp grows by n_layers a call on one
    (device, stream), whatever the layout, so no flag an earlier call left
    holds a stamp a later call waits for; the flags start zeroed, are
    zeroed anew when they grow, and before the stamp would pass 2^32;
    another stream has its own flags and stamps."""
    dev = torch.device('cpu')
    AD._sync.clear()
    stamps = []
    for words, n_layers in ((100, 12), (50, 1), (50, 1), (100, 12)):
        buf, stamp0 = AD._stream_sync(dev, 1, words, n_layers)
        stamps.append(stamp0)
    assert stamps == [0, 12, 13, 14]
    assert buf.numel() >= 100 and not buf.any()
    buf[:] = 7
    grown, stamp0 = AD._stream_sync(dev, 1, 10 ** 4, 1)
    assert stamp0 == 0 and grown.numel() >= 10 ** 4 and not grown.any()
    assert AD._stream_sync(dev, 2, 100, 12)[1] == 0
    AD._sync[(dev, 1)] = (grown.fill_(5), 2 ** 32 - 13)
    assert AD._stream_sync(dev, 1, 100, 12)[1] == 2 ** 32 - 13  # to 2^32-1
    buf, stamp0 = AD._stream_sync(dev, 1, 100, 12)
    assert stamp0 == 0 and not buf.any()
    AD._sync.clear()


def test_decode_wrapper_takes_plain_on_cpu(monkeypatch):
    """On a CPU tensor the wrapper is the plain version, no launch
    counted; rows >= pos of the caches are never read."""
    monkeypatch.setattr(AD, 'launches', 0)
    d = 64
    p = _port_params(_weights(d, 0), torch.float32)
    x, ck, cv = _step_inputs(d, torch.float32, 0)
    x = torch.from_numpy(x)
    got = AD.decode_token_step(x, p, ck, cv, 100, 2)
    want = AD.decode_token_step_reference(x, p, ck, cv, 100, 2)
    assert AD.launches == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ck[:, :, 100:] = float('nan')
    cv[:, :, 100:] = float('nan')
    again = AD.decode_token_step(x, p, ck, cv, 100, 2)
    for g, w in zip(again, want):
        assert torch.equal(g, w)


def test_stack_decode_params_layout():
    """DecodeParams from ResidualAttentionBlocks: [L, ...] stacks in the
    Linear layout, weights in the blocks' dtype, the rest fp32."""
    from mmvid_tpu_torch.models.clip import ResidualAttentionBlock
    blocks = [ResidualAttentionBlock(64, 2, dtype=torch.bfloat16)
              for _ in range(3)]
    p = AD.stack_decode_params(blocks)
    assert p.w_qkv.shape == (3, 192, 64) and p.w_proj.shape == (3, 64, 256)
    assert p.w_fc.dtype == torch.bfloat16 and p.b_fc.dtype == torch.float32
    assert p.ln2_w.shape == (3, 64) and p.ln2_w.dtype == torch.float32
    assert torch.equal(p.w_out[1], blocks[1].attn.out_proj.weight)
    assert all(t.is_contiguous() for t in p)


def test_gridstep_plain_matches_formula(monkeypatch):
    """The probe's call: 12 chained x <- x + (bf16(x) @ W[l, 0]) * 1e-3,
    against numpy in float64 on the same bf16-rounded operands; on a CPU
    tensor the wrapper is the plain version, no launch counted."""
    monkeypatch.setattr(G, 'launches', 0)
    gen = torch.Generator().manual_seed(0)
    x, w = G.probe_inputs(gen)
    assert x.shape == (16, 768) and w.shape == (12, 3, 768, 768)
    wt = G.prepare_weights(w)
    got = G.probe(x, wt, launches_per_call=12, calls=2)
    assert G.launches == 0
    want = x.double().numpy()
    for _ in range(2):
        for layer in w[:, 0].double().numpy():
            xr = torch.from_numpy(want).to(torch.bfloat16).double().numpy()
            want = want + (xr @ layer) * 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
