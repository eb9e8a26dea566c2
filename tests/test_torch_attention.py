"""Port's attention (mmvid_tpu_torch.ops.attention) vs the JAX package.

The plain version is held against JAX's ``_attention_xla`` and against the
Pallas kernel in interpret mode, for the causal and mask_prev masks, at the
tiny config's shape (L=139, 2 heads of 32).  fp32: tolerance 2e-5, as
tests/test_attention_pallas.py uses for the same function (sums in another
order).  bf16, with ``MMVID_ATTN_BF16`` unset and set (JAX's bf16_av
variant): one bf16 ulp of max(|out|, 1) (the Pallas kernel rounds q *
scale to bf16, the port scales in fp32; one output rounding may flip).

A CPU emulation of the tensor-core kernel's arithmetic (csrc/
attention_sm90.cu: 128-row query tiles, 64-key tiles, online softmax in
base 2, P split into bf16 P_hi + P_lo, or bf16 P) is held against
``_attention_xla`` at the mask-predict paths' sequences, which checks the
design's numerics without the card.  The CUDA kernels are held against the
plain version on the card only, in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmvid_tpu.models.clip import build_attention_mask as jax_mask
from mmvid_tpu.ops.attention import _attention_xla
from mmvid_tpu.ops.attention import fused_attention_blhd as jax_fused
from mmvid_tpu_torch.models.clip import build_attention_mask
from mmvid_tpu_torch.ops import attention as A

TOL = 2e-5
LOG2E = 1.4426950408889634


def bf16_ulp(x):
    """One bf16 ulp at the larger of |x| and 1 (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1.0))) - 7)


def _bf16_qkv(seed, b, l, h, d):
    """fp32 randn from numpy rounded to bf16, as torch and as jax arrays."""
    rng = np.random.RandomState(seed)
    xs = [rng.randn(b, l, h, d).astype(np.float32) for _ in range(3)]
    return ([torch.from_numpy(x).bfloat16() for x in xs],
            [jnp.asarray(x).astype(jnp.bfloat16) for x in xs])


def kernel_emulation(q, k, v, mask, bf16_probs=False):
    """The tensor-core kernel's arithmetic on the CPU: q, k, v bf16 [B, L,
    H, D], mask fp32 [L, L] -> bf16 [B, L, H, D].  Query tiles of 128 rows,
    key tiles of 64 (keys >= L: zero K/V rows, logit -inf), S = Q.K^T in
    fp32 from bf16 operands, logits in base 2 (scale and mask times
    log2(e)), an online softmax, P.V with fp32 sums from bf16 P_hi and
    P_lo = bf16(P - P_hi) (or P_hi alone), the fp32 row sums at the end."""
    b, l, h, d = q.shape
    scale_log2 = np.float32(d ** -0.5) * np.float32(LOG2E)
    lp = -(-l // 64) * 64
    qf = q.float().permute(0, 2, 1, 3)
    kf, vf = (torch.nn.functional.pad(t.float().permute(0, 2, 1, 3),
                                      (0, 0, 0, lp - l)) for t in (k, v))
    mp = torch.full((l, lp), -np.inf)
    mp[:, :l] = mask * LOG2E
    out = torch.empty((b, h, l, d))
    for r0 in range(0, l, 128):
        qt = qf[:, :, r0:r0 + 128]
        m = torch.full(qt.shape[:3], -np.inf)
        lsum = torch.zeros(qt.shape[:3])
        o = torch.zeros(qt.shape)
        for k0 in range(0, lp, 64):
            x = (qt @ kf[:, :, k0:k0 + 64].transpose(-1, -2) * scale_log2
                 + mp[r0:r0 + 128, k0:k0 + 64])
            mx = torch.maximum(m, x.amax(-1))
            m_use = torch.where(mx == -np.inf, torch.zeros(()), mx)
            alpha = torch.exp2(m - m_use)
            p = torch.exp2(x - m_use[..., None])
            lsum = lsum * alpha + p.sum(-1)
            p_hi = p.bfloat16().float()
            vt = vf[:, :, k0:k0 + 64]
            o = o * alpha[..., None] + p_hi @ vt
            if not bf16_probs:
                o = o + (p - p_hi).bfloat16().float() @ vt
            m = mx
        out[:, :, r0:r0 + 128] = o / lsum[..., None]
    return out.permute(0, 2, 1, 3).bfloat16()


def _qkv(seed, b=2, l=139, h=2, d=32):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, l, h, d).astype(np.float32) for _ in range(3)]


def _masks(kind, l):
    idx = (9, 10) if kind == 'mask_prev' else None
    return (np.asarray(jax_mask(l, kind, index=idx)),
            build_attention_mask(l, kind, index=idx))


@pytest.mark.parametrize('kind', ['causal', 'mask_prev'])
def test_mask_matches_jax(kind):
    m_jax, m_port = _masks(kind, 139)
    np.testing.assert_array_equal(m_port.numpy(), m_jax)


@pytest.mark.parametrize('kind', ['causal', 'mask_prev'])
def test_plain_matches_jax_xla_and_pallas_interpret(kind):
    q, k, v = _qkv(0)
    m_jax, m_port = _masks(kind, q.shape[1])
    scale = q.shape[-1] ** -0.5
    want_xla = np.asarray(_attention_xla(*map(jnp.asarray, (q, k, v)),
                                         jnp.asarray(m_jax), scale))
    want_pallas = np.asarray(jax_fused(*map(jnp.asarray, (q, k, v)),
                                       jnp.asarray(m_jax), interpret=True))
    got = A.attention_reference(*map(torch.from_numpy, (q, k, v)), m_port,
                                scale).numpy()
    np.testing.assert_allclose(got, want_xla, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_pallas, rtol=TOL, atol=TOL)


def test_cpu_dispatch_takes_plain_path_and_strided_views():
    """A CPU tensor goes to the plain version (no launch counted), also for
    q/k/v that are strided views of one packed projection."""
    b, l, h, d = 2, 139, 2, 32
    rng = np.random.RandomState(1)
    qkv = torch.from_numpy(rng.randn(b, l, 3 * h * d).astype(np.float32))
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, l, h, d)
               for i in range(3))
    mask = build_attention_mask(l, 'mask_prev', index=(9, 10))
    before = A.launches
    out = A.fused_attention_blhd(q, k, v, mask)
    assert A.launches == before
    want = A.attention_reference(q.contiguous(), k.contiguous(),
                                 v.contiguous(), mask, d ** -0.5)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_no_plain_fallback_on_other_devices():
    """Only a CPU tensor takes the plain path; any other device launches
    the kernel or raises."""
    q = torch.empty((1, 8, 2, 32), device='meta')
    before = A.launches
    with pytest.raises(ValueError, match='no attention path'):
        A.fused_attention_blhd(q, q, q)
    assert A.launches == before


@pytest.mark.parametrize('bf16_probs', [False, True],
                         ids=['default', 'MMVID_ATTN_BF16'])
def test_bf16_variants_match_jax_pallas_interpret(monkeypatch, bf16_probs):
    """bf16 q, k, v at the tiny shape, mask_prev: the port's dispatch on a
    CPU tensor (the plain version of the variant the flag selects) against
    JAX's Pallas kernel in interpret mode under the same flag, within one
    bf16 ulp of max(|out|, 1)."""
    if bf16_probs:
        monkeypatch.setenv('MMVID_ATTN_BF16', '1')
    else:
        monkeypatch.delenv('MMVID_ATTN_BF16', raising=False)
    (q, k, v), (jq, jk, jv) = _bf16_qkv(2, 2, 139, 2, 32)
    m_jax, m_port = _masks('mask_prev', 139)
    want = np.asarray(jax_fused(jq, jk, jv, jnp.asarray(m_jax),
                                interpret=True).astype(jnp.float32))
    got = A.fused_attention_blhd(q, k, v, m_port)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - want) <= bf16_ulp(want)).all()
    plain = A.attention_reference(q, k, v, m_port, 32 ** -0.5, bf16_probs)
    np.testing.assert_array_equal(got, plain.float().numpy())


@pytest.mark.parametrize('dtype,l,h,d,idx', [
    ('float32', 29, 2, 64, (5,)), ('float32', 139, 2, 32, (9, 10)),
    ('bfloat16', 77, 2, 64, (5, 6)), ('bfloat16', 139, 2, 32, (9, 10))])
def test_int8_variant_matches_jax_pallas_interpret(monkeypatch, dtype, l, h,
                                                   d, idx):
    """MMVID_ATTN_INT8=1: the port's dispatch on a CPU tensor (the plain
    attention_int8_reference) against JAX's int8 Pallas kernel in interpret
    mode, at ragged L (JAX pads to 16 rows, the port masks nothing of it)
    with mask_prev rows.  The integers are the same, so bf16 outputs are
    equal and fp32 outputs differ only by the row sum's order (2e-6, against
    the 0.05 that tests/test_attention_pallas.py allows int8 from fp32);
    MMVID_ATTN_BF16=1 beside it changes nothing, as in JAX, where int8_qk
    is checked first."""
    from mmvid_tpu_torch.ops import attention_int8 as A8
    monkeypatch.setenv('MMVID_ATTN_INT8', '1')
    monkeypatch.setenv('MMVID_ATTN_BF16', '1')
    rng = np.random.RandomState(l)
    q, k, v = (rng.randn(2, l, h, d).astype(np.float32) for _ in range(3))
    mask = build_attention_mask(l, 'mask_prev', index=idx)
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    want = np.asarray(jax_fused(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
        jnp.asarray(mask.numpy()), interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    before = A8.launches
    got = A.fused_attention_blhd(tq, tk, tv, mask)
    assert got.dtype == tq.dtype and A8.launches == before
    got = got.float().numpy()
    if dtype == 'bfloat16':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(got, A8.attention_int8_reference(
        tq, tk, tv, mask, d ** -0.5).float().numpy())
    fp = A.attention_reference(tq, tk, tv, mask, d ** -0.5).float().numpy()
    assert np.abs(got - fp).max() > 100 * max(np.abs(got - want).max(),
                                              1e-7)


def test_int8_variant_on_other_devices_raises(monkeypatch):
    """MMVID_ATTN_INT8=1 on a device that is neither the CPU nor CUDA: no
    plain fallback."""
    from mmvid_tpu_torch.ops import attention_int8 as A8
    monkeypatch.setenv('MMVID_ATTN_INT8', '1')
    q = torch.empty((1, 8, 2, 32), device='meta')
    before = A8.launches
    with pytest.raises(ValueError, match='no int8 attention path'):
        A.fused_attention_blhd(q, q, q)
    assert A8.launches == before


@pytest.mark.parametrize('l,idx', [(565, (51, 52)), (629, (115, 116))],
                         ids=['flagship', 'text_mask'])
def test_kernel_emulation_matches_jax_xla(l, idx):
    """The kernel's tiled arithmetic at the mask-predict sequences (B 2, 3
    heads of 64, bf16, mask_prev) against JAX's ``_attention_xla``: within
    one bf16 ulp of max(|out|, 1), and with the P_hi + P_lo split at most
    1% of the bf16 outputs differ (bf16 P moves about 40%: it is held to
    the ulp bound, and to the port's plain version of that variant)."""
    (q, k, v), (jq, jk, jv) = _bf16_qkv(3, 2, l, 3, 64)
    m_jax, m_port = (np.asarray(jax_mask(l, 'mask_prev', index=idx)),
                     build_attention_mask(l, 'mask_prev', index=idx))
    want = np.asarray(_attention_xla(jq, jk, jv, jnp.asarray(m_jax),
                                     64 ** -0.5).astype(jnp.float32))
    split = kernel_emulation(q, k, v, m_port).float().numpy()
    assert (np.abs(split - want) <= bf16_ulp(want)).all()
    assert np.mean(split != want) <= 0.01
    bf16p = kernel_emulation(q, k, v, m_port, bf16_probs=True).float().numpy()
    assert (np.abs(bf16p - want) <= bf16_ulp(want)).all()
    plain = A.attention_reference(q, k, v, m_port, 64 ** -0.5,
                                  bf16_probs=True).float().numpy()
    assert (np.abs(bf16p - plain) <= bf16_ulp(plain)).all()
