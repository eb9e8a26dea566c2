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
design's numerics without the card; so is one of the int8 kernel's
arithmetic (csrc/attention_int8_sm90.cu: the operand pass, 64-key tiles
of s8 sums, the mask's compact form, the kernel's order of the row sums)
against JAX's int8 kernel in interpret mode; and one of the fp32
kernel's (csrc/attention_fp32_sm90.cu: 64-key tiles, one FFMA chain a
logit, the online rescale per tile, per-lane partial row sums, bf16 P
under MMVID_ATTN_BF16) against ``_attention_xla`` and the Pallas kernel in
interpret mode at the paths' sequences.  The fp32 route's alignment
checks are held on the views every caller passes.  The compact form that
models/clip.py builds beside every mask is held equal to the dense mask.
The CUDA kernels are held against the plain version on the card only, in
tests/test_torch_kernels.py.
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


def kernel_emulation(q, k, v, mask, bf16_probs=False, fp32_out=False):
    """The tensor-core kernel's arithmetic on the CPU: q, k, v bf16 [B, L,
    H, D], mask fp32 [L, L] -> bf16 [B, L, H, D] (``fp32_out``: the fp32
    output before its rounding, of which the kernel writes the rest for
    the backward when grad is on).  Query tiles of 128 rows,
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
    out = out.permute(0, 2, 1, 3)
    return out if fp32_out else out.bfloat16()


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


def _fma(a, b, c):
    """fp32 a * b + c with one rounding (FFMA): the product is exact in
    fp64, the sum rounded there and then to fp32 (a double rounding that
    can move the last bit in rare ties)."""
    return (a.double() * b.double() + c.double()).float()


def fp32_kernel_emulation(q, k, v, mask):
    """csrc/attention_fp32_sm90.cu's arithmetic on the CPU: q, k, v fp32
    [B, L, H, D], mask fp32 [L, L] -> (out, out with bf16 P), fp32 [B, L,
    H, D].  q * scale in fp32; each logit one FFMA chain over d in order,
    plus the mask; 64-key tiles (keys >= L: logit -inf).  Per tile: m' =
    max(m, the tile's row max), alpha = exp2(fma(m, log2e, -m' log2e)), p
    = exp2(fma(x, log2e, -m' log2e)); each of the 16 lanes of a row sums
    its keys of the tile (cg + 16 j, j in order) and keeps fma(l, alpha,
    sum); O = alpha O, then one FFMA a key in order, P rounded to bf16 for
    the second output (MMVID_ATTN_BF16=1).  At the end the lanes' sums meet
    by the shuffles' pairwise tree, and O / l."""
    b, l, h, d = q.shape
    f32 = torch.float32
    log2e = torch.tensor(LOG2E, dtype=f32)
    n_tiles = -(-l // 64)
    lp = 64 * n_tiles
    # _fma's operands in fp64 once (exact: fp32 values)
    qs = (q * torch.tensor(d ** -0.5, dtype=f32)).permute(0, 2, 1, 3).double()
    kp, vp = (torch.nn.functional.pad(t.permute(0, 2, 1, 3),
                                      (0, 0, 0, lp - l)).double()
              for t in (k, v))
    s = torch.zeros((b, h, l, lp), dtype=f32)
    for i in range(d):
        s = _fma(qs[..., i, None], kp[..., None, :, i], s)
    x = s + torch.nn.functional.pad(mask, (0, lp - l))
    x[..., l:] = -np.inf
    m = torch.full((b, h, l), -np.inf, dtype=f32)
    lsum = torch.zeros((b, h, l, 16), dtype=f32)
    o = torch.zeros((2, b, h, l, d), dtype=f32)  # fp32 P, bf16 P
    for j in range(n_tiles):
        xt = x[..., 64 * j:64 * j + 64]
        m_new = torch.maximum(m, xt.amax(-1))
        m_log2 = m_new * log2e
        alpha = torch.exp2(_fma(m, log2e, -m_log2))
        p = torch.exp2(_fma(xt, log2e, -m_log2[..., None]))
        lanes = p.view(b, h, l, 4, 16)
        psum = lanes[..., 0, :]
        for c in range(1, 4):
            psum = psum + lanes[..., c, :]
        lsum = _fma(lsum, alpha[..., None], psum)
        vt = vp[..., 64 * j:64 * j + 64, :]
        pn = torch.stack((p.double(), p.bfloat16().double()))
        o = o * alpha[..., None]
        for c in range(64):
            o = _fma(pn[..., c, None], vt[..., c, None, :], o)
        m = m_new
    while lsum.shape[-1] > 1:
        lsum = lsum[..., 0::2] + lsum[..., 1::2]
    return tuple((on / lsum).permute(0, 2, 1, 3) for on in o)


@pytest.fixture
def one_thread():
    """torch's pool at one thread: small ops run as fast in one, and do
    not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize('b,l,h,d,kind,idx', [
    (2, 565, 3, 64, 'mask_prev', (51, 52)),
    (2, 629, 3, 64, 'mask_prev', (115, 116)),
    (2, 139, 2, 32, 'mask_prev', (9, 10)),
    (1, 626, 2, 64, 'causal', None)],
    ids=['flagship_L565', 'text_mask_L629', 'tiny_L139_D32', 'causal_L626'])
def test_fp32_kernel_emulation_matches_jax(monkeypatch, one_thread, b, l, h,
                                           d, kind, idx):
    """The fp32 kernel's tiled arithmetic (fp32_kernel_emulation) against
    JAX's ``_attention_xla`` and its Pallas kernel in interpret mode, fp32,
    on inputs from numpy: within 1e-5 abs (sums in another order; JAX's two
    lie 5e-7 apart at L629), and the port's plain version likewise.  With
    bf16 P (MMVID_ATTN_BF16=1): within one bf16 ulp of max(|out|, 1) of
    JAX's Pallas kernel under the same flag, and of the plain version of
    that variant (the kernel rounds exp(logit - running max), JAX exp(logit
    - row max))."""
    rng = np.random.RandomState(l + d)
    q, k, v = (rng.randn(b, l, h, d).astype(np.float32) for _ in range(3))
    m_jax = np.asarray(jax_mask(l, kind, index=idx))
    m_port = build_attention_mask(l, kind, index=idx)
    np.testing.assert_array_equal(m_port.numpy(), m_jax)
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, m_jax))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got, got_bf16p = (o.numpy() for o in fp32_kernel_emulation(
        tq, tk, tv, m_port))
    monkeypatch.delenv('MMVID_ATTN_BF16', raising=False)
    want_xla = np.asarray(_attention_xla(jq, jk, jv, jm, d ** -0.5))
    want_pallas = np.asarray(jax_fused(jq, jk, jv, jm, interpret=True))
    plain = A.attention_reference(tq, tk, tv, m_port, d ** -0.5).numpy()
    for want in (want_xla, want_pallas, plain):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    monkeypatch.setenv('MMVID_ATTN_BF16', '1')
    want = np.asarray(jax_fused(jq, jk, jv, jm, interpret=True))
    plain = A.attention_reference(tq, tk, tv, m_port, d ** -0.5,
                                  bf16_probs=True).numpy()
    for want in (want, plain):
        assert (np.abs(got_bf16p - want) <= bf16_ulp(want)).all()
    # the variant is another function: bf16 P moves the outputs by more
    # than the fp32 tolerance
    assert np.abs(got_bf16p - got).max() > 1e-4


# every mask a path builds, as (size, kind, index, length, pad_to):
# mask_prev at the flagship's and text+mask's sequences, causal (ART-V's
# forward, and its slice to 625), the padded layout of calibration (key
# and row padding to a multiple of 64), the tiny config's
MASKS = [(565, 'mask_prev', (51, 52), None, None),
         (629, 'mask_prev', (115, 116), None, None),
         (626, 'causal', None, None, None),
         (626, 'causal', None, 625, None),
         (565, 'mask_prev', (51, 52), None, 576),
         (139, 'mask_prev', (9, 10), None, 192),
         (139, 'mask_prev', (9, 10), 77, None),
         (139, 'causal', None, None, None)]


@pytest.mark.parametrize('size,kind,idx,length,pad_to', MASKS)
def test_compact_mask_equals_dense(size, kind, idx, length, pad_to):
    """The compact form that models/clip.py::attention_mask builds beside
    each dense mask stands for it element by element, also sliced
    [:l, :l] (MultiHeadAttention.attend's slice), and equals what
    compact_mask reads off the dense values."""
    from mmvid_tpu_torch.models.clip import NEG_INF, attention_mask
    from mmvid_tpu_torch.ops import attention_int8 as A8
    m = attention_mask(size, kind, index=idx, length=length, pad_to=pad_to,
                       device=torch.device('cpu'))
    n = pad_to or length or size
    assert m.dense.shape == (n, n)
    assert set(torch.unique(m.dense).tolist()) <= {0.0, NEG_INF}
    assert (m.compact.c0, m.compact.c1) == (0.0, NEG_INF)
    assert m.compact.bits.dtype == torch.int32
    assert m.compact.bits.shape == (n, A8.mask_words(n))
    assert torch.equal(m.compact.dense(), m.dense)
    read = A8.compact_mask(m.dense)
    assert torch.equal(read.bits, m.compact.bits)
    want = np.asarray(jax_mask(size, kind, index=idx))[:length, :length]
    if pad_to:
        want = np.pad(want, ((0, pad_to - want.shape[0]),) * 2,
                      constant_values=NEG_INF)
    np.testing.assert_array_equal(m.dense.numpy(), want)
    for l in {1, 31, 32, 33, 64, 127, 128, 129, n - 1} & set(range(n)):
        s = A.slice_mask(m, l)
        assert torch.equal(s.dense, m.dense[:l, :l])
        assert s.compact.bits.shape == (l, A8.mask_words(l))
        assert torch.equal(s.compact.dense(), m.dense[:l, :l])


def test_compact_mask_refuses_a_third_value():
    """compact_mask holds two values; a mask with three raises."""
    from mmvid_tpu_torch.ops import attention_int8 as A8
    mask = torch.zeros((40, 40))
    mask[3, :2] = -1e9
    mask[7, 5] = -3.0
    with pytest.raises(ValueError, match='two values, not 3'):
        A8.compact_mask(mask)
    one = A8.compact_mask(torch.zeros((40, 40)))
    assert one.c0 == one.c1 == 0.0 and not one.bits.any()
    assert torch.equal(one.dense(), torch.zeros((40, 40)))


def int8_kernel_emulation(q, k, v, compact, scale):
    """csrc/attention_int8_sm90.cu's arithmetic on the CPU: q, k, v [B, L,
    H, D], the mask's compact form -> [B, L, H, D] in q's dtype.  The
    operand pass (per-(batch, head) abs-max scales, q scaled in its dtype,
    int8 Q, K, V padded with zero rows to a multiple of 64 keys); S tile by
    tile of 64 keys, each the sum of 32-deep s8 products (exact integers);
    logits from the bits' two values; keys >= L out of the row max and
    with p = 0; p8 = rint(p * 127); O = P8 . V8 in integers; each of the
    four threads of a row sums its keys (2t, 2t + 1 of every 8) in the
    kernel's order, then (d0 + d1) + (d2 + d3); out = O * (vs / 127) /
    denom."""
    b, l, h, d = q.shape
    lp = -(-l // 64) * 64
    tiles = lp // 64

    def operands(x):
        s = torch.clamp_min(x.abs().amax(dim=(1, 3)), 1e-8) / 127.0
        x8 = torch.round(x / s[:, None, :, None]).long()
        return (torch.nn.functional.pad(x8.permute(0, 2, 1, 3),
                                        (0, 0, 0, lp - l)), s)

    q8, qs = operands((q * torch.tensor(scale, dtype=q.dtype)).float())
    k8, ks = operands(k.float())
    v8, vs = operands(v.float())
    qsks = (qs * ks)[..., None, None]                        # [B, H, 1, 1]
    s_int = torch.zeros((b, h, lp, lp), dtype=torch.int64)
    for j in range(tiles):
        keys = slice(64 * j, 64 * j + 64)
        for kk in range(0, 64, 32):
            s_int[..., keys] += torch.einsum(
                'bhld,bhmd->bhlm', q8[..., kk:kk + 32], k8[:, :, keys,
                                                          kk:kk + 32])
    bits = compact.dense()
    mval = torch.nn.functional.pad(bits, (0, lp - l, 0, lp - l))
    logits = s_int.float() * qsks + mval
    valid = torch.arange(lp) < l
    logits = torch.where(valid, logits, torch.tensor(-np.inf))
    mx = logits.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - mx), torch.zeros(()))
    p8 = torch.round(p * 127.0)
    o = torch.einsum('bhlm,bhmd->bhld', p8.long(), v8)
    # [B, H, Lp, tiles, i, t, e] -> per t, keys in (tile, i, e) order
    parts = p.view(b, h, lp, tiles, 8, 4, 2).permute(0, 1, 2, 5, 3, 4, 6)
    parts = parts.reshape(b, h, lp, 4, tiles * 16)
    den = torch.zeros((b, h, lp, 4))
    for i in range(parts.shape[-1]):
        den = den + parts[..., i]
    den = (den[..., 0] + den[..., 1]) + (den[..., 2] + den[..., 3])
    out = o.float() * (vs / 127.0)[..., None, None] / den[..., None]
    return out[:, :, :l].permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize('dtype,l,h,d,kind,idx', [
    ('float32', 29, 2, 64, 'mask_prev', (5,)),
    ('float32', 139, 2, 32, 'causal', None),
    ('bfloat16', 139, 2, 32, 'mask_prev', (9, 10)),
    ('bfloat16', 200, 2, 64, 'mask_prev', (51, 52)),
    ('bfloat16', 130, 1, 64, 'causal', None)])
def test_int8_kernel_emulation_matches_jax_pallas_interpret(
        monkeypatch, dtype, l, h, d, kind, idx):
    """The int8 kernel's arithmetic (int8_kernel_emulation: the operand
    pass, 64-key tiles of s8 sums, the compact mask, the kernel's order of
    the row sums) against JAX's int8 Pallas kernel in interpret mode,
    under the same flag.  fp32 within 2e-6 (the row sums' order), as the
    plain version is held.  bf16: equal to the port's plain version, and
    equal to JAX's but where an fp32 last-bit difference (XLA's exp
    against torch's, or a row sum's order) moves one p8 rounding or the
    output's bf16 rounding: at most one bf16 ulp there, on at most 0.1% of
    the outputs (the plain version itself differs from JAX's in 2 of the
    17792 outputs of the L 139 case)."""
    from mmvid_tpu_torch.models.clip import attention_mask
    from mmvid_tpu_torch.ops import attention_int8 as A8
    monkeypatch.setenv('MMVID_ATTN_INT8', '1')
    rng = np.random.RandomState(l + 1)
    q, k, v = (rng.randn(2, l, h, d).astype(np.float32) for _ in range(3))
    m = attention_mask(l, kind, index=idx, device=torch.device('cpu'))
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    want = np.asarray(jax_fused(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
        jnp.asarray(m.dense.numpy()), interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    got = int8_kernel_emulation(tq, tk, tv, m.compact, d ** -0.5)
    assert got.dtype == tq.dtype
    got = got.float().numpy()
    if dtype == 'bfloat16':
        np.testing.assert_array_equal(got, A8.attention_int8_reference(
            tq, tk, tv, m.dense, d ** -0.5).float().numpy())
        assert (np.abs(got - want) <= bf16_ulp(want)).all()
        assert np.mean(got != want) <= 1e-3
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def _rn32(value):
    """The float32 nearest to an exact Fraction, ties to even."""
    from fractions import Fraction
    c = np.float32(float(value))
    cands = (c, np.nextafter(c, np.float32(np.inf)),
             np.nextafter(c, np.float32(-np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - value),
                                     int(np.float32(v).view(np.uint32)) & 1))


def test_int8_quantize_without_division_is_exact():
    """The int8 kernel's operand pass takes x / s as Markstein's correction
    of x * RN(1 / s): q = RN(x * y), r = x - q * s (one fma, exact), then
    RN(q + r * y) (one fma), which is RN(x / s), the quotient the plain
    version rounds.  Checked with exact rationals on random scales and on
    quotients a few ulps from a half-integer (where rint would flip)."""
    from fractions import Fraction as Fr
    rng = np.random.RandomState(0)
    for trial in range(3000):
        m = np.float32(10 ** rng.uniform(-3, 2))
        s = _rn32(Fr(float(max(m, np.float32(1e-8)))) / 127)
        y = _rn32(1 / Fr(float(s)))
        if trial % 2:
            half = Fr(int(rng.randint(-127, 127))) + Fr(1, 2)
            x = _rn32(half * Fr(float(s))
                      * (1 + Fr(int(rng.randint(-4, 5)), 2 ** 24)))
        else:
            x = np.float32(rng.uniform(-1, 1) * m)
        fx, fs, fy = Fr(float(x)), Fr(float(s)), Fr(float(y))
        q = _rn32(fx * fy)
        r = _rn32(fx - Fr(float(q)) * fs)
        got = _rn32(Fr(float(q)) + Fr(float(r)) * fy)
        assert got == _rn32(fx / fs), (x, s)


def _views(b, l, h, d, offset_floats=0):
    """q, k, v as views of one packed [B, L, 3 * H * D] fp32 projection,
    their bases moved by ``offset_floats`` elements; mask_prev rows."""
    flat = torch.zeros(b * l * 3 * h * d + offset_floats)
    qkv = flat[offset_floats:].view(b, l, 3 * h * d)
    return ([qkv[..., i * h * d:(i + 1) * h * d].view(b, l, h, d)
             for i in range(3)], build_attention_mask(l, 'mask_prev',
                                                       index=(9, 10)))


def test_fp32_route_refuses_misaligned_views():
    """The fp32 kernel copies 16-byte chunks: the card path checks q, k,
    v (16-byte aligned bases, batch / row / head strides that are
    multiples of 4) and the mask's base before a launch.  The packed views
    pass; a base moved by one float, a row stride not a multiple of 4, or
    a mask whose base is moved by one float raise."""
    (q, k, v), mask = _views(2, 139, 2, 32)
    A._check_cuda_args(q, k, v, mask)
    (q1, k1, v1), _ = _views(2, 139, 2, 32, offset_floats=1)
    with pytest.raises(ValueError, match='16-byte aligned base'):
        A._check_cuda_args(q1, k1, v1, mask)
    odd = torch.zeros(2, 139, 2 * 32 * 3 + 2)[..., :64].view(2, 139, 2, 32)
    with pytest.raises(ValueError, match='multiples of 4'):
        A._check_cuda_args(odd, odd, odd, mask)
    shifted = torch.zeros(139 * 139 + 1)[1:].view(139, 139)
    shifted.copy_(mask)
    with pytest.raises(ValueError, match='mask: .*16-byte aligned base'):
        A._check_cuda_args(q, k, v, shifted)


def test_every_fp32_caller_passes_the_alignment_check(monkeypatch,
                                                     one_thread):
    """No caller of the fp32 route starts to raise: the views and masks
    that the models hand to fused_attention_blhd (models/clip.py's packed
    in_proj; the flagship's and the text+mask model's sampling, ART-V's
    prefill, the training forward with its backward, and both towers of
    models/clip_full.py), here at the tiny sizes on the CPU, pass the card
    path's checks."""
    from mmvid_tpu_torch import factories, training
    from mmvid_tpu_torch.models import clip_full

    plain = A.attention_reference
    seen = []

    def checked(q, k, v, mask, scale, bf16_probs=False):
        A._check_cuda_args(q, k, v, mask)
        seen.append(q.shape)
        return plain(q, k, v, mask, scale, bf16_probs)

    monkeypatch.setattr(A, 'attention_reference', checked)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for cvae in (False, True):
            model, _ = factories.flagship(tiny=True, device='cpu', seed=0,
                                          use_cvae=cvae)
            cfg = model.cfg
            text = torch.randint(1, 100, (2, cfg.text_seq_len),
                                 generator=gen)
            kw = dict(mask_predict_steps=1, dynamic=False, decode=False)
            if cvae:
                kw.update(visual=torch.rand((2, 1, cfg.image_size,
                                             cfg.image_size, 3),
                                            generator=gen),
                          vc_mode='mask_8x8', face_mode='mask')
            model.generate_images(gen, text, **kw)
        artv = factories.artv_tiny(device='cpu')[0]
        artv.prefill(torch.randint(1, 50, (2, artv.cfg.text_seq_len),
                                   generator=gen))
        small = clip_full.ClipConfig(
            embed_dim=32, image_resolution=32, vision_width=64,
            vision_layers=1, vision_patch_size=16, context_length=12,
            vocab_size=100, transformer_width=64, transformer_layers=1)
        scorer = clip_full.CLIP(small).eval()
        scorer.encode_image(torch.rand((2, 3, 32, 32), generator=gen))
        scorer.encode_text(torch.randint(1, 99, (2, 12), generator=gen))
    n_serving = len(seen)
    model, _ = factories.flagship_train(tiny=True, dtype=torch.float32,
                                        device='cpu', seed=3, remat=True)
    tc = training.TrainConfig(rel_no_fully_masked=True, dropout_vc=0.0)
    step = training.make_train_step(model, tc)
    rng = np.random.RandomState(5)
    batch = {'text': torch.from_numpy(
                 rng.randint(1, 100, (2, model.cfg.text_seq_len))).long(),
             'target': torch.from_numpy(rng.uniform(0, 1, (
                 2, model.cfg.num_targets, model.cfg.image_size,
                 model.cfg.image_size, 3)).astype(np.float32))}
    step(training.create_train_state(model, tc), batch,
         torch.Generator().manual_seed(0))
    assert n_serving > 0 and len(seen) > n_serving
