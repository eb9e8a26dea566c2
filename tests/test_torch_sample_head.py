"""Port's sample head (mmvid_tpu_torch.ops.sample_head) vs the JAX package.

The JAX Pallas kernel seeds the TPU PRNG in the kernel, which has no CPU
lowering even in interpret mode, so the plain version is held against the
function that kernel fuses: ``sampler._sample_multinomial`` on
``BertCore.to_logits`` output, fed the SAME Gumbel noise (drawn in JAX from
the same key split and handed over as numpy).  Tokens must be equal and Y
within 1e-5 (fp32; LayerNorm statistics and the product sum in another
order).  The CUDA kernels draw their noise with Philox4x32-10; its
plain version ``philox_gumbel`` is held here against the Philox rounds on
Python integers (and Random123's known answers), and the kernels against
the plain version fed those draws on the card, in
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvid_tpu.models.bert import BertCore
from mmvid_tpu.models.sampler import (
    _gumbel,
    _sample_argmax,
    _sample_multinomial,
)
from mmvid_tpu_torch.models import sampler as port_sampler
from mmvid_tpu_torch.ops import sample_head as S
from test_torch_clip_bert import jax_tiny
from test_torch_sample_head_tf32 import head_logits_tf32x3

Y_TOL = 1e-5


@pytest.fixture(scope='module')
def head():
    """Tiny JAX model's to_logits params and a batch of hidden rows."""
    model, _ = jax_tiny(seed=2)
    params = model.params
    rng = np.random.RandomState(0)
    h = rng.randn(2, model.cfg.target_seq_len, model.cfg.dim).astype(
        np.float32) * 2.0
    logits = np.asarray(model.core.apply({'params': params}, jnp.asarray(h),
                                         method=BertCore.to_logits))
    ln, fc = params['to_logits_ln'], params['to_logits_fc']
    port = [torch.from_numpy(np.array(a)) for a in
            (ln['scale'], ln['bias'], fc['kernel'], fc['bias'])]
    return h, logits, port


@pytest.mark.parametrize('temp', [0.0, 0.5, 1.0])
def test_plain_matches_jax_multinomial_with_same_noise(head, temp):
    h, logits, (ln_w, ln_b, w, b) = head
    key = jax.random.PRNGKey(11)
    y_jax, tok_jax = _sample_multinomial(key, jnp.asarray(logits), temp)
    k1, k2 = jax.random.split(key)
    g1 = np.array(_gumbel(k1, logits.shape)).reshape(-1, logits.shape[-1])
    g2 = np.array(_gumbel(k2, logits.shape)).reshape(-1, logits.shape[-1])
    y, tok = S.sample_head_reference(
        torch.from_numpy(h.reshape(-1, h.shape[-1])), ln_w, ln_b, w, b, temp,
        torch.from_numpy(g1), torch.from_numpy(g2))
    np.testing.assert_array_equal(tok.numpy(),
                                  np.asarray(tok_jax).reshape(-1))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax).reshape(-1),
                               rtol=Y_TOL, atol=Y_TOL)


def test_head_logits_match_jax_to_logits(head):
    """fp32 logits; tolerance for sums in another order."""
    h, logits, (ln_w, ln_b, w, b) = head
    got = S.head_logits(torch.from_numpy(h.reshape(-1, h.shape[-1])), ln_w,
                        ln_b, w, b)
    np.testing.assert_allclose(got.numpy(), logits.reshape(got.shape),
                               rtol=1e-5, atol=1e-5)


def test_tf32x3_logits_match_jax_to_logits(head):
    """The split-TF32 route's arithmetic (h and W each split into TF32
    high and low parts, three products in fp32) against JAX's fp32
    to_logits, within the plain version's tolerance."""
    h, logits, (ln_w, ln_b, w, b) = head
    got = head_logits_tf32x3(torch.from_numpy(h.reshape(-1, h.shape[-1])),
                             ln_w, ln_b, w, b)
    np.testing.assert_allclose(got.numpy(), logits.reshape(got.shape),
                               rtol=1e-5, atol=1e-5)


def test_sample_argmax_matches_jax(head):
    _, logits, _ = head
    y_jax, tok_jax = _sample_argmax(jnp.asarray(logits))
    y, tok = port_sampler._sample_argmax(torch.from_numpy(logits))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_jax))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=1e-6,
                               atol=1e-7)


def test_cpu_dispatch_draws_from_generator(head):
    """A CPU tensor takes the plain path with noise from the caller's
    generator: reproducible by seed, no kernel launch."""
    h, _, (ln_w, ln_b, w, b) = head
    x = torch.from_numpy(h.reshape(-1, h.shape[-1]))
    before = S.launches
    runs = [S.fused_sample_head(x, ln_w, ln_b, w, b, 1.0,
                                torch.Generator().manual_seed(s))
            for s in (5, 5, 6)]
    assert S.launches == before
    (y0, t0), (y1, t1), (_, t2) = runs
    assert y0.dtype == torch.float32 and t0.dtype == torch.int64
    assert y0.shape == t0.shape == (x.shape[0],)
    torch.testing.assert_close(y0, y1, rtol=0, atol=0)
    assert torch.equal(t0, t1) and not torch.equal(t0, t2)
    assert bool(((y0 > 0) & (y0 <= 1)).all())


def test_no_plain_fallback_on_other_devices():
    x = torch.empty((4, 8), device='meta')
    w = torch.empty((8, 16), device='meta')
    before = S.launches
    with pytest.raises(ValueError, match='no sample-head path'):
        S.fused_sample_head(x, x[0], x[0], w, w[0], 1.0, None)
    assert S.launches == before


def _philox_int(ctr, key):
    """Philox4x32-10 on Python ints, from the round definition: per
    round (hi0, lo0) = M0 * c0, (hi1, lo1) = M1 * c2 (64-bit products);
    c = (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0); then k += (W0, W1)."""
    m0, m1, w0, w1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
    mask = 0xFFFFFFFF
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        p0, p1 = m0 * c0, m1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & mask,
                          (p0 >> 32) ^ c3 ^ k1, p0 & mask)
        k0, k1 = (k0 + w0) & mask, (k1 + w1) & mask
    return c0, c1, c2, c3


@pytest.mark.parametrize('ctr,key,want', [
    # Random123's known answers for philox4x32_10
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ((1023, 8191, 0, 0), (0x89ABCDEF, 0x01234567), None),
    ((5, 17, 0, 0), (0, 0x3FFFFFFF), None)])
def test_philox_matches_integer_rounds(ctr, key, want):
    """The plain Philox (int64 tensors masked to 32 bits) against the
    rounds on Python ints, and both against Random123's known answers."""
    ints = _philox_int(ctr, key)
    if want is not None:
        assert ints == want
    got = S.philox4x32_10(tuple(torch.tensor([c], dtype=torch.int64)
                                for c in ctr), key)
    assert tuple(int(t) for t in got) == ints


@pytest.mark.parametrize('seed', [0, 123456789012345, 2 ** 62 - 1])
def test_philox_gumbel_matches_integer_philox(seed):
    """philox_gumbel's G1 and G2 at (row, column): the first and second
    words of Philox at counter (column, row, 0, 0), key (seed low, seed
    high), through gumbel_from_bits (u = (bits >> 8) 2^-24 + 2^-25 in
    fp32, -log(-log(u + 1e-20) + 1e-20)); the logarithms within 1e-6 of
    float64's."""
    m, v = 4, 6
    g1, g2 = S.philox_gumbel(seed, m, v)
    assert g1.shape == g2.shape == (m, v) and g1.dtype == torch.float32
    key = (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF)
    for r in range(m):
        for c in range(v):
            words = _philox_int((c, r, 0, 0), key)
            for g, word in ((g1, words[0]), (g2, words[1])):
                u = float(np.float32((word >> 8) * 2.0 ** -24 + 2.0 ** -25))
                want = -np.log(-np.log(u + 1e-20) + 1e-20)
                assert abs(float(g[r, c]) - want) <= 1e-6 * max(1, abs(want))
    words = S.philox4x32_10(
        (torch.arange(v)[None].expand(m, v), torch.arange(m)[:, None].expand(
            m, v), torch.zeros(m, v, dtype=torch.int64),
         torch.zeros(m, v, dtype=torch.int64)), key)
    assert torch.equal(S.gumbel_from_bits(words[1]), g2)


@pytest.mark.parametrize('shape,dtype,route', [
    ((768, 1024), torch.bfloat16, 'wgmma'),        # every full-width model
    ((768, 1024), torch.float32, 'tf32x3'),        # the same in fp32
    ((768, 1000), torch.bfloat16, 'cuda_cores'),   # V % 256
    ((100, 1024), torch.bfloat16, 'cuda_cores'),   # D % 64
    ((1024, 1024), torch.bfloat16, 'cuda_cores'),  # D > 960
    ((64, 256), torch.bfloat16, 'wgmma'),
    ((1024, 128), torch.float32, 'tf32x3'),
    ((768, 1000), torch.float32, 'cuda_cores'),    # V % 128
    ((100, 1024), torch.float32, 'cuda_cores'),    # D % 64
    ((1088, 1024), torch.float32, 'cuda_cores')])  # D > 1024
def test_kernel_route_rule(shape, dtype, route):
    """The shape rule the CUDA wrapper states: bf16 W with D % 64 == 0,
    D <= 960 and V % 256 == 0 takes the tensor-core kernel, fp32 W with D
    % 64 == 0, D <= 1024 and V % 128 == 0 the split-TF32 kernel, the rest
    the CUDA-core kernel."""
    assert S.kernel_route(torch.empty(shape, dtype=dtype)) == route
