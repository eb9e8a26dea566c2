"""Port's sample head (mmvid_tpu_torch.ops.sample_head) vs the JAX package.

The JAX Pallas kernel seeds the TPU PRNG in the kernel, which has no CPU
lowering even in interpret mode, so the plain version is held against the
function that kernel fuses: ``sampler._sample_multinomial`` on
``BertCore.to_logits`` output, fed the SAME Gumbel noise (drawn in JAX from
the same key split and handed over as numpy).  Tokens must be equal and Y
within 1e-5 (fp32; LayerNorm statistics and the product sum in another
order).  The CUDA kernel, whose Philox bits match no other generator, is
held against the plain version on the card only, in
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
