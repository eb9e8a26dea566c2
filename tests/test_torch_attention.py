"""Port's attention (mmvid_tpu_torch.ops.attention) vs the JAX package.

The plain version is held against JAX's ``_attention_xla`` and against the
Pallas kernel in interpret mode, for the causal and mask_prev masks, at the
tiny config's shape (L=139, 2 heads of 32).  fp32 throughout; tolerance
2e-5, as tests/test_attention_pallas.py uses for the same function (sums in
another order).  The CUDA kernel is held against the plain version on the
card only, in tests/test_torch_kernels.py.
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
