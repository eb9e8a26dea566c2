"""The CUDA kernels of mmvid_tpu_torch against their plain PyTorch versions.

These need the GPU (a CUDA kernel has no CPU mode): each test carries the
``cuda`` marker and skips without a device.  The file imports no JAX, so it
runs on a machine without it, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
"""

import pytest
import torch

from mmvid_tpu_torch.models.clip import build_attention_mask
from mmvid_tpu_torch.ops import attention as A
from mmvid_tpu_torch.ops import sample_head as S


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('l,h,d', [(565, 12, 64), (139, 2, 32)])
def test_attention_kernel_matches_plain(cuda_device, dtype, tol, l, h, d):
    """bf16 tolerance: outputs rounded to bf16 from fp32 sums taken in
    another order (online softmax), up to 2 bf16 ulps at |out| ~ 2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((3, l, h, d), generator=g, device=cuda_device
                           ).to(dtype) for _ in range(3))
    mask = build_attention_mask(l, 'mask_prev', index=(l // 4, l // 4 + 1),
                                device=cuda_device)
    before = A.launches
    out = A.fused_attention_blhd(q, k, v, mask)
    assert A.launches == before + 1
    want = A.attention_reference(q, k, v, mask, d ** -0.5)
    assert out.dtype == dtype
    assert (out.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize('w_dtype,tol', [(torch.float32, 1e-5),
                                         (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize('m', [1000, 8192])
def test_sample_head_kernel_temp0_matches_plain(cuda_device, w_dtype, tol, m):
    """At temp 0 the kernel's Y is the plain softmax probability of the
    token it chose; any M (1000 leaves a ragged last block).  bf16
    tolerance: the LN output's bf16 rounding can flip on last-bit
    differences of the statistics."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(0)
    d, v = 768, 1024
    x = torch.randn((m, d), generator=g, device=cuda_device)
    ln_w = torch.ones(d, device=cuda_device)
    ln_b = torch.zeros(d, device=cuda_device)
    w = (0.1 * torch.randn((d, v), generator=g, device=cuda_device)
         ).to(w_dtype)
    b = torch.zeros(v, device=cuda_device)
    before = S.launches
    y, tok = S.fused_sample_head(x, ln_w, ln_b, w, b, 0.0, g)
    assert S.launches == before + 1
    probs = torch.softmax(S.head_logits(x, ln_w, ln_b, w, b), -1)
    want = probs.gather(1, tok[:, None])[:, 0]
    assert (y - want).abs().max().item() <= tol
