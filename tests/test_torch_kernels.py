"""The CUDA kernels of mmvid_tpu_torch against their plain PyTorch versions.

These need the GPU (a CUDA kernel has no CPU mode): each test carries the
``cuda`` marker and skips without a device.  The file imports no JAX, so it
runs on a machine without it, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
"""

import pytest
import torch

from chip_smoke import CODE_GAP_TOL, disagreement, int8_agrees
from mmvid_tpu_torch.models.clip import attention_mask, build_attention_mask
from mmvid_tpu_torch.ops import artv_decode as AD
from mmvid_tpu_torch.ops import attention as A
from mmvid_tpu_torch.ops import attention_int8 as A8
from mmvid_tpu_torch.ops import codebook as C
from mmvid_tpu_torch.ops import fused_ln_qkv as Q
from mmvid_tpu_torch.ops import gridstep as G
from mmvid_tpu_torch.ops import int8 as I8
from mmvid_tpu_torch.ops import sample_head as S


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


def _packed_qkv(g, device, b, l, h, d, dtype):
    """q, k, v as strided views of one [B, L, 3 * H * D] projection, the
    main path's layout (models/clip.py)."""
    qkv = torch.randn((b, l, 3 * h * d), generator=g, device=device
                      ).to(dtype)
    return [qkv[..., i * h * d:(i + 1) * h * d].view(b, l, h, d)
            for i in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize('bf16_probs', [False, True],
                         ids=['fp32_probs', 'bf16_probs'])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('b,l,h,d,idx', [
    (3, 565, 12, 64, (51, 52)),     # flagship
    (16, 629, 12, 64, (115, 116)),  # text+mask, at its batch
    (3, 139, 2, 32, (9, 10))])      # tiny
def test_attention_kernel_matches_plain(cuda_device, monkeypatch, bf16_probs,
                                        dtype, tol, b, l, h, d, idx):
    """Each path's sequence and mask_prev rows, with MMVID_ATTN_BF16 off
    and on (the plain version of the same variant).  bf16 tolerance:
    outputs rounded to bf16 from fp32 sums taken in another order (online
    softmax), up to 2 bf16 ulps at |out| ~ 2.  fp32 with bf16
    probabilities: the kernel rounds exp(logit - running max), the plain
    version exp(logit - row max), so a term moves by up to 2^-9 of itself
    (8e-4 measured at L565): 4e-3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if bf16_probs:
        monkeypatch.setenv('MMVID_ATTN_BF16', '1')
    else:
        monkeypatch.delenv('MMVID_ATTN_BF16', raising=False)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((b, l, h, d), generator=g, device=cuda_device
                           ).to(dtype) for _ in range(3))
    mask = build_attention_mask(l, 'mask_prev', index=idx, device=cuda_device)
    before = A.launches
    out = A.fused_attention_blhd(q, k, v, mask)
    assert A.launches == before + 1
    want = A.attention_reference(q, k, v, mask, d ** -0.5, bf16_probs)
    assert out.dtype == dtype
    if bf16_probs:
        tol = max(tol, 4e-3)
    assert (out.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize('bf16_probs', [False, True],
                         ids=['fp32_probs', 'bf16_probs'])
@pytest.mark.parametrize('b,l,h,d,kind', [
    (16, 629, 12, 64, 'mask_prev'),   # text+mask, packed as on the path
    (4, 626, 12, 64, 'causal'),       # ART-V's training forward
    (3, 139, 2, 32, 'mask_prev'),     # tiny, D 32
    (3, 139, 2, 32, 'causal')])
def test_attention_kernel_packed_views(cuda_device, monkeypatch, bf16_probs,
                                       b, l, h, d, kind):
    """bf16 q, k, v as strided views of one packed projection (row stride
    3 * H * D), causal and mask_prev masks, D 64 and 32: within 2e-2 of
    the plain version, and by default (the P_hi + P_lo split) at most 2% of
    the bf16 outputs differ from it (about 0.2% expected; bf16
    probabilities move about 40%)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if bf16_probs:
        monkeypatch.setenv('MMVID_ATTN_BF16', '1')
    else:
        monkeypatch.delenv('MMVID_ATTN_BF16', raising=False)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = _packed_qkv(g, cuda_device, b, l, h, d, torch.bfloat16)
    assert q.stride()[1] == 3 * h * d
    idx = {629: (115, 116), 139: (9, 10)}.get(l)
    mask = build_attention_mask(l, kind, index=idx, device=cuda_device)
    before = A.launches
    out = A.fused_attention_blhd(q, k, v, mask)
    assert A.launches == before + 1
    want = A.attention_reference(q, k, v, mask, d ** -0.5, bf16_probs)
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    if not bf16_probs:
        assert (out != want).float().mean().item() <= 0.02


@pytest.mark.cuda
@pytest.mark.parametrize('compact', [True, False],
                         ids=['compact_mask', 'fp32_mask'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
@pytest.mark.parametrize('b,l,h,d,idx,packed', [
    (16, 565, 12, 64, (51, 52), True),     # flagship, as on the path
    (16, 629, 12, 64, (115, 116), True),   # text+mask
    (2, 29, 2, 64, (5,), False),           # ragged, fewer rows than a tile
    (3, 139, 2, 32, (9, 10), False),       # tiny, D 32
    (2, 300, 3, 64, (40, 41), True),       # ragged: a one-warpgroup tile
    (1, 1024, 2, 64, (3,), False)])        # the largest L the kernel takes
def test_attention_int8_kernel_matches_plain(cuda_device, monkeypatch,
                                             compact, dtype, b, l, h, d, idx,
                                             packed):
    """MMVID_ATTN_INT8=1: the s8 kernel against attention_int8_reference
    within chip_smoke.py's int8 limits (``int8_agrees``: quantization
    steps at most and on average, bf16 outputs differing), which the
    unquantized function on the same inputs must fail, at three seeds
    (the readings are printed: ``-rP`` shows them); two calls bitwise
    equal; two launches a call (the operand pass and the attention), none
    of the bf16 kernel.  With the mask's compact form, as the models pass
    it, and with the fp32 mask alone, which the kernel then reads."""
    monkeypatch.setenv('MMVID_ATTN_INT8', '1')
    masks = attention_mask(l, 'mask_prev', index=idx, device=cuda_device)
    mask = masks if compact else build_attention_mask(
        l, 'mask_prev', index=idx, device=cuda_device)
    for seed in (l, l + 3, 7):
        g = torch.Generator(device=cuda_device).manual_seed(seed)
        if packed:
            q, k, v = _packed_qkv(g, cuda_device, b, l, h, d, dtype)
        else:
            q, k, v = (torch.randn((b, l, h, d), generator=g,
                                   device=cuda_device).to(dtype)
                       for _ in range(3))
        before, before_bf16 = A8.launches, A.launches
        out = A.fused_attention_blhd(q, k, v, mask)
        again = A.fused_attention_blhd(q, k, v, mask)
        assert (A8.launches, A.launches) == (before + 4, before_bf16)
        assert out.dtype == dtype and out.shape == (b, l, h, d)
        assert torch.equal(out, again)
        want = A8.attention_int8_reference(q, k, v, masks.dense, d ** -0.5)
        err = disagreement(out, want, v)
        control = disagreement(A.attention_reference(
            q, k, v, masks.dense, d ** -0.5), want, v)
        print(f'seed {seed}: kernel {err}; unquantized {control}')
        assert int8_agrees(err, dtype), err
        assert not int8_agrees(control, dtype), control


@pytest.mark.cuda
def test_attention_int8_kernel_rejects_bad_inputs(cuda_device, monkeypatch):
    """What the kernel does not take raises, launching nothing: L beyond
    the shared-memory bound, a head dim other than 32 or 64, a row stride
    that breaks its 16-byte loads."""
    monkeypatch.setenv('MMVID_ATTN_INT8', '1')
    before = A8.launches
    for shape in ((1, 1025, 2, 64), (1, 16, 2, 16)):
        q = torch.zeros(shape, device=cuda_device)
        with pytest.raises(ValueError):
            A.fused_attention_blhd(q, q, q)
    base = torch.zeros((1, 16, 2 * 64 + 8), device=cuda_device)
    q = base[..., 2:130].view(1, 16, 2, 64)   # an 8-byte offset base
    with pytest.raises(ValueError, match='16-byte'):
        A.fused_attention_blhd(q, q, q)
    assert A8.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('int8_flag', [False, True],
                         ids=['bf16_kernel', 'int8_kernel'])
def test_kernels_refuse_grad(cuda_device, monkeypatch, int8_flag):
    """C1: the kernels write through ctypes and have no backward, so on the
    card a call with grad enabled and an input that requires grad raises
    (serving only) and launches nothing; under no_grad it runs."""
    if int8_flag:
        monkeypatch.setenv('MMVID_ATTN_INT8', '1')
    else:
        monkeypatch.delenv('MMVID_ATTN_INT8', raising=False)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn((2, 37, 2, 64), generator=g, device=cuda_device
                           ).bfloat16() for _ in range(3))
    q.requires_grad_(True)
    counts = (A.launches, A8.launches, Q.launches)
    with pytest.raises(RuntimeError, match='serving only'):
        A.fused_attention_blhd(q, k, v)
    x, ln_w, ln_b, w, bias = _ln_qkv_inputs(cuda_device, 2, 37, 128,
                                            torch.bfloat16)
    w.requires_grad_(True)
    with pytest.raises(RuntimeError, match='serving only'):
        Q.fused_ln_qkv(x, ln_w, ln_b, w, bias)
    assert (A.launches, A8.launches, Q.launches) == counts
    with torch.no_grad():
        A.fused_attention_blhd(q, k, v)
        Q.fused_ln_qkv(x, ln_w, ln_b, w, bias)
    # the int8 kernel counts two launches a call
    assert (A.launches, A8.launches, Q.launches) == (
        counts[0] + (not int8_flag), counts[1] + 2 * int8_flag,
        counts[2] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize('m,k,n', [(16, 768, 2304), (16, 3072, 1024),
                                   (5, 20, 3), (8192, 768, 3072)])
def test_int_mm_on_the_card_is_exact(cuda_device, m, k, n):
    """ops.int8.int_mm: a @ w^T through torch._int_mm with the zero padding
    its cuBLAS route needs (M > 16, K and N multiples of 8), equal to an
    int32 product."""
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = I8.int_mm(a.to(cuda_device), w.to(cuda_device))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), a.int() @ w.int().t())


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


@pytest.mark.cuda
@pytest.mark.parametrize('route', S.ROUTES)
@pytest.mark.parametrize('m', [1000, 8192])
def test_sample_head_kernels_match_philox_plain(cuda_device, route, m):
    """Both bf16 routes at temp 1 against the plain version fed the
    kernels' own noise (philox_gumbel at the same seed): tokens equal on
    >= 99.9% of rows (the fp32 sums of the logits run in another order,
    so near-ties may flip) and Y within 4e-3 relative where they are
    (chip_smoke.py's HEAD_Y_REL_TOL: the LN output's bf16 roundings flip
    on last-bit differences of the statistics and move a logit by ~1e-3;
    the tensor-core kernel read 2.535e-3 and the CUDA-core kernel 1.588e-3
    on the H100, the plain version with bf16 logits 4.420e-2); the
    tensor-core kernel's tokens equal the CUDA-core kernel's on as many.
    M 1000 leaves a ragged last block."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(3)
    d, v = 768, 1024
    x = torch.randn((m, d), generator=g, device=cuda_device) * 2 + 0.5
    ln_w = 1 + 0.1 * torch.randn((d,), generator=g, device=cuda_device)
    ln_b = 0.1 * torch.randn((d,), generator=g, device=cuda_device)
    w = (0.108 * torch.randn((d, v), generator=g, device=cuda_device)
         ).bfloat16()
    b = 0.1 * torch.randn((v,), generator=g, device=cuda_device)
    seed = torch.tensor([987654321987], dtype=torch.int64,
                        device=cuda_device)
    assert S.kernel_route(w) == 'wgmma' and S.kernel_route(w.float()) == \
        'cuda_cores'
    before = S.launches
    y, tok = S.sample_head_kernel(x, ln_w, ln_b, w, b, 1.0, seed, route)
    assert S.launches == before + 1
    g1, g2 = S.philox_gumbel(int(seed), m, v, cuda_device)
    y_ref, tok_ref = S.sample_head_reference(x, ln_w, ln_b, w, b, 1.0, g1,
                                             g2)
    same = tok == tok_ref
    assert same.float().mean().item() >= 0.999
    assert ((y - y_ref).abs() / y_ref)[same].max().item() <= 4e-3
    other = 'cuda_cores' if route == 'wgmma' else 'wgmma'
    _, tok_other = S.sample_head_kernel(x, ln_w, ln_b, w, b, 1.0, seed,
                                        other)
    assert (tok == tok_other).float().mean().item() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize('d', [64, 256])
@pytest.mark.parametrize('k', [200, 1000, 1024])
@pytest.mark.parametrize('m', [1, 7, 1000, 1024, 4096, 8192])
def test_codebook_kernel_matches_plain(cuda_device, m, d, k):
    """Ids equal on a randn codebook (spread scores) at the paths' M
    (1024 text+mask control frames, 4096 the image_and_video recipe's 4,
    8192 one video's 8 frames), one row, a ragged row tile (7, 1000) and
    ragged code tiles (K 200, 1000); an exact tie (a duplicated code)
    takes the lowest index.  One launch a call, the same ids twice.  With
    8M row-code pairs at D 64 a randn codebook still holds fp32 near-ties:
    two codes within CODE_GAP_TOL of each other in fp64, whose order fp32
    sums taken in another order (the kernel's, cuBLAS's) may flip.  Where
    the ids differ, the kernel's code must be within CODE_GAP_TOL of the
    best, on at most one row in a thousand."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(0)
    z = torch.randn((m, d), generator=g, device=cuda_device)
    cb = torch.randn((k, d), generator=g, device=cuda_device)
    cb[k - 1] = cb[3]
    cb[130 % k] = cb[3]
    z[0] = cb[3]
    before = C.launches
    idx = C.nearest_codebook_indices(z, cb)
    assert C.launches == before + 1
    assert idx.dtype == torch.int64 and idx.shape == (m,)
    assert int(idx[0]) == 3
    want = C.nearest_codebook_reference(z, cb)
    # codes 130 and k - 1 are code 3 bit for bit: a row nearest to them
    # ties, and the lowest index, 3, wins
    want[(want == 130) | (want == k - 1)] = 3
    differ = idx != want
    if differ.any():
        s = z.double() @ cb.double().t() - 0.5 * cb.double().square().sum(-1)
        gap = s.max(-1).values - s.gather(1, idx[:, None])[:, 0]
        assert gap[differ].max().item() <= CODE_GAP_TOL
        assert int(differ.sum()) <= max(1, m // 1000)
    assert torch.equal(C.nearest_codebook_indices(z, cb), idx)


@pytest.mark.cuda
@pytest.mark.parametrize('m', [1024, 4096, 8192])
def test_codebook_kernel_near_ties_random_init(cuda_device, m):
    """U(-1/1024, 1/1024) codebook: codes differ by ~1e-5 in score, so
    the chosen code's score must be within 1e-5 of the best (fp64)."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    z = torch.randn((m, 256), generator=g, device=cuda_device)
    cb = (torch.rand((1024, 256), generator=g, device=cuda_device) * 2
          - 1) / 1024
    idx = C.nearest_codebook_indices(z, cb)
    s = z.double() @ cb.double().t() - 0.5 * cb.double().square().sum(-1)
    gap = s.max(-1).values - s.gather(1, idx[:, None])[:, 0]
    assert gap.max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('zshape,cbshape', [((16, 66), (1024, 66)),
                                            ((16, 64), (1024, 32)),
                                            ((0, 64), (1024, 64))],
                         ids=['d_not_multiple_of_4', 'd_mismatch', 'empty'])
def test_codebook_kernel_refuses_before_launch(cuda_device, zshape, cbshape):
    """Shapes the kernel does not take raise before anything launches."""
    z = torch.randn(zshape, device=cuda_device)
    cb = torch.randn(cbshape, device=cuda_device)
    before = C.launches
    with pytest.raises(ValueError):
        C.nearest_codebook_indices(z, cb)
    assert C.launches == before


def _ln_qkv_inputs(device, b, l, d, dtype):
    g = torch.Generator(device=device).manual_seed(2)
    x = (torch.randn((b, l, d), generator=g, device=device) * 2
         + 0.5).to(dtype)
    ln_w = 1 + 0.1 * torch.randn((d,), generator=g, device=device)
    ln_b = 0.1 * torch.randn((d,), generator=g, device=device)
    w = (torch.randn((3 * d, d), generator=g, device=device)
         * d ** -0.5).to(dtype)
    bias = (0.1 * torch.randn((3 * d,), generator=g, device=device)
            ).to(dtype)
    return x, ln_w, ln_b, w, bias


@pytest.mark.cuda
@pytest.mark.parametrize('b,l,d', [(16, 629, 768), (16, 565, 768),
                                   (3, 333, 768), (2, 37, 128)])
def test_ln_qkv_kernel_matches_plain(cuda_device, b, l, d):
    """The text+mask and flagship backbones' shapes, a ragged M (999 rows:
    the last 128-row tile partial) and the CPU tests' width-128 shape
    (3D = 384: the last 256-column tile partial), in bf16 within 2e-2 * (1
    + |plain|) (assert_allclose's form with rtol = atol): h and the output
    are rounded to bf16, and a last-bit difference of the LN statistics
    flips one rounding, one bf16 ulp (2^-8 relative)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, ln_w, ln_b, w, bias = _ln_qkv_inputs(cuda_device, b, l, d,
                                            torch.bfloat16)
    before = Q.launches
    out = Q.fused_ln_qkv(x, ln_w, ln_b, w, bias)
    assert Q.launches == before + 1
    assert out.shape == (b, l, 3 * d) and out.dtype == torch.bfloat16
    want = Q.ln_qkv_reference(x, ln_w, ln_b, w, bias)
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_ln_qkv_kernel_rejects_fp32(cuda_device):
    """The kernel is bf16 only: fp32 on the card raises, launching
    nothing (fp32 takes the plain version on the CPU)."""
    args = _ln_qkv_inputs(cuda_device, 2, 37, 128, torch.float32)
    before = Q.launches
    with pytest.raises(ValueError, match='bf16'):
        Q.fused_ln_qkv(*args)
    assert Q.launches == before


def bf16_ulp(t):
    """One bf16 ulp at the larger of |t| and 1 (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(1.0))) - 7)


# bf16 whole step through 12 random blocks vs plain: y and k_new, v_new
# within this * (1 + |plain|), at B <= 16 and at B 64 (chip_smoke.py's
# DECODE_DEEP_TOL and DECODE_DEEP_TOL_B64, which give the readings)
DEEP_TOL, DEEP_TOL_B64 = 5e-2, 7.5e-2


def _bf16_close(got, want, tol):
    """y within tol * (1 + |plain|); k_new, v_new within tol of that form
    too when tol is given for them, else within one bf16 ulp of
    max(|plain|, 1)."""
    y, k_new, v_new = got
    ok = bool(((y - want[0]).abs() <= tol[0] * (1 + want[0].abs())).all())
    for g, w in zip((k_new, v_new), want[1:]):
        g, w = g.float(), w.float()
        lim = tol[1] * (1 + w.abs()) if tol[1] else bf16_ulp(w)
        ok = ok and bool(((g - w).abs() <= lim).all())
    return ok


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['float32', 'bfloat16'])
@pytest.mark.parametrize('n_layers,b,w,d,heads,pos', [
    (2, 2, 256, 128, 2, 1), (2, 2, 256, 128, 2, 64),
    (2, 2, 256, 128, 2, 255), (2, 3, 256, 64, 2, 200),
    (12, 16, 626, 768, 12, 1), (12, 16, 626, 768, 12, 64),
    (12, 16, 626, 768, 12, 625), (12, 1, 626, 768, 12, 0),
    (12, 5, 626, 768, 12, 1), (12, 64, 626, 768, 12, 370)])
def test_artv_decode_kernel_matches_plain(cuda_device, dtype, n_layers, b,
                                          w, d, heads, pos):
    """The ART-V step at the small shape (head dims 64 and 32) and at full
    width (768 x 12 layers, W 626; B 16 at pos 1, 64 and the last row, B
    1 at pos 0, 5 at 1 and 64 at 370), on the default (phased) kernel.
    fp32 within 1e-4 (sums in another order).  bf16: y within 2e-2 * (1 +
    |plain|) and k_new, v_new within one bf16 ulp of max(|plain|, 1): the
    kernel rounds h, the probabilities and the MLP activations to bf16 at
    the plain version's places, and a last-bit difference of an fp32 sum
    flips one rounding, which moves later values by about 1e-4.  At full
    width that holds block by block (each block's kernel and plain
    version fed the same input, the plain version's x): through 12 random
    blocks such flips grow, and moving x by one fp32 ulp alone moves the
    plain version's own y and k, v about as far (chip_smoke.py prints
    both), so the whole step is held within DEEP_TOL * (1 + |plain|),
    DEEP_TOL_B64 at B 64."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(pos)
    x, p, ck, cv = AD.random_inputs(n_layers, b, w, d, dtype, g,
                                    cuda_device)
    before = AD.launches
    got = AD.decode_token_step(x, p, ck, cv, pos, heads)
    assert AD.launches == before + 1
    want = AD.decode_token_step_reference(x, p, ck, cv, pos, heads)
    assert got[0].dtype == torch.float32 and got[1].dtype == dtype
    assert got[1].shape == got[2].shape == (n_layers, b, d)
    if dtype == torch.float32:
        for a, ref in zip(got, want):
            assert (a - ref).abs().max().item() <= 1e-4
        return
    if n_layers <= 2:
        assert _bf16_close(got, want, (2e-2, None))
        return
    tol = DEEP_TOL_B64 if b > 16 else DEEP_TOL
    assert _bf16_close(got, want, (tol, tol))
    xi = x
    for i in range(n_layers):
        args = (AD.layer_params(p, i), ck[i:i + 1], cv[i:i + 1], pos, heads)
        ref = AD.decode_token_step_reference(xi, *args)
        assert _bf16_close(AD.decode_token_step(xi, *args), ref,
                           (2e-2, None)), f'block {i}'
        xi = ref[0]


@pytest.mark.cuda
@pytest.mark.parametrize('b,pos', [(16, 370), (5, 1), (64, 0)])
def test_artv_stream_kernel_repeatable_and_reads_rows_below_pos(
        cuda_device, b, pos):
    """The streaming bf16 kernel at full width, forced, with the cache
    rows >= pos filled with NaN (they are not read): two calls give
    bitwise equal outputs (split-K partials added in a fixed order, no
    float atomics), a workspace gives the same outputs, the whole step is
    within test_artv_decode_kernel_matches_plain's bound of the plain
    version (DEEP_TOL_B64 at B 64), and each block, fed the plain version's
    input, within 2e-2 * (1 + |plain|) and one bf16 ulp of it."""
    g = torch.Generator(device=cuda_device).manual_seed(b + pos)
    x, p, ck, cv = AD.random_inputs(12, b, 626, 768, torch.bfloat16, g,
                                    cuda_device)
    ck[:, :, pos:] = float('nan')
    cv[:, :, pos:] = float('nan')
    before = AD.launches
    first = [t.clone() for t in AD.decode_token_step(x, p, ck, cv, pos, 12,
                                                     kernel='stream')]
    again = AD.decode_token_step(x, p, ck, cv, pos, 12, kernel='stream')
    ws = AD.DecodeWorkspace(p, b, 12)
    third = AD.decode_token_step(x, p, ck, cv, pos, 12, ws, 'stream')
    assert AD.launches == before + 3
    for a, c, d in zip(first, again, third):
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a, c) and torch.equal(a, d)
    want = AD.decode_token_step_reference(x, p, ck, cv, pos, 12)
    tol = DEEP_TOL_B64 if b > 16 else DEEP_TOL
    assert _bf16_close(first, want, (tol, tol))
    xi = x
    for i in range(12):
        args = (AD.layer_params(p, i), ck[i:i + 1], cv[i:i + 1], pos, 12)
        ref = AD.decode_token_step_reference(xi, *args)
        got = AD.decode_token_step(xi, *args, kernel='stream')
        assert _bf16_close(got, ref, (2e-2, None)), f'block {i}'
        xi = ref[0]


@pytest.mark.cuda
def test_artv_stream_kernel_across_layouts(cuda_device):
    """The streaming kernel's flags outlive a call and are shared by every
    layout on a stream: a 12-layer step at B 16, then 1-layer steps at B 5,
    then the first step again gives bitwise the first step's outputs (no
    flag a call of another layout left reads as published)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x, p, ck, cv = AD.random_inputs(12, 16, 626, 768, torch.bfloat16, g,
                                    cuda_device)
    first = [t.clone() for t in AD.decode_token_step(x, p, ck, cv, 370, 12,
                                                     kernel='stream')]
    x5, p5, ck5, cv5 = AD.random_inputs(1, 5, 64, 768, torch.bfloat16, g,
                                        cuda_device)
    for pos in range(4):
        AD.decode_token_step(x5, p5, ck5, cv5, pos, 12, kernel='stream')
    again = AD.decode_token_step(x, p, ck, cv, 370, 12, kernel='stream')
    for a, c in zip(first, again):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_artv_decode_kernel_rejects_bad_shapes(cuda_device):
    """Head dims other than 32 or 64, pos beyond W, or B above 64 raise
    and launch nothing."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x, p, ck, cv = AD.random_inputs(1, 2, 64, 96, torch.bfloat16, g,
                                    cuda_device)
    before = AD.launches
    with pytest.raises(ValueError, match='head dim'):
        AD.decode_token_step(x, p, ck, cv, 1, 2)          # hd 48
    with pytest.raises(ValueError, match='pos'):
        AD.decode_token_step(x, p, ck, cv, 65, 3)
    assert AD.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('launches_per_call', G.LAUNCHES_PER_CALL)
def test_gridstep_kernel_matches_plain(cuda_device, launches_per_call):
    """The probe at its shape, 4 chained calls, each launch structure:
    within 1e-4 of the plain version (fp32 sums in another order), and
    the three structures bitwise equal (the same tiles, the same order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x, w = G.probe_inputs(g, cuda_device)
    wt = G.prepare_weights(w)
    before = G.launches
    got = G.probe(x, wt, launches_per_call, calls=4)
    assert G.launches == before + 4 * launches_per_call
    want = x
    for _ in range(4):
        want = G.probe_call_reference(want, wt)
    assert (got - want).abs().max().item() <= 1e-4
    assert torch.equal(got, G.probe(x, wt, 1, calls=4))
