"""The split-TF32 route of the port's sample head (``'tf32x3'``,
``csrc/sample_head_tf32_sm90.cu``) on the CPU: its arithmetic, emulated in
plain PyTorch, against fp64 and the plain fp32 version; the route's shape
and refusal rules; the sampler making W's split once a call.

The kernel rounds each operand to TF32 with ``cvt.rna.tf32.f32`` and its
remainder again, and sums h_hi W_hi + h_hi W_lo + h_lo W_hi in fp32.
``round_tf32`` is that rounding by integer bit operations, held here to
the definition (the nearer of the two TF32 neighbours, ties away from
zero); ``head_logits_tf32x3`` below is the three products (held to JAX's
``to_logits`` in tests/test_torch_sample_head.py).  The kernel itself is
held to the plain version on the card (tests/test_torch_kernels.py,
chip_smoke.py::phase_sample_head).
"""

import numpy as np
import pytest
import torch

from chip_smoke import HEAD_TOKEN_SHARE, HEAD_Y_REL_TOL_FP32
from mmvid_tpu_torch import factories
from mmvid_tpu_torch.models import sampler as ps
from mmvid_tpu_torch.models.mmvid import DEFAULT_MP_CONFIG as MP
from mmvid_tpu_torch.ops import sample_head as S

# |logit - fp64 logit| <= LOGIT_BOUND * sum_k |h_k W_kv|: fp32 sums of D
# terms round at 2^-24 of the running sum a step, about sqrt(D) 2^-24 of
# the absolute sum at these depths (the plain fp32 product and the split
# read at most 3.6e-7 at D 64-768); the split's dropped h_lo W_lo and its
# remainders' roundings add about 2^-22 of a term.  One TF32 pass rounds
# each operand at 2^-12 and reads 7.4e-5 or more.
LOGIT_BOUND = 2.0 ** -19


def head_logits_tf32x3(x, ln_w, ln_b, w, b):
    """The split-TF32 kernel's arithmetic in plain PyTorch: h = LN(x) in
    fp32, h and W split by ``split_tf32``, h_hi W_hi + h_hi W_lo + h_lo
    W_hi in fp32, + b -> [M, V] (the kernel sums the products in another
    order)."""
    h_hi, h_lo = S.split_tf32(S.layer_norm_fp32(x, ln_w, ln_b))
    w_hi, w_lo = S.split_tf32(w)
    return (h_hi @ w_hi + h_hi @ w_lo) + h_lo @ w_hi + b.float()


def _rna_definition(f):
    """TF32 rounding of fp32 values from its definition: of the two TF32
    neighbours (10 mantissa bits), the nearer in fp64, on a tie the one of
    larger magnitude."""
    f = np.asarray(f, dtype=np.float32)
    bits = f.view(np.uint32)
    low = (bits & np.uint32(0xFFFFE000)).view(np.float32).astype(np.float64)
    high = ((bits & np.uint32(0xFFFFE000)) + np.uint32(0x2000)).view(
        np.float32).astype(np.float64)
    x = f.astype(np.float64)
    take_high = np.abs(high - x) <= np.abs(x - low)
    return np.where(take_high, high, low).astype(np.float32)


def _inputs(m, d, v, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(m, d) * 2 + 0.5).astype(np.float32))
    ln_w = torch.from_numpy((1 + 0.1 * rng.randn(d)).astype(np.float32))
    ln_b = torch.from_numpy((0.1 * rng.randn(d)).astype(np.float32))
    # logit std about 3, as chip_smoke.py's inputs
    w = torch.from_numpy((0.108 * np.sqrt(768 / d) * rng.randn(d, v)
                          ).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(v)).astype(np.float32))
    return x, ln_w, ln_b, w, b


@pytest.mark.parametrize('kind', ['normal', 'ties', 'binades', 'tiny'])
def test_round_tf32_is_rna(kind):
    rng = np.random.RandomState(1)
    if kind == 'normal':
        f = (rng.randn(4096) * 10.0 ** rng.randint(-6, 6, 4096))
    elif kind == 'ties':   # the low 13 bits exactly half a TF32 ulp
        bits = (rng.randint(100, 150, 2048).astype(np.uint32) << 23
                | rng.randint(0, 2 ** 10, 2048).astype(np.uint32) << 13
                | np.uint32(0x1000))
        f = np.concatenate([bits.view(np.float32), -bits.view(np.float32)])
    elif kind == 'binades':  # just below powers of two: rounds up a binade
        f = np.nextafter(np.float32(2.0) ** np.arange(-20, 20,
                                                      dtype=np.float32),
                         np.float32(0))
        f = np.concatenate([f, -f, [0.0, -0.0, 1.0, -1.0]])
    else:                  # subnormals
        f = rng.randint(1, 2 ** 23, 1024).astype(np.uint32).view(np.float32)
    f = np.asarray(f, dtype=np.float32)
    got = S.round_tf32(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32) & 0x1FFF, 0)
    np.testing.assert_array_equal(got, _rna_definition(f))
    if kind == 'ties':
        assert np.all(np.abs(got) > np.abs(f))   # away from zero


def test_split_tf32_parts():
    """hi and lo are TF32 values and hi + lo is t within 2^-23 of |t|."""
    t = torch.from_numpy(np.random.RandomState(2).randn(8192).astype(
        np.float32))
    hi, lo = S.split_tf32(t)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    assert bool(((lo.abs() <= 2.0 ** -11 * t.abs())).all())
    err = (t.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -23 * t.double().abs()).all())


def _logit_errors(m, d, v):
    x, ln_w, ln_b, w, b = _inputs(m, d, v, seed=d)
    h = S.layer_norm_fp32(x, ln_w, ln_b)
    want = h.double() @ w.double() + b.double()
    scale = h.double().abs() @ w.double().abs()
    got = {'tf32x3': head_logits_tf32x3(x, ln_w, ln_b, w, b),
           'fp32': S.head_logits(x, ln_w, ln_b, w, b),
           'one_pass': S.round_tf32(h) @ S.round_tf32(w) + b}
    return {k: ((g.double() - want).abs() / scale).max().item()
            for k, g in got.items()}


@pytest.mark.parametrize('m,d,v', [(512, 64, 1024), (256, 256, 512),
                                   (128, 768, 1024)])
def test_tf32x3_logits_within_bound_of_fp64(m, d, v):
    """The split's logits, and the plain fp32 version's, within
    LOGIT_BOUND of fp64's; one TF32 pass (what a kernel that skipped the
    split would give) far outside it."""
    errs = _logit_errors(m, d, v)
    assert errs['tf32x3'] <= LOGIT_BOUND, errs
    assert errs['fp32'] <= LOGIT_BOUND, errs
    assert errs['one_pass'] > 10 * LOGIT_BOUND, errs


@pytest.mark.parametrize('temp', [1.0, 0.5])
def test_tf32x3_sampling_matches_plain_fed_philox(temp):
    """The split's logits through the sampling step, fed philox_gumbel's
    noise, against sample_head_reference fed the same: tokens equal on
    HEAD_TOKEN_SHARE of rows, Y within HEAD_Y_REL_TOL_FP32 where they are
    (chip_smoke.py's bounds for the kernel); the one-pass control's Y
    outside it."""
    m, d, v = 2048, 256, 512
    x, ln_w, ln_b, w, b = _inputs(m, d, v, seed=5)
    g1, g2 = S.philox_gumbel(20260516, m, v)
    y_ref, tok_ref = S.sample_head_reference(x, ln_w, ln_b, w, b, temp, g1,
                                             g2)

    def sample(logits):
        noised = logits + temp * g1
        tok = torch.argmax(noised + g2, dim=-1)
        chosen = noised.gather(1, tok[:, None])[:, 0]
        return torch.exp(chosen - torch.logsumexp(noised, -1)), tok

    y, tok = sample(head_logits_tf32x3(x, ln_w, ln_b, w, b))
    same = tok == tok_ref
    assert same.float().mean().item() >= HEAD_TOKEN_SHARE
    assert ((y - y_ref).abs() / y_ref)[same].max().item() <= \
        HEAD_Y_REL_TOL_FP32
    h = S.layer_norm_fp32(x, ln_w, ln_b)
    y1, tok1 = sample(S.round_tf32(h) @ S.round_tf32(w) + b)
    same1 = tok1 == tok_ref
    assert ((y1 - y_ref).abs() / y_ref)[same1].max().item() > \
        HEAD_Y_REL_TOL_FP32


@pytest.mark.parametrize('m,v,sms,runs', [
    (8192, 1024, 132, 2),   # 128 blocks, one wave
    (1000, 1024, 132, 8),   # 8 row tiles: every column tile its own block
    (32768, 1024, 132, 1),
    (8192, 384, 132, 3),
    (8192, 1024, 64, 1)])
def test_tf32_runs(m, v, sms, runs):
    assert S.tf32_runs(m, v, sms) == runs


def test_tf32x3_route_refuses_before_launch():
    """Forcing the split-TF32 route on a W it does not take, or with a W
    not in its prepared form (W^T), raises before any launch; W is
    prepared only for a CUDA W on that route."""
    x, ln_w, ln_b, w, b = _inputs(8, 64, 128)
    seed = torch.tensor([1], dtype=torch.int64)
    before = S.launches
    for bad in (w.bfloat16(), torch.zeros((64, 100))):
        with pytest.raises(ValueError, match='split-TF32 sample head takes'):
            S.sample_head_kernel(x, ln_w, ln_b, bad, torch.zeros(
                bad.shape[1]), 1.0, seed, 'tf32x3')
    with pytest.raises(ValueError, match='w_prepared must'):
        S.sample_head_kernel(x, ln_w, ln_b, w, b, 1.0, seed, 'tf32x3',
                             w_prepared=w)
    assert S.launches == before
    assert S.kernel_route(w) == 'tf32x3' and S.prepare_head_weight(w) is None


def test_sampler_prepares_head_weight_once_a_call(monkeypatch):
    """mask_predict prepares W once (W^T, which the split-TF32 kernel
    splits) and hands the same tensor to every round's sample head."""
    model, _ = factories.flagship(tiny=True, device='cpu', seed=0)
    cfg = model.cfg
    text = torch.randint(1, cfg.num_text_tokens, (2, cfg.text_seq_len),
                         generator=torch.Generator().manual_seed(0))
    ctrl = model.core.control_embedding(text).detach()
    pmask, n = ps.preserve_layout(cfg, 'long', 1, False)
    spec = ps.build_spec(dict(MP, T1_t=10, N1_t=1.0, N2_t=0.5), n, steps=5,
                         dynamic=False)
    sentinel = torch.zeros(1)
    prepared, seen = [], []
    real = ps.fused_sample_head

    def prepare(w):
        prepared.append(w)
        return sentinel

    def head(*args, w_prepared=None):
        seen.append(w_prepared)
        return real(*args)

    monkeypatch.setattr(ps, 'prepare_head_weight', prepare)
    monkeypatch.setattr(ps, 'fused_sample_head', head)
    for _ in range(2):
        ps.mask_predict(model.core, ctrl, torch.Generator().manual_seed(1),
                        spec, pmask)
    assert len(prepared) == 2     # one a call
    assert len(seen) == 2 * spec.Tmax and all(s is sentinel for s in seen)
    w = model.core.to_logits[1].weight
    assert all(p.shape == w.t().shape for p in prepared)   # W [D, V]
