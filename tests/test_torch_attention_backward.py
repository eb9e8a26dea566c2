"""Attention's backward kernels, emulated on the CPU, against the JAX
package's backward.

The port's backward on the card (``ops/attention.py::
attention_backward_kernel``) is hand-written kernels a route: bf16 on the
tensor cores (``csrc/attention_bwd_sm90.cu``) and fp32 on the tensor
cores in split TF32 (``csrc/attention_bwd_fp32_sm90.cu``).  Neither runs
here, so each route's arithmetic is emulated with its tile sizes and
order: the forward kernel's row statistics (64-key tiles, online max and
sum, the log-sum-exp in base 2), delta = g . O from the forward's output;
for bf16 the query pass (dQ summed over 64-key tiles in key order) and
the key pass (dK, dV over 64-query tiles in query order), S and dP from
bf16 operands with fp32 sums and P, dS split as hi = bf16(x), lo = bf16(x
- hi) against their bf16 partner; for fp32 the key pass over blocks of
128 keys and 32-query tiles, each product in split TF32 (hi = tf32(x), lo
= tf32(x - hi), lo.hi + hi.lo + hi.hi), a tile's dK and dV products
summed apart and then added to the sums, dQ's partial of each 64 keys (a
warpgroup's) summed, the first's plus the second's, a partial a block
and tile, then dQ, the partials summed in block order.  Each emulation is
held against ``jax.vjp`` through
``mmvid_tpu.ops.attention.fused_attention_blhd`` in interpret mode (its
``custom_vjp``, whose backward is XLA's VJP of ``_attention_xla``), on
inputs from a numpy seed: D 32 and 64, ragged L (29, 130), mask_prev with
a wholly masked first key tile (rows 100 and 101 of L 130), causal.

Tolerances, |got - want| <= tol * (1 + |want|) elementwise (the card's
``ATTN_BWD_TOL`` form):
- fp32: 1e-5.  Sums in another order, exp2 of the base-2 logits, delta
  from O instead of sum_j P dP, the products in split TF32 (about 2^-22
  of a term).  The control, each product one TF32 pass (operands rounded
  to TF32, no lo products), must exceed it.
- bf16, the gradients rounded to bf16 as the kernel stores them, against
  JAX's bf16 gradients: 1e-2, as the card holds the kernel to its plain
  version (a last-bit difference flips one bf16 rounding, 2^-8 of |x|;
  measured at most 1.5e-3 here).
- bf16 before that rounding, against JAX's fp32 gradients of the same
  bf16-valued inputs: 5e-5.  This checks what the split keeps: P and dS
  with about 16 bits, delta from O + O_lo, the forward's bf16 output and
  the rest of its fp32 output (measured at most 1.2e-5).  Two controls
  must exceed it: P and dS rounded once to bf16 (no lo product; at least
  1.5e-3 here), and delta from the bf16 O alone (at least 7e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvid_tpu.models.clip import build_attention_mask as jax_mask
from mmvid_tpu.ops.attention import fused_attention_blhd as jax_attention
from mmvid_tpu_torch.ops import attention as A
from mmvid_tpu_torch.ops.sample_head import round_tf32, split_tf32
from test_torch_attention import LOG2E, kernel_emulation, one_thread  # noqa: F401

TILE = 64
KEY_BLOCK = 128   # the fp32 key pass's keys a block
FP32_TILE = 32    # the fp32 key pass's queries a tile
WARPGROUP = 64    # keys of a warpgroup, whose dQ parts the fp32 pass sums
FP32_TOL = 1e-5
BF16_TOL = 1e-2
BF16_SPLIT_TOL = 5e-5

CASES = [(2, 29, 2, 32, 'mask_prev', (9, 10)),
         (2, 130, 2, 64, 'mask_prev', (100, 101)),
         (1, 130, 2, 32, 'causal', None),
         (1, 29, 3, 64, 'causal', None)]
IDS = ['L29_D32_mask_prev', 'L130_D64_first_tile_masked', 'L130_D32_causal',
       'L29_D64_causal']


def _bhld(t):
    return t.float().permute(0, 2, 1, 3)


def forward_lse(q, k, mask, bf16):
    """The forward kernels' row statistics, [B, H, L] fp32: log2 of the
    row's sum of 2^x over 64-key tiles with an online max, x the logits in
    base 2 as each kernel forms them (bf16: scale log2(e) . S + log2(e)
    mask; fp32: log2(e) (scale q . k + mask))."""
    d = q.shape[-1]
    scale = np.float32(d ** -0.5)
    if bf16:
        x = (_bhld(q) @ _bhld(k).transpose(-1, -2)
             * (scale * np.float32(LOG2E)) + mask * LOG2E)
    else:
        x = ((_bhld(q) * scale) @ _bhld(k).transpose(-1, -2) + mask) * LOG2E
    m = torch.full(x.shape[:3], -np.inf)
    s = torch.zeros(x.shape[:3])
    for k0 in range(0, x.shape[-1], TILE):
        xt = x[..., k0:k0 + TILE]
        m_new = torch.maximum(m, xt.amax(-1))
        s = s * torch.exp2(m - m_new) + torch.exp2(
            xt - m_new[..., None]).sum(-1)
        m = m_new
    return m + torch.log2(s)


def split(x, lo=True):
    """x as bf16 hi (+ bf16 lo = bf16(x - hi)), back in fp32."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if lo else (hi,)


def bf16_backward_emulation(q, k, v, mask, g, out, lo=True):
    """The bf16 route's two passes: (dq, dk, dv) fp32 [B, L, H, D] before
    the store's rounding.  ``out``: the O of delta (the kernel reads the
    forward's bf16 output plus the rest of its fp32 output); ``lo`` False:
    the control without the lo products."""
    d = q.shape[-1]
    scale = np.float32(d ** -0.5)
    scale_log2 = scale * np.float32(LOG2E)
    lse = forward_lse(q, k, mask, True)
    qf, kf, vf, gf = (_bhld(t) for t in (q, k, v, g))
    delta = (gf * _bhld(out)).sum(-1)
    mk = mask * LOG2E

    def mul(x, y):   # x split against its bf16 partner y
        return sum(p @ y for p in split(x, lo))

    # the query pass: dQ over the key tiles in key order
    dq = torch.zeros_like(qf)
    for k0 in range(0, q.shape[1], TILE):
        kt, vt = kf[..., k0:k0 + TILE, :], vf[..., k0:k0 + TILE, :]
        p = torch.exp2(qf @ kt.transpose(-1, -2) * scale_log2
                       + mk[:, k0:k0 + TILE] - lse[..., None])
        ds = p * (gf @ vt.transpose(-1, -2) - delta[..., None])
        dq = dq + mul(ds, kt)
    # the key pass: dK, dV over the query tiles in query order (keys x
    # queries, as the kernel holds S^T)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, q.shape[1], TILE):
        qt, gt = qf[..., q0:q0 + TILE, :], gf[..., q0:q0 + TILE, :]
        p = torch.exp2(kf @ qt.transpose(-1, -2) * scale_log2
                       + mk[q0:q0 + TILE].t() - lse[..., None, q0:q0 + TILE])
        ds = p * (vf @ gt.transpose(-1, -2) - delta[..., None, q0:q0 + TILE])
        dv = dv + mul(p, gt)
        dk = dk + mul(ds, qt)
    return tuple(t.permute(0, 2, 1, 3) for t in (dq * scale, dk * scale, dv))


def tf32x3(a, b):
    """a @ b in split TF32, as the fp32 kernel's wgmma products: each
    operand split, a_lo b_hi + a_hi b_lo + a_hi b_hi with fp32 sums."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def tf32x1(a, b):
    """a @ b in one TF32 pass: the control without the lo products."""
    return round_tf32(a) @ round_tf32(b)


def fp32_backward_emulation(q, k, v, mask, g, out, mul=tf32x3):
    """The fp32 route's three launches: delta; per block of 128 keys, the
    32-query tiles in order (S^T = K.Q^T, dP^T = V.G^T over D; P^T, dS^T;
    each tile's dV and dK products summed apart, then added to the sums;
    dQ^T's part of each 64 keys, the first's plus the second's, the
    tile's partial); dQ = scale x the blocks' partials summed in block
    order.  Every product through ``mul`` (split TF32; the control passes
    ``tf32x1``).  (dq, dk, dv) fp32 [B, L, H, D]."""
    d, n = q.shape[-1], q.shape[1]
    scale = np.float32(d ** -0.5)
    lse = forward_lse(q, k, mask, False)
    qf, kf, vf, gf = (_bhld(t) for t in (q, k, v, g))
    delta = (gf * _bhld(out)).sum(-1)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    parts = []
    for k0 in range(0, n, KEY_BLOCK):
        kb = slice(k0, k0 + KEY_BLOCK)
        kt, vt = kf[..., kb, :], vf[..., kb, :]
        part = torch.zeros_like(qf)
        for q0 in range(0, n, FP32_TILE):
            qs = slice(q0, q0 + FP32_TILE)
            qt, gt = qf[..., qs, :], gf[..., qs, :]
            x = (mul(kt, qt.transpose(-1, -2)) * scale
                 + mask[qs, kb].t()) * LOG2E
            p = torch.exp2(x - lse[..., None, qs])
            ds = p * (mul(vt, gt.transpose(-1, -2)) - delta[..., None, qs])
            dv[..., kb, :] += mul(p, gt)
            dk[..., kb, :] += mul(ds, qt)
            dqt = None
            for w0 in range(0, kt.shape[-2], WARPGROUP):
                ws = slice(w0, w0 + WARPGROUP)
                y = mul(kt[..., ws, :].transpose(-1, -2), ds[..., ws, :])
                dqt = y if dqt is None else dqt + y
            part[..., qs, :] = dqt.transpose(-1, -2)
        parts.append(part)
    dq = parts[0]
    for part in parts[1:]:
        dq = dq + part
    return tuple(t.permute(0, 2, 1, 3) for t in (dq * scale, dk * scale, dv))


def _inputs(b, l, h, d, kind, idx, seed):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(b, l, h, d).astype(np.float32) for _ in range(4)]
    mask = np.array(jax_mask(l, kind, index=idx))
    return xs, mask


_JAX_VJP = {}


def jax_grads(xs, mask, dtype):
    """JAX's dq, dk, dv (fp32 numpy) of fused_attention_blhd in interpret
    mode at the cotangent xs[3], inputs cast to ``dtype``."""
    key = (tuple(xs[0].shape), dtype)
    if key not in _JAX_VJP:
        def grads(q, k, v, m, g):
            return jax.vjp(lambda a, b, c: jax_attention(a, b, c, m,
                                                         interpret=True),
                           q, k, v)[1](g)
        _JAX_VJP[key] = jax.jit(grads)
    args = [jnp.asarray(x).astype(dtype) for x in xs]
    out = _JAX_VJP[key](*args[:3], jnp.asarray(mask), args[3])
    return [np.asarray(t.astype(jnp.float32)) for t in out]


def _rel(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else got
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


@pytest.mark.parametrize('b,l,h,d,kind,idx', CASES, ids=IDS)
def test_fp32_route_emulation_matches_jax(one_thread, b, l, h, d, kind, idx):
    xs, mask = _inputs(b, l, h, d, kind, idx, l + d)
    q, k, v, g = (torch.from_numpy(x) for x in xs)
    m = torch.from_numpy(mask)
    out = A.attention_reference(q, k, v, m, d ** -0.5)
    got = fp32_backward_emulation(q, k, v, m, g, out)
    want = jax_grads(xs, mask, jnp.float32)
    errs = [_rel(x, w) for x, w in zip(got, want)]
    assert max(errs) <= FP32_TOL, errs
    # one TF32 pass a product is not enough
    control = fp32_backward_emulation(q, k, v, m, g, out, mul=tf32x1)
    errs_c = [_rel(x, w) for x, w in zip(control, want)]
    assert max(errs_c) > FP32_TOL, errs_c


@pytest.mark.parametrize('b,l,h,d,kind,idx', CASES, ids=IDS)
def test_bf16_route_emulation_matches_jax(one_thread, b, l, h, d, kind, idx):
    """The bf16 route: its stored gradients against JAX's bf16 ones, and
    its fp32 sums against JAX's fp32 gradients of the same bf16 values;
    the controls (no lo products; delta from the bf16 O alone) fall
    outside the latter."""
    xs, mask = _inputs(b, l, h, d, kind, idx, 2 * l + d)
    xs = [torch.from_numpy(x).bfloat16().float().numpy() for x in xs]
    q, k, v, g = (torch.from_numpy(x).bfloat16() for x in xs)
    m = torch.from_numpy(mask)
    o32 = kernel_emulation(q, k, v, m, fp32_out=True)
    out, out_lo = split(o32)
    got = bf16_backward_emulation(q, k, v, m, g, out + out_lo)
    want16 = jax_grads(xs, mask, jnp.bfloat16)
    errs16 = [_rel(x.bfloat16(), w) for x, w in zip(got, want16)]
    assert max(errs16) <= BF16_TOL, errs16
    want32 = jax_grads(xs, mask, jnp.float32)
    errs = [_rel(x, w) for x, w in zip(got, want32)]
    assert max(errs) <= BF16_SPLIT_TOL, errs
    for control in (
            bf16_backward_emulation(q, k, v, m, g, out + out_lo, lo=False),
            bf16_backward_emulation(q, k, v, m, g, out)):
        errs_c = [_rel(x, w) for x, w in zip(control, want32)]
        assert max(errs_c) > BF16_SPLIT_TOL, errs_c


def test_stats_stride_whole_tiles():
    """The row statistics' row stride: L rounded up to a 64-key tile (the
    key pass reads a tile's lse and delta whole)."""
    assert [A.stats_stride(n) for n in (1, 64, 65, 565, 629)] == [
        64, 64, 128, 576, 640]
