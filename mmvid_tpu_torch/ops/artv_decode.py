"""One whole ART-V decode step (every block, one token): the plain PyTorch
version and the wrapper of the hand-written CUDA kernels
(``csrc/artv_decode.cu``).

Counterpart of ``mmvid_tpu/ops/artv_decode.py``.  Per block, for x [B, D]
fp32 and the block's caches [B, W, D] (rows >= pos not read):

    h      = LN1(x)   fp32 two-pass statistics, mean((x - mu)^2), eps 1e-5
    q|k|v  = h @ Wqkv + bqkv   (h rounded to the weight dtype, fp32 sums,
             fp32 bias);  q *= hd^-0.5;  k_new, v_new = k, v rounded to the
             cache dtype
    logits = per head: the current token q . k_new (fp32 q), the cache rows
             j < pos q_r . K[j] (q rounded to the cache dtype)
    attn   = softmax over [current, rows < pos] in fp32; the AV product
             takes the cache rows' probabilities rounded to the cache
             dtype, the current token's unrounded v in fp32
    x      = x + (ctx @ Wout + bout)   (ctx rounded)
    h2     = LN2(x); for 4 column chunks c of the MLP:
             x += bf16(QuickGELU(h2 @ Wfc_c + bfc_c)) @ Wproj_c
    x      = x + bproj

and returns (y [B, D] fp32, k_new, v_new [n_layers, B, D]).  The caller
writes the caches (one write per token for all layers).  The softmax here
is taken against its global max; the TPU kernel's online form differs only
in where the cache-dtype rounding of the probabilities falls.

Dispatch rule of :func:`decode_token_step`: a CPU tensor goes to
:func:`decode_token_step_reference`; a CUDA tensor launches the kernel
(one persistent cooperative launch a step) or raises.  The kernel takes
fp32 and bf16, head dim 32 and 64, B from 1 to 64 and any W >= pos.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from mmvid_tpu_torch.ops import _build

# Kernel launches since the last reset, one per token step (read by
# chip_smoke.py).
launches = 0

MLP_CHUNKS = 4
MAX_BATCH = 64
MAX_POS = 8192           # the attention kernel keeps pos fp32 logits in 32 KB
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
_fn = None
_barriers = {}


class DecodeParams(NamedTuple):
    """The blocks' params stacked on a leading n_layers axis, in the
    torch Linear layout the kernels read ([out, in] weights in the compute
    dtype; LayerNorm params and biases fp32)."""
    ln1_w: torch.Tensor   # [L, D]
    ln1_b: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    w_qkv: torch.Tensor   # [L, 3D, D]
    b_qkv: torch.Tensor   # [L, 3D]
    w_out: torch.Tensor   # [L, D, D]
    b_out: torch.Tensor   # [L, D]
    w_fc: torch.Tensor    # [L, 4D, D]
    b_fc: torch.Tensor    # [L, 4D]
    w_proj: torch.Tensor  # [L, D, 4D]
    b_proj: torch.Tensor  # [L, D]


def stack_decode_params(blocks) -> DecodeParams:
    """Stack ``ResidualAttentionBlock``s (models/clip.py) into
    :class:`DecodeParams`, once per sampling call."""
    def stk(fn, f32=False):
        t = torch.stack([fn(b).detach() for b in blocks])
        return (t.float() if f32 else t).contiguous()
    return DecodeParams(
        stk(lambda b: b.ln_1.weight, True), stk(lambda b: b.ln_1.bias, True),
        stk(lambda b: b.ln_2.weight, True), stk(lambda b: b.ln_2.bias, True),
        stk(lambda b: b.attn.in_proj_weight),
        stk(lambda b: b.attn.in_proj_bias, True),
        stk(lambda b: b.attn.out_proj.weight),
        stk(lambda b: b.attn.out_proj.bias, True),
        stk(lambda b: b.mlp.c_fc.weight), stk(lambda b: b.mlp.c_fc.bias, True),
        stk(lambda b: b.mlp.c_proj.weight),
        stk(lambda b: b.mlp.c_proj.bias, True))


def random_inputs(n_layers: int, b: int, w: int, d: int, dtype, generator,
                  device=None):
    """Seeded inputs of one step at a shape, for the kernel checks: (x
    [B, D], DecodeParams with N(0, 1/fan_in) weights, LayerNorm params
    near (1, 0) and small biases, caches [n_layers, B, W, D] N(0, 1))."""
    def randn(*shape, scale=1.0, shift=0.0, dt=torch.float32):
        t = torch.randn(shape, generator=generator, device=device)
        return (t * scale + shift).to(dt)
    x = randn(b, d)
    p = DecodeParams(
        randn(n_layers, d, scale=0.1, shift=1.0), randn(n_layers, d,
                                                        scale=0.1),
        randn(n_layers, d, scale=0.1, shift=1.0), randn(n_layers, d,
                                                        scale=0.1),
        randn(n_layers, 3 * d, d, scale=d ** -0.5, dt=dtype),
        randn(n_layers, 3 * d, scale=0.1),
        randn(n_layers, d, d, scale=d ** -0.5, dt=dtype),
        randn(n_layers, d, scale=0.1),
        randn(n_layers, 4 * d, d, scale=d ** -0.5, dt=dtype),
        randn(n_layers, 4 * d, scale=0.1),
        randn(n_layers, d, 4 * d, scale=(4 * d) ** -0.5, dt=dtype),
        randn(n_layers, d, scale=0.1))
    cache_k = randn(n_layers, b, w, d, dt=dtype)
    cache_v = randn(n_layers, b, w, d, dt=dtype)
    return x, p, cache_k, cache_v


def layer_params(p: DecodeParams, i: int) -> DecodeParams:
    """Block ``i`` alone, as a one-layer DecodeParams (views)."""
    return DecodeParams(*(t[i:i + 1] for t in p))


def _ln(x, w, b):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * w + b


def decode_token_step_reference(x, p: DecodeParams, cache_k, cache_v,
                                pos: int, heads: int):
    """x [B, D]; caches [n_layers, B, W, D] -> (y [B, D] fp32, k_new,
    v_new [n_layers, B, D] in the caches' dtype): the module docstring's
    math."""
    n_layers, b, _, d = cache_k.shape
    hd, dt = d // heads, cache_k.dtype
    x = x.float()

    def rnd(t):  # rounded to the compute dtype, computed on in fp32
        return t.to(dt).float()

    k_out, v_out = [], []
    for i in range(n_layers):
        h = rnd(_ln(x, p.ln1_w[i], p.ln1_b[i]))
        qkv = h @ p.w_qkv[i].float().t() + p.b_qkv[i]
        q = qkv[:, :d] * (hd ** -0.5)
        k_new, v = qkv[:, d:2 * d].to(dt), qkv[:, 2 * d:]
        qh = q.view(b, heads, hd)
        s_cur = (qh * k_new.float().view(b, heads, hd)).sum(-1)   # [B, H]
        kc = cache_k[i, :, :pos].float().view(b, pos, heads, hd)
        vc = cache_v[i, :, :pos].float().view(b, pos, heads, hd)
        s = torch.einsum('bhd,bjhd->bhj', rnd(qh), kc)
        m = torch.maximum(s_cur, s.amax(-1)) if pos else s_cur
        p_cur = torch.exp(s_cur - m)
        p_row = torch.exp(s - m[..., None])
        acc = (p_cur[..., None] * v.view(b, heads, hd)
               + torch.einsum('bhj,bjhd->bhd', rnd(p_row), vc))
        ctx = acc / (p_cur + p_row.sum(-1))[..., None]
        x = x + (rnd(ctx.reshape(b, d)) @ p.w_out[i].float().t()
                 + p.b_out[i])
        h2 = rnd(_ln(x, p.ln2_w[i], p.ln2_b[i]))
        c = p.w_fc.shape[1] // MLP_CHUNKS
        for j in range(MLP_CHUNKS):
            cols = slice(j * c, (j + 1) * c)
            f = h2 @ p.w_fc[i, cols].float().t() + p.b_fc[i, cols]
            g = rnd(f * torch.sigmoid(1.702 * f))
            x = x + g @ p.w_proj[i, :, cols].float().t()
        x = x + p.b_proj[i]
        k_out.append(k_new)
        v_out.append(v.to(dt))
    return x, torch.stack(k_out), torch.stack(v_out)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library().mmvid_artv_decode_step
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 20)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_cuda_args(x, p: DecodeParams, cache_k, cache_v, pos, heads):
    n_layers, b, w, d = cache_k.shape
    dt = cache_k.dtype
    if dt not in _DTYPE_CODES:
        raise ValueError(f'the decode kernels take fp32 or bf16, not {dt}')
    if heads <= 0 or d % heads or d // heads not in _HEAD_DIMS:
        raise ValueError(f'head dim {d}/{heads} not in {_HEAD_DIMS}')
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f'batch {b} not in [1, {MAX_BATCH}]')
    if not 0 <= pos <= min(w, MAX_POS):
        raise ValueError(f'pos {pos} not in [0, min(W={w}, {MAX_POS})]')
    shapes = {'x': (x, (b, d), torch.float32),
              'cache_v': (cache_v, cache_k.shape, dt)}
    for name, t in p._asdict().items():
        lead = (n_layers,) + {'w_qkv': (3 * d, d), 'w_out': (d, d),
                              'w_fc': (4 * d, d), 'w_proj': (d, 4 * d),
                              'b_qkv': (3 * d,), 'b_fc': (4 * d,)}.get(
                                  name, (d,))
        shapes[name] = (t, lead, dt if name.startswith('w_')
                        else torch.float32)
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f'{name} must be {dtype} {tuple(shape)}, got '
                             f'{t.dtype} {tuple(t.shape)}')
    for name, t in [('cache_k', cache_k)] + [(n, v[0])
                                             for n, v in shapes.items()]:
        if t.device != cache_k.device or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous on '
                             f'{cache_k.device}')
        if t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')


def decode_token_step(x, p: DecodeParams, cache_k, cache_v, pos: int,
                      heads: int):
    """One token through every block (see the module docstring).  x
    [B, D] fp32; ``p`` from :func:`stack_decode_params`; caches
    [n_layers, B, W, D] in the compute dtype, rows >= ``pos`` unread ->
    (y [B, D] fp32, k_new, v_new [n_layers, B, D])."""
    global launches
    if x.device.type == 'cpu':
        return decode_token_step_reference(x, p, cache_k, cache_v, pos,
                                           heads)
    if x.device.type != 'cuda':
        raise ValueError(f'no decode path for device {x.device}')
    _check_cuda_args(x, p, cache_k, cache_v, pos, heads)
    n_layers, b, w, d = cache_k.shape
    dt = cache_k.dtype
    y = torch.empty((b, d), dtype=torch.float32, device=x.device)
    k_new = torch.empty((n_layers, b, d), dtype=dt, device=x.device)
    v_new = torch.empty_like(k_new)
    # q, v (fp32), the attention context and the MLP activations
    scratch = torch.empty((b, 7 * d), dtype=torch.float32, device=x.device)
    if x.device not in _barriers:   # the kernel's grid barrier
        _barriers[x.device] = torch.zeros(2, dtype=torch.int32,
                                          device=x.device)
    rc = _kernel()(x.data_ptr(), _DTYPE_CODES[dt], n_layers, b, d, heads,
                   w, pos, *(t.data_ptr() for t in p),
                   cache_k.data_ptr(), cache_v.data_ptr(), y.data_ptr(),
                   k_new.data_ptr(), v_new.data_ptr(), scratch.data_ptr(),
                   _barriers[x.device].data_ptr(),
                   _build.stream_handle(x.device))
    _build.check(rc, 'ART-V decode step launch')
    launches += 1
    return y, k_new, v_new
