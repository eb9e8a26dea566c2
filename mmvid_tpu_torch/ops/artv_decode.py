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
:func:`decode_token_step_reference`; a CUDA tensor launches a kernel (one
persistent cooperative launch a step) or raises.  The kernel is the
phased one (``csrc/artv_decode.cu``, five phases a layer over grid
barriers; fp32 and bf16, pos up to 8192) unless the caller asks for
``kernel='stream'``: the streaming kernel (``csrc/artv_decode_sm90.cu``:
weights copied ahead into a shared-memory ring, split-K proj, per-item
flags instead of grid barriers; bf16, D up to 1024, pos up to 4096),
which measured slower than the phased one at ART-V's batch 16 on the H100
(PERF.md).  Both take head dim 32 and 64, B from 1 to 64 and any W >=
pos.  A :class:`DecodeWorkspace`, made once per sampling call, holds the
checked params and the outputs and scratch, so a token step checks and
allocates nothing.
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
MAX_STREAM_DIM = 1024  # the streaming kernel holds an LN row in registers
MAX_STREAM_POS = 4096  # ... and a half block's logits in 16 KB
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
KERNELS = ('phased', 'stream')
SCRATCH_PER_ROW = 10     # floats of scratch per B x D (the larger kernel's)
_fns = {}
_barriers = {}           # the phased kernel's grid barrier, per device
# the streaming kernel's (flags and counters, next first stamp), per
# (device, stream)
_sync = {}


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
    :class:`DecodeParams`, once per sampling call: the weights in the
    blocks' compute dtype (JAX's ``cast_block``; a training build holds
    them in fp32), LayerNorm parameters and biases in fp32."""
    def stk(fn, f32=False):
        t = torch.stack([fn(b).detach().to(torch.float32 if f32 else b.dtype)
                         for b in blocks])
        return t.contiguous()
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


def _kernel(name: str):
    if name not in _fns:
        lib = _build.library()
        if name == 'phased':
            fn = lib.mmvid_artv_decode_step
            fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 7
                           + [ctypes.c_void_p] * 20)
        else:
            fn = lib.mmvid_artv_decode_step_sm90
            fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6
                           + [ctypes.c_void_p] * 19
                           + [ctypes.c_uint, ctypes.c_void_p])
            lib.mmvid_artv_decode_sync_words.argtypes = [ctypes.c_int] * 3
            lib.mmvid_artv_decode_sync_words.restype = ctypes.c_int
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check_params(p: DecodeParams, n_layers, d, dt, device):
    for name, t in p._asdict().items():
        shape = (n_layers,) + {'w_qkv': (3 * d, d), 'w_out': (d, d),
                               'w_fc': (4 * d, d), 'w_proj': (d, 4 * d),
                               'b_qkv': (3 * d,), 'b_fc': (4 * d,)}.get(
                                   name, (d,))
        dtype = dt if name.startswith('w_') else torch.float32
        _check_tensor(name, t, shape, dtype, device)


def _check_tensor(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f'{name} must be {dtype} {tuple(shape)}, got '
                         f'{t.dtype} {tuple(t.shape)}')
    if t.device != device or not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous on {device}')
    if t.data_ptr() % 16:
        raise ValueError(f'{name} must be 16-byte aligned')


def _check_shape(n_layers, b, w, d, dt, pos, heads, kernel):
    if dt not in _DTYPE_CODES:
        raise ValueError(f'the decode kernels take fp32 or bf16, not {dt}')
    if heads <= 0 or d % heads or d // heads not in _HEAD_DIMS:
        raise ValueError(f'head dim {d}/{heads} not in {_HEAD_DIMS}')
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f'batch {b} not in [1, {MAX_BATCH}]')
    if not 0 <= pos <= min(w, MAX_POS):
        raise ValueError(f'pos {pos} not in [0, min(W={w}, {MAX_POS})]')
    if kernel == 'stream' and (dt != torch.bfloat16 or d > MAX_STREAM_DIM
                               or pos > MAX_STREAM_POS):
        raise ValueError(f'the streaming decode kernel takes bf16 with D <= '
                         f'{MAX_STREAM_DIM} and pos <= {MAX_STREAM_POS}, not '
                         f'{dt} D {d} pos {pos}')


class DecodeWorkspace:
    """What a CUDA token step needs besides its inputs, made once per
    sampling call: ``p`` checked against (B, D, dtype), and y, k_new,
    v_new and the kernels' scratch allocated.  A step through a workspace
    returns these buffers, which the next step overwrites."""

    def __init__(self, p: DecodeParams, b: int, heads: int):
        n_layers, _, d = p.w_qkv.shape
        dt, device = p.w_qkv.dtype, p.w_qkv.device
        _check_shape(n_layers, b, 0, d, dt, 0, heads, None)
        _check_params(p, n_layers, d, dt, device)
        self.p, self.b, self.d, self.heads = p, b, d, heads
        self.n_layers, self.dtype, self.device = n_layers, dt, device
        self.param_ptrs = tuple(t.data_ptr() for t in p)
        self.y = torch.empty((b, d), dtype=torch.float32, device=device)
        self.k_new = torch.empty((n_layers, b, d), dtype=dt, device=device)
        self.v_new = torch.empty_like(self.k_new)
        self.scratch = torch.empty((b, SCRATCH_PER_ROW * d),
                                   dtype=torch.float32, device=device)
        self._caches = None   # the last (cache_k, cache_v) checked

    def check_step(self, x, p, cache_k, cache_v, pos, kernel):
        """The per-step checks: x, pos and kernel; the caches only when
        they are not the ones checked last."""
        if p is not self.p:
            raise ValueError('the workspace was made for other params')
        _check_tensor('x', x, (self.b, self.d), torch.float32, self.device)
        w = cache_k.shape[2] if cache_k.dim() == 4 else 0
        _check_shape(self.n_layers, self.b, w, self.d, self.dtype, pos,
                     self.heads, kernel)
        if self._caches is None or self._caches[0] is not cache_k or \
                self._caches[1] is not cache_v:
            shape = (self.n_layers, self.b, w, self.d)
            _check_tensor('cache_k', cache_k, shape, self.dtype, self.device)
            _check_tensor('cache_v', cache_v, shape, self.dtype, self.device)
            self._caches = (cache_k, cache_v)


def _stream_sync(device, stream: int, words: int, n_layers: int):
    """The streaming kernel's flags and counters for ``stream`` on
    ``device`` and this call's first stamp.  The kernel waits for a flag
    to equal a stamp of its own call, so every stamp it waits for must lie
    above every value the flags hold, whatever B, D or n_layers earlier
    calls had: the stamp grows by n_layers a call from 0 on zeroed words,
    and the words are zeroed anew when they must grow or the stamp would
    pass 2^32."""
    buf, stamp0 = _sync.get((device, stream), (None, 0))
    if buf is None or buf.numel() < words or stamp0 + n_layers >= 2 ** 32:
        buf = torch.zeros(max(words, 4096), dtype=torch.int32, device=device)
        stamp0 = 0
    _sync[(device, stream)] = (buf, stamp0 + n_layers)
    return buf, stamp0


def decode_token_step(x, p: DecodeParams, cache_k, cache_v, pos: int,
                      heads: int, workspace: DecodeWorkspace | None = None,
                      kernel: str | None = None):
    """One token through every block (see the module docstring).  x
    [B, D] fp32; ``p`` from :func:`stack_decode_params`; caches
    [n_layers, B, W, D] in the compute dtype, rows >= ``pos`` unread ->
    (y [B, D] fp32, k_new, v_new [n_layers, B, D]).  On the card,
    ``workspace`` (made for ``p``) saves the per-step checks and
    allocations, and ``kernel='stream'`` takes the streaming kernel
    instead of the phased one."""
    global launches
    if x.device.type == 'cpu':
        return decode_token_step_reference(x, p, cache_k, cache_v, pos,
                                           heads)
    if x.device.type != 'cuda':
        raise ValueError(f'no decode path for device {x.device}')
    if kernel is not None and kernel not in KERNELS:
        raise ValueError(f'kernel {kernel!r} not in {KERNELS}')
    kernel = kernel or 'phased'
    if workspace is None:
        workspace = DecodeWorkspace(p, x.shape[0], heads)
    ws = workspace
    ws.check_step(x, p, cache_k, cache_v, pos, kernel)
    n_layers, b, w, d = cache_k.shape
    stream = _build.stream_handle(x.device)
    if kernel == 'phased':
        if x.device not in _barriers:   # the kernel's grid barrier
            _barriers[x.device] = torch.zeros(2, dtype=torch.int32,
                                              device=x.device)
        rc = _kernel('phased')(
            x.data_ptr(), _DTYPE_CODES[cache_k.dtype], n_layers, b, d,
            heads, w, pos, *ws.param_ptrs, cache_k.data_ptr(),
            cache_v.data_ptr(), ws.y.data_ptr(), ws.k_new.data_ptr(),
            ws.v_new.data_ptr(), ws.scratch.data_ptr(),
            _barriers[x.device].data_ptr(), stream)
    else:
        fn = _kernel('stream')
        words = _build.library().mmvid_artv_decode_sync_words(b, d, heads)
        sync, stamp0 = _stream_sync(x.device, stream, words, n_layers)
        rc = fn(x.data_ptr(), n_layers, b, d, heads, w, pos,
                *ws.param_ptrs, cache_k.data_ptr(), cache_v.data_ptr(),
                ws.y.data_ptr(), ws.k_new.data_ptr(), ws.v_new.data_ptr(),
                ws.scratch.data_ptr(), sync.data_ptr(), stamp0, stream)
    _build.check(rc, 'ART-V decode step launch')
    launches += 1
    return ws.y, ws.k_new, ws.v_new
