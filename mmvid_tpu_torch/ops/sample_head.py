"""Fused LN -> to_logits -> Gumbel sampling head: the plain PyTorch version
and the wrapper of the hand-written CUDA kernels (``csrc/sample_head*.cu``).

Counterpart of ``mmvid_tpu/ops/sample_head.py``.  Per row of x [M, D]:

    h      = LN(x) rounded to W's dtype;  logits = h @ W + b  (fp32 sums)
    noised = logits + temp * G1;          tok = argmax(noised + G2)
    Y      = exp(noised[tok] - logsumexp(noised))

Dispatch rule of :func:`fused_sample_head`: a CPU tensor draws G1 and G2
from the caller's generator and goes to :func:`sample_head_reference`; a
CUDA tensor draws one seed from the generator (on the device, no host
sync) and launches a kernel, which makes its noise with Philox keyed by
(seed, row, column), or raises.  :func:`philox_gumbel` is the plain version
of that noise: fed its draws, :func:`sample_head_reference` gives the
kernels' tokens.

Three routes, chosen by :func:`kernel_route`: bf16 W with D a multiple
of 64 up to 960 and V a multiple of 256 (every full-width model: D 768, V
1024) takes the tensor-core kernel (``csrc/sample_head_sm90.cu``,
``wgmma``, ``'wgmma'``); fp32 W with D a multiple of 64 up to 1024 and V a
multiple of 128 (every full-width model in fp32, the released recipes'
precision) the split-TF32 kernels (``csrc/sample_head_tf32_sm90.cu``,
``'tf32x3'``: two launches, the logits on the tensor cores, then the
sampling), which read W's TF32 split made once by
:func:`prepare_head_weight`; every other shape the CUDA-core kernel
(``csrc/sample_head.cu``, ``'cuda_cores'``).  All draw the same noise from
one seed.  :func:`round_tf32` is the kernels' TF32 rounding by integer bit
operations.
"""

from __future__ import annotations

import ctypes

import torch

from mmvid_tpu_torch.ops import _build

# Kernel launches since the last reset (read by chip_smoke.py): one a
# call, two on the split-TF32 route (the logits, then the sampling).
launches = 0

_W_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ('wgmma', 'tf32x3', 'cuda_cores')
_fns = {}
# the split-TF32 route's tiles: 128 rows by 128 columns, D by 64 up to
# 1024
TF32_ROWS = TF32_COLS = 128
_TF32_MAX_D = 1024
_sm_counts = {}

# Philox4x32-10 (Salmon et al., Random123), the kernels' round constants
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def gumbel(shape, generator, device=None, eps: float = 1e-20):
    """Gumbel(0, 1) noise from ``generator`` (``_gumbel`` of
    mmvid_tpu/models/sampler.py: u ~ U[eps, 1), -log(-log(u) + eps))."""
    u = torch.rand(shape, generator=generator, device=device)
    u = eps + (1.0 - eps) * u
    return -torch.log(-torch.log(u) + eps)


def _mulhilo32(a: int, b):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a``
    and the int64 tensor ``b`` (values < 2^32), in int64 arithmetic that
    never overflows: ``a`` split into 16-bit halves."""
    p1 = (a >> 16) * b          # < 2^48
    p0 = (a & 0xFFFF) * b       # < 2^48
    low = ((p1 & 0xFFFF) << 16) + p0   # < 2^49
    return (p1 >> 16) + (low >> 32), low & _MASK32


def philox4x32_10(ctr, key):
    """Philox4x32-10 of counters ``ctr`` (4 int64 tensors of 32-bit values)
    under ``key`` (2 ints) -> 4 int64 tensors of 32-bit words, as the
    kernels' ``philox4x32_10`` (csrc/sample_head.cuh) computes them."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & _MASK32
        k1 = (k1 + PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def gumbel_from_bits(bits):
    """Gumbel(0, 1) in fp32 from 32-bit words (int64 tensor), as the
    kernels make it: u = (bits >> 8) * 2^-24 + 2^-25, -log(-log(u + eps) +
    eps), eps 1e-20."""
    u = (bits >> 8).float() * (1.0 / 16777216.0) + (1.0 / 33554432.0)
    return -torch.log(-torch.log(u + 1e-20) + 1e-20)


def philox_gumbel(seed: int, m: int, v: int, device=None):
    """The kernels' noise for rows 0 .. m and columns 0 .. v under
    ``seed``: (G1, G2) [m, v] fp32 from the first and second Philox words
    of counter (column, row, 0, 0), key (seed low, seed high)."""
    seed = int(seed)
    col = torch.arange(v, dtype=torch.int64, device=device)[None].expand(
        m, v)
    row = torch.arange(m, dtype=torch.int64, device=device)[:, None].expand(
        m, v)
    zero = torch.zeros((m, v), dtype=torch.int64, device=device)
    w0, w1, _, _ = philox4x32_10((col, row, zero, zero),
                                 (seed & _MASK32, (seed >> 32) & _MASK32))
    return gumbel_from_bits(w0), gumbel_from_bits(w1)


def layer_norm_fp32(x, ln_w, ln_b):
    """LN(x) in fp32 (eps 1e-5, two-pass statistics), the head's h."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * ln_w.float() + ln_b.float()


def head_logits(x, ln_w, ln_b, w, b):
    """LN(x) rounded to w's dtype, @ w + b, summed in fp32 -> [M, V]."""
    h = layer_norm_fp32(x, ln_w, ln_b)
    return h.to(w.dtype).float() @ w.float() + b.float()


def round_tf32(t):
    """fp32 ``t`` rounded to TF32 (10 mantissa bits, the 13 low bits
    cleared), to nearest with ties away from zero, as ``cvt.rna.tf32.f32``
    rounds: on the bits, + 2^12 then the low 13 cleared."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t):
    """(hi, lo): ``t``'s TF32 rounding and its remainder's, t ~ hi + lo to
    about 2^-22 of |t|."""
    hi = round_tf32(t)
    return hi, round_tf32(t.float() - hi)


def sample_head_reference(x, ln_w, ln_b, w, b, temp, g1, g2):
    """x [M, D] fp32; ln_w, ln_b [D]; w [D, V]; b [V]; g1, g2 [M, V] noise.
    Returns (Y [M] fp32, tok [M] int64)."""
    noised = head_logits(x, ln_w, ln_b, w, b) + temp * g1
    tok = torch.argmax(noised + g2, dim=-1)
    lse = torch.logsumexp(noised, dim=-1)
    chosen = torch.gather(noised, -1, tok[:, None])[:, 0]
    return torch.exp(chosen - lse), tok


def _kernel(route: str):
    if route not in _fns:
        lib = _build.library()
        if route == 'wgmma':
            fn = lib.mmvid_sample_head_sm90
            fn.argtypes = ([ctypes.c_void_p] * 5
                           + [ctypes.c_float, ctypes.c_void_p]
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
        elif route == 'tf32x3':
            fn = lib.mmvid_sample_head_tf32
            fn.argtypes = ([ctypes.c_void_p] * 6
                           + [ctypes.c_float, ctypes.c_void_p]
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4)
        else:
            fn = lib.mmvid_sample_head
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                           + [ctypes.c_float, ctypes.c_void_p]
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _fns[route] = fn
    return _fns[route]


def kernel_route(w) -> str:
    """The kernel a CUDA call takes for W [D, V]: ``'wgmma'`` for bf16 W
    with D a multiple of 64 up to 960 and V a multiple of 256;
    ``'tf32x3'`` for fp32 W with D a multiple of 64 up to 1024 and V a
    multiple of 128; else ``'cuda_cores'``."""
    d, v = w.shape
    if (w.dtype == torch.bfloat16 and d % 64 == 0 and d <= 960
            and v % 256 == 0):
        return 'wgmma'
    if (w.dtype == torch.float32 and d % 64 == 0 and d <= _TF32_MAX_D
            and v % TF32_COLS == 0):
        return 'tf32x3'
    return 'cuda_cores'


def _check_cuda_args(x, ln_w, ln_b, w, b):
    m, d = x.shape
    if w.dim() != 2 or w.shape[0] != d:
        raise ValueError(f'w must be [D={d}, V], got {tuple(w.shape)}')
    v = w.shape[1]
    if x.dtype != torch.float32:
        raise ValueError(f'x must be fp32, got {x.dtype}')
    if w.dtype not in _W_DTYPE_CODES:
        raise ValueError(f'w must be fp32 or bf16, got {w.dtype}')
    if d % 4:
        raise ValueError(f'D={d} must be a multiple of 4')
    for name, t, shape in (('ln_w', ln_w, (d,)), ('ln_b', ln_b, (d,)),
                           ('b', b, (v,))):
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f'{name} must be fp32 {shape}, got '
                             f'{t.dtype} {tuple(t.shape)}')
    for name, t in (('x', x), ('ln_w', ln_w), ('ln_b', ln_b), ('w', w),
                    ('b', b)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous on {x.device}')


def prepare_head_weight(w):
    """W in the form the split-TF32 kernel reads, made once for the calls
    that share W (the sampler's rounds): (hi, lo), W^T [V, D] (K-major,
    the kernel's B operand) split by :func:`split_tf32`, for a CUDA W that
    takes the ``'tf32x3'`` route; None for any other W (the other routes
    read W as it is).  Pass it to :func:`fused_sample_head` as
    ``w_prepared``."""
    if w.device.type != 'cuda' or kernel_route(w) != 'tf32x3':
        return None
    return split_tf32(w.t().contiguous())


def _check_prepared(w_prepared, w):
    d, v = w.shape
    if not (isinstance(w_prepared, tuple) and len(w_prepared) == 2 and all(
            t.shape == (v, d) and t.dtype == torch.float32
            and t.device == w.device and t.is_contiguous()
            and t.data_ptr() % 16 == 0 for t in w_prepared)):
        raise ValueError(f'w_prepared must be prepare_head_weight(w): two '
                         f'contiguous, 16-byte aligned fp32 [V={v}, D={d}] '
                         f'on {w.device}')


def tf32_runs(m: int, v: int, sms: int) -> int:
    """The column runs the split-TF32 logits kernel cuts a row tile into
    (a divisor of V / 128): the fewest waves of blocks times the tiles a
    block walks, plus a quarter tile for its prologue (the rows' LN
    statistics), which nothing overlaps."""
    n_tiles = v // TF32_COLS
    row_tiles = -(-m // TF32_ROWS)
    return min((r for r in range(1, n_tiles + 1) if n_tiles % r == 0),
               key=lambda r: (-(-row_tiles * r // sms)
                              * (n_tiles / r + 0.25), r))


def _sm_count(device) -> int:
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_counts[device]


def sample_head_kernel(x, ln_w, ln_b, w, b, temp: float, seed,
                       route: str | None = None, w_prepared=None):
    """Launch a sample-head kernel on CUDA tensors with the noise seed
    ``seed`` (an int64 tensor [1] on x's device): ``route`` None takes
    :func:`kernel_route`'s; a name of :data:`ROUTES` forces one (the
    tensor-core kernels raise on a shape they do not take).  The
    ``'tf32x3'`` route reads ``w_prepared`` (:func:`prepare_head_weight`'s;
    made here when None).  Returns (Y [M] fp32, tok [M] int64)."""
    global launches
    _check_cuda_args(x, ln_w, ln_b, w, b)
    route = route or kernel_route(w)
    if route not in ROUTES:
        raise ValueError(f'route {route!r} not in {ROUTES}')
    if route == 'wgmma' and kernel_route(w) != 'wgmma':
        raise ValueError(f'the tensor-core sample head takes bf16 W with D '
                         f'% 64 == 0, D <= 960 and V % 256 == 0, not '
                         f'{w.dtype} {tuple(w.shape)}')
    if route == 'tf32x3' and kernel_route(w) != 'tf32x3':
        raise ValueError(f'the split-TF32 sample head takes fp32 W with D '
                         f'% 64 == 0, D <= {_TF32_MAX_D} and V % '
                         f'{TF32_COLS} == 0, not {w.dtype} '
                         f'{tuple(w.shape)}')
    m, d = x.shape
    v = w.shape[1]
    if route == 'cuda_cores' and 16 * (d + v) * 4 > 227 * 1024:
        raise ValueError(f'D + V = {d + v} exceeds the CUDA-core kernel\'s '
                         f'shared-memory tile')
    if route == 'wgmma' and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError('the tensor-core sample head needs x and w 16-byte '
                         'aligned')
    if route == 'tf32x3':
        if w_prepared is None:
            w_prepared = prepare_head_weight(w)
        _check_prepared(w_prepared, w)
        if x.data_ptr() % 16 or b.data_ptr() % 16:
            raise ValueError('the split-TF32 sample head needs x and b '
                             '16-byte aligned')
    if (seed.device != x.device or seed.dtype != torch.int64
            or seed.numel() != 1):
        raise ValueError('seed must be one int64 on x\'s device')
    y = torch.empty((m,), dtype=torch.float32, device=x.device)
    tok = torch.empty((m,), dtype=torch.int64, device=x.device)
    stream = _build.stream_handle(x.device)
    if route == 'tf32x3':   # two launches: the logits, then the sampling
        logits = torch.empty((m, v), dtype=torch.float32, device=x.device)
        rc = _kernel(route)(
            x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
            w_prepared[0].data_ptr(), w_prepared[1].data_ptr(),
            b.data_ptr(), float(temp), seed.data_ptr(), m, d, v,
            tf32_runs(m, v, _sm_count(x.device)), logits.data_ptr(),
            y.data_ptr(), tok.data_ptr(), stream)
    else:
        args = (x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                w.data_ptr(), b.data_ptr(), float(temp), seed.data_ptr(), m,
                d, v, y.data_ptr(), tok.data_ptr(), stream)
        if route == 'wgmma':
            rc = _kernel(route)(*args)
        else:
            rc = _kernel(route)(_W_DTYPE_CODES[w.dtype], *args)
    _build.check(rc, 'sample-head kernel launch')
    launches += 2 if route == 'tf32x3' else 1
    return y, tok


def fused_sample_head(x, ln_w, ln_b, w, b, temp: float, generator, *,
                      w_prepared=None):
    """x [M, D] hidden rows (fp32); LN params [D]; w [D, V]; b [V];
    temp a float; generator a torch.Generator on x's device;
    ``w_prepared`` :func:`prepare_head_weight`'s result for w, made once by
    a caller that calls with one W many times (the CPU path ignores it).
    Returns (Y [M] fp32, tok [M] int64)."""
    m = x.shape[0]
    v = w.shape[1]
    if x.device.type == 'cpu':
        g1 = gumbel((m, v), generator)
        g2 = gumbel((m, v), generator)
        return sample_head_reference(x, ln_w, ln_b, w, b, temp, g1, g2)
    if x.device.type != 'cuda':
        raise ValueError(f'no sample-head path for device {x.device}')
    seed = torch.randint(0, 2 ** 62, (1,), generator=generator,
                         device=x.device, dtype=torch.int64)
    return sample_head_kernel(x, ln_w, ln_b, w, b, temp, seed,
                              w_prepared=w_prepared)
