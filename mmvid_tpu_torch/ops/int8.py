"""w8a8 int8 serving quantization: calibration records, quantized dense
and conv products, and the functions that build serving models.

Counterpart of ``mmvid_tpu/ops/int8.py``, with the same formulas in the
same order:

* weights: per-output-channel symmetric scales ``max|W| / 127`` (floored
  at 1e-8), ``round(W / w_scale)`` to int8, from the unquantized weights
  (checkpoints and the parameter tree are untouched): at every call, as
  in JAX, or once, when :func:`quantized_model` / :func:`quantized_vae`
  build a serving copy (:func:`freeze_weights`);
* activations: a STATIC per-site scale ``a_scale`` from calibration,
  ``round(clip(x * (127 / a_scale), -127, 127))`` to int8;
* int32 accumulation, then ``acc * (w_scale * (a_scale / 127)) + bias`` in
  fp32, cast to x's dtype.

Rounding is half to even in both packages (``jnp.round``,
``torch.round``).  The products are exact int32 sums: ``torch._int_mm`` on
the card (zero-padded to its shape limits), a plain int32 matmul on the
CPU; the convolutions gather their 3x3 windows by hand (there is no int8
convolution in PyTorch) and run the same integer product over chunks of
frames.  No fp32 product carries integers here, so TF32 cannot touch
them.

Calibration replaces flax's ``sow(CALIB_COL, ...)``: inside
:func:`recording`, every site passes its input to :func:`record`, which
appends ``calib_stats(x)`` (the |x| quantiles of ``CALIB_QUANTILES``)
under the site's JAX path name.  The backbone's sites are
``blocks_{i}/attn/qkv_in``, ``.../attn/out_in``, ``.../mlp/fc_in`` and
``.../mlp/proj_in``; the VQGAN decoder's are the JAX paths of its convs
(``decoder/up_4_block_0/conv1`` ...), so scales cross over one for one.

Serving-only: rounding has a zero gradient, so the quantized backbone
refuses to run with grad enabled (``models/clip.py``).
"""

from __future__ import annotations

import contextlib
import copy
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# per layer: input scales of (qkv [the shared ln_1 output], out-proj input,
# mlp fc input [ln_2 output], mlp proj input [QuickGELU output])
LayerScales = Tuple[float, float, float, float]
SITES = ('qkv_in', 'out_in', 'fc_in', 'proj_in')

# each calibration site records |x| at these quantiles (1.0 = abs-max), so
# abs-max or percentile clipping is chosen at calibration time
CALIB_QUANTILES = (0.999, 0.9999, 1.0)

# the calibration records of the innermost open recording(), else None
_records: Optional[Dict[str, List[torch.Tensor]]] = None


@contextlib.contextmanager
def recording():
    """Collect every site's ``calib_stats`` while open: yields the dict
    {site path: [records]} that the sites append to."""
    global _records
    prev, _records = _records, {}
    try:
        yield _records
    finally:
        _records = prev


def is_recording() -> bool:
    return _records is not None


def record(path: str, x) -> None:
    """Append ``calib_stats(x)`` under ``path`` when recording."""
    if _records is not None:
        _records.setdefault(path, []).append(calib_stats(x))


def calib_stats(x) -> torch.Tensor:
    """[len(CALIB_QUANTILES)] fp32 quantiles of |x|, on x's device:
    ``jnp.quantile``'s linear interpolation with its fp32 index arithmetic
    (position q * (n - 1), floor and ceil, weights 1 - frac and frac).
    ``torch.quantile`` refuses more than 2^24 elements, which the
    decoder's widest sites reach, so the order statistics come from one
    ``topk`` of the largest values."""
    a = x.detach().float().abs().flatten()
    n = a.numel()
    q = torch.tensor(CALIB_QUANTILES, dtype=torch.float32)
    nf = torch.tensor(float(n), dtype=torch.float32)
    pos = q * (nf - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    low_i = torch.clamp(low, torch.zeros(()), nf - 1).long().clamp(0, n - 1)
    high_i = torch.clamp(high, torch.zeros(()), nf - 1).long().clamp(0, n - 1)
    # ascending order statistic i is top[n - 1 - i]
    top = torch.topk(a, n - int(low_i.min())).values
    dev = a.device
    lo = top[(n - 1 - low_i).to(dev)]
    hi = top[(n - 1 - high_i).to(dev)]
    return lo * low_w.to(dev) + hi * high_w.to(dev)


def _stat_index(percentile) -> int:
    """percentile (None = abs-max, else e.g. 99.9) -> CALIB_QUANTILES
    index."""
    if percentile is None:
        return len(CALIB_QUANTILES) - 1
    q = float(percentile) / 100.0
    for i, cq in enumerate(CALIB_QUANTILES):
        if abs(cq - q) < 1e-9:
            return i
    raise ValueError(
        f'unsupported calibration percentile {percentile}; recorded '
        f'quantiles: {[q * 100 for q in CALIB_QUANTILES[:-1]]} or None '
        f'(abs-max)')


def _safe_scale(v: float) -> float:
    """Positive, rounded activation scale: a near-dead site must not give
    a 0.0 scale (quantizing divides by it)."""
    return max(round(float(v), 4), 1e-4)


def _site_scale(records, percentile, headroom: float = 1.0) -> float:
    """One site's scale: the max over forwards of the chosen quantile
    (abs-max for percentile None), widened by ``headroom``."""
    idx = _stat_index(percentile)
    return _safe_scale(max(float(r[idx]) for r in records) * headroom)


def _as_lists(records: Dict[str, list]) -> Dict[str, list]:
    """Records as host lists of floats (one transfer a record)."""
    return {p: [r.tolist() if torch.is_tensor(r) else list(r) for r in rs]
            for p, rs in records.items()}


def calibrate_int8_scales(record_dicts: Sequence[Dict[str, list]],
                          n_layers: int,
                          percentile=None) -> Tuple[LayerScales, ...]:
    """The backbone's per-layer scales (``ClipStackConfig.int8_scales``)
    from one or more :func:`recording` dicts: per site the max over
    forwards of the chosen |x| quantile."""
    flat: Dict[str, list] = {}
    for recs in record_dicts:
        for p, vals in _as_lists(recs).items():
            flat.setdefault(p, []).extend(vals)
    scales = []
    for i in range(n_layers):
        layer = []
        for site in SITES:
            vals = [v for p, vs in flat.items()
                    if f'blocks_{i}/' in p and p.endswith(site) for v in vs]
            if not vals:
                raise ValueError(f'no calibration record for layer {i} '
                                 f'{site}')
            layer.append(_site_scale(vals, percentile))
        scales.append(tuple(layer))
    return tuple(scales)


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 product a @ w^T of int8 a [M, K] and int8 w [N, K] (a
    weight in torch's Linear layout).  On the card ``torch._int_mm``,
    given w^T as a column-major view (the layout its cuBLAS int8 route
    takes as it is) and zero-padded to that route's limits, M > 16 and K,
    N multiples of 8 (the pad adds nothing).  On the CPU a plain int32
    matmul."""
    if a.device.type != 'cuda':
        return a.to(torch.int32) @ w.to(torch.int32).t()
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def quantize_weight(weight: torch.Tensor) -> tuple:
    """(int8 matrix [O, K], fp32 scales [O]) of a weight whose output
    channels are dim 0, a Linear's [O, K] or a conv's [O, C, kh, kw] (its
    K in (kh, kw, C) order, the order of ``int8_conv``'s windows): per
    output channel ``max(max|W| / 127, 1e-8)``, ``round(W / scale)``."""
    w = weight.detach().float()
    dims = tuple(range(1, w.dim()))
    w_scale = torch.clamp_min(w.abs().amax(dim=dims) / 127.0, 1e-8)
    shape = (-1,) + (1,) * (w.dim() - 1)
    w_q = torch.round(w / w_scale.view(shape)).to(torch.int8)
    if w_q.dim() == 4:
        w_q = w_q.permute(0, 2, 3, 1).reshape(w_q.shape[0], -1)
    return w_q.contiguous(), w_scale


def freeze_weights(module: torch.nn.Module) -> None:
    """Quantize, once, the weights of every int8 site in ``module`` (a
    serving copy): each site module that has a ``freeze_int8`` method
    keeps the :func:`quantize_weight` pairs of its weights and uses them
    instead of quantizing at every call.  A serving copy's weights do not
    change between calls (XLA hoists the same computation out of JAX's
    sampling loop); after the shared weights change, build a new copy."""
    for mod in module.modules():
        if hasattr(mod, 'freeze_int8'):
            mod.freeze_int8()


def quantize_activation(x: torch.Tensor, a_scale: float) -> torch.Tensor:
    return (x.float() * (127.0 / a_scale)).clamp_(-127.0, 127.0).round_(
    ).to(torch.int8)


def _dequantize(acc, w_scale, bias, a_scale, dtype):
    out = acc.float().mul_(w_scale * (a_scale / 127.0))
    if bias is not None:
        out.add_(bias.float())
    return out.to(dtype)


def quantized_dense(x, weight, bias, a_scale: float, w8=None):
    """y = x @ weight^T + bias through an int8 product.  weight [N, K]
    unquantized (torch's Linear layout; JAX's kernel is its transpose), x
    [..., K]; |x| beyond ``a_scale`` saturates (the w8a8 trade).  ``w8``:
    ``quantize_weight(weight)`` computed before, else computed here."""
    w_q, w_scale = w8 if w8 is not None else quantize_weight(weight)
    x_q = quantize_activation(x, a_scale)
    acc = int_mm(x_q.reshape(-1, x.shape[-1]), w_q)
    out = _dequantize(acc, w_scale, bias, a_scale, x.dtype)
    return out.view(*x.shape[:-1], -1)


# bytes of gathered int8 windows per chunk of frames in int8_conv
_CONV_CHUNK_BYTES = 1 << 28


def int8_conv(x_q, w_mat, kh: int, kw: int):
    """Exact int32 stride-1 SAME conv of int8 x_q [B, H, W, C] (channel
    last) and the int8 weight matrix w_mat [O, kh*kw*C] of
    ``quantize_weight`` -> int32 [B, H, W, O].  The kh*kw windows are
    gathered channel-last ([B*H*W, kh*kw*C]) over chunks of frames."""
    b, h, w, c = x_q.shape
    o = w_mat.shape[0]
    ph, pw = kh // 2, kw // 2
    if ph or pw:
        x_q = F.pad(x_q, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    chunk = max(1, _CONV_CHUNK_BYTES // (kh * kw * c * h * w))
    outs = []
    for f0 in range(0, b, chunk):
        xs = x_q[f0:f0 + chunk]
        if kh * kw == 1:
            cols = xs.reshape(-1, c)
        else:
            cols = torch.cat([xs[:, i:i + h, j:j + w] for i in range(kh)
                              for j in range(kw)], dim=-1)
        outs.append(int_mm(cols.view(-1, kh * kw * c), w_mat)
                    .view(xs.shape[0], h, w, o))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def quantized_conv(x, weight, bias, a_scale: float, w8=None):
    """Stride-1 SAME conv (JAX's ``quantized_conv``, NCHW here) through an
    int8 product: x [B, C, H, W], weight [O, C, kh, kw] unquantized ->
    [B, O, H, W] in x's dtype.  ``w8`` as in :func:`quantized_dense`."""
    w_mat, w_scale = w8 if w8 is not None else quantize_weight(weight)
    x_q = quantize_activation(x, a_scale).permute(0, 2, 3, 1)
    acc = int8_conv(x_q, w_mat, weight.shape[2], weight.shape[3])
    return _dequantize(acc, w_scale, bias, a_scale, x.dtype).permute(
        0, 3, 1, 2)


def share_params_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` whose parameters and buffers are the same
    tensors as the original's (the modules and their configs are new)."""
    memo = {id(t): t for t in itertools.chain(module.parameters(),
                                              module.buffers())}
    return copy.deepcopy(module, memo)


def quantized_vae(vae, scales):
    """A VQGanVAE sharing ``vae``'s parameters whose decoder convs run
    int8 with ``scales``, sorted (JAX path, scale) pairs, on weights
    quantized once (:func:`freeze_weights`)."""
    new = share_params_copy(vae)
    new.set_int8_scales(tuple(sorted((str(p), float(s)) for p, s in scales)))
    freeze_weights(new)
    return new


def quantize_vae_decoder(vae, sample_tokens=None, generator=None,
                         headroom: float = 1.25, percentile=None):
    """Calibrate the VQGAN decoder's conv inputs on sample token grids
    [B, n] and return a VQGanVAE whose decode path runs int8 convs
    (parameters shared and unchanged; the encoder stays as it is).
    ``headroom`` widens the scales so near-range inputs do not saturate;
    ``percentile`` as in :func:`calibrate_int8_scales`.  Without
    ``sample_tokens``, 4 random grids from ``generator``."""
    dev = vae.model.quantize.embedding.weight.device
    if sample_tokens is None:
        sample_tokens = torch.randint(0, vae.num_tokens,
                                      (4, vae.image_seq_len),
                                      generator=generator, device=dev)
    b, n = sample_tokens.shape
    f = int(round(n ** 0.5))
    with torch.no_grad(), recording() as recs:
        vae.model.decode_code(sample_tokens.reshape(b, f, f))
    flat = _as_lists(recs)
    if not flat:
        raise ValueError('decoder calibration produced no conv records')
    scales = [(p, _site_scale(v, percentile, headroom))
              for p, v in flat.items()]
    return quantized_vae(vae, scales)


def quantized_model(model, clip_scales, vae=None):
    """A MMVIDBert sharing ``model``'s parameters whose backbone runs w8a8
    with ``clip_scales`` (per layer (qkv_in, out_in, fc_in, proj_in)) on
    weights quantized once (:func:`freeze_weights`), and whose vae is
    ``vae`` (default: the model's own); the cvae is the model's own
    object."""
    new = share_params_copy(model)
    new.set_int8_scales(tuple(tuple(float(v) for v in layer)
                              for layer in clip_scales))
    freeze_weights(new.transformer['transformer'])
    new.vae = vae if vae is not None else model.vae
    new.cvae = model.cvae
    return new


@torch.no_grad()
def quantize_for_serving(model, text=None, generator=None, decoder=True,
                         percentile=None):
    """Calibrate activation scales and return a MMVIDBert whose backbone
    (and, with ``decoder``, the VQGAN decoder's convs) runs w8a8 int8,
    sharing the model's parameters.

    Calibration forwards: the sampler's first state (an all-[MASK]
    target) and a random target, so both ends of mask-predict's
    activation range are seen; ``text`` (default: 4 random rows from
    ``generator``: ids, or normal features for a fixed-LM model) should
    be served text where there is some.  The
    decoder calibrates on the token grids of a 3-round mask-predict
    sample of the unquantized model."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if text is None and cfg.fixed_language_model is not None:
        text = torch.randn((4, cfg.text_feature_dim), generator=generator,
                           device=dev)
    elif text is None:
        text = torch.randint(1, min(1000, cfg.num_text_tokens),
                             (4, cfg.text_seq_len), generator=generator,
                             device=dev)
    n = text.shape[0]
    visual = (torch.full((n, cfg.visual_seq_len), cfg.mask_token,
                         dtype=torch.long, device=dev)
              if cfg.num_visuals > 0 else None)
    masked = torch.full((n, cfg.target_seq_len), cfg.mask_token,
                        dtype=torch.long, device=dev)
    random_t = torch.randint(0, cfg.num_image_tokens, masked.shape,
                             generator=generator, device=dev)
    recs = []
    for target in (masked, random_t):
        with recording() as r:
            model.core(text, visual, target)
        recs.append(r)
    scales = calibrate_int8_scales(recs, cfg.clip.layers, percentile)
    vae = model.vae
    if decoder:
        _, tokens = model.generate_images(generator, text[:2],
                                          mask_predict_steps=3,
                                          dynamic=False, decode=False)
        frames = tokens.reshape(-1, model.vae.image_seq_len)[:8]
        vae = quantize_vae_decoder(model.vae, sample_tokens=frames,
                                   percentile=percentile)
    return quantized_model(model, scales, vae)
