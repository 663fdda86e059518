"""TimeFloats scalar products in PyTorch.

Port of ``repro.core.timefloats``: the block-aligned (separable) int8
quantization, the chunk-ordered int8 MAC that is the forward kernel's
bit-exact spec, the dequantize-and-matmul ``separable`` form, the per-tensor
pow2 prescale, and the training primitive: ``linear`` / ``linear_cached``
as ``torch.autograd.Function``s whose forward quantizes each operand once
and whose backward is a transposed read of the stored planes (DESIGN.md
§3). ``mode="pallas"`` routes the forward MAC through the hand-written CUDA
kernel K1 and dx through K2 (kernels/timefloats_matmul.py); the mode keeps
its reference name so configs map one to one.

The quantizers take leading batch dims: an MoE layer's expert stacks and
its (E, C, D) dispatch buffer are quantized expert by expert in one call,
each expert with its own per-tensor prescale, bitwise what the reference's
``jax.vmap`` over the experts computes (``prepare_input_experts`` /
``prepare_weight_experts``, ``expert_linear``). ``expert_groups`` cuts the
experts into groups, and ``prepare_weight`` a large weight (the head) into
column slabs, so that no quantizer temporary holds a whole stack or head.

A projection's forward runs as dispatcher ops (``repro_torch::tf_project``
and its kin), so that a selective checkpoint policy can keep its output
and quantized planes (``models/model.py``'s ``remat="dots"``).

Not ported yet: ``exact`` mode (the five ``step*`` functions,
``matmul_exact``, ``NoiseParams``) and the op census (``op_census``,
``census_scale``, ``backward_census``), which serves the hw twin.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core import float8
from repro_torch.core.float8 import E4M4, FloatFormat

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TFConfig:
    """TimeFloats arithmetic configuration (same fields as the reference).

    block      — crossbar height / exponent-alignment block (paper: 64).
    adc_bits   — optional per-chunk partial-sum requantization modeling the
                 shared SAR ADC. ``None`` bypasses.
    adc_mode   — "dynamic": idealized auto-ranged full-scale (per call);
                 "fixed": worst-case full-scale block*(2^(m+1)-1)^2.
    mode       — "exact" | "separable" | "pallas".
    cache      — save the quantized operands as the backward's residuals,
                 so the backward is a transposed read of the stored planes
                 (DESIGN.md §3). ``False`` keeps the raw operands and
                 re-quantizes them in the backward: bit-identical results.
    """

    fmt: FloatFormat = E4M4
    block: int = 64
    adc_bits: int | None = None
    adc_mode: str = "dynamic"
    mode: str = "exact"
    cache: bool = True

    @property
    def max_significand(self) -> int:
        return 2 * self.fmt.significand_scale - 1  # e.g. 31 for m=4

    @property
    def out_scale_bias(self) -> int:
        return 2 * self.fmt.bias + 2 * self.fmt.man_bits


DEFAULT = TFConfig()


def adc_constants(cfg: TFConfig, device=None) -> tuple[Tensor, Tensor, Tensor]:
    """(full scale, levels, full scale / levels) of the fixed-mode ADC as
    0-dim f32 tensors; the last one is divided in f32, as the reference
    forms it. Tensors, not Python numbers: CUDA divides by a host scalar
    through its reciprocal, which would round differently."""
    fs = torch.full((), float(cfg.block * cfg.max_significand**2),
                    dtype=torch.float32, device=device)
    levels = torch.full((), float((1 << cfg.adc_bits) - 1),
                        dtype=torch.float32, device=device)
    return fs, levels, fs / levels


def _adc(p: Tensor, cfg: TFConfig) -> Tensor:
    """Model of the shared SAR ADC quantizing a chunk partial sum: identity
    when adc_bits is None, else round(p/fs*L)*(fs/L) (round half to even)
    with a fixed or per-call auto-ranged full scale fs."""
    if cfg.adc_bits is None:
        return p
    pf = p.to(torch.float32)
    fs, levels, _ = adc_constants(cfg, p.device)
    if cfg.adc_mode != "fixed":  # auto-ranged per (M, N) product
        fs = torch.clamp_min(pf.abs().amax(dim=(-2, -1), keepdim=True), 1.0)
    return torch.round(pf / fs * levels) * (fs / levels)


def _pad_k(a: Tensor, block: int, axis: int) -> Tensor:
    pad = (-a.shape[axis]) % block
    if pad == 0:
        return a
    widths = [0, 0] * a.ndim
    widths[2 * (a.ndim - 1 - axis) + 1] = pad  # F.pad lists the last dim first
    return torch.nn.functional.pad(a, widths)


class QuantizedOperand(NamedTuple):
    """Block-aligned integer operand.

    q:     int8, (C, M, B) for inputs / (C, B, N) for weights — signed
           shifted significands in [-(2^(m+1)-1), 2^(m+1)-1].
    scale: f32 per-block scale 2^(a - bias - man_bits), (C, M) / (C, N).
    An expert stack carries a leading (E,) dim on both.
    """

    q: Tensor
    scale: Tensor


def _align(f: float8.F8Fields, blocks: tuple, axis: int, cfg: TFConfig):
    """Shared block alignment: the per-block max exponent ``a`` over
    ``axis`` of the reshaped fields, and the shifted signed significands."""
    exp = f.exp.to(torch.int32).reshape(blocks)
    nz = f.nonzero.reshape(blocks)
    a = torch.where(nz, exp, -(2**30)).amax(dim=axis)
    a = torch.clamp_min(a, 0)
    shift = torch.clamp(a.unsqueeze(axis) - exp, 0, 31)
    q = f.significand(cfg.fmt).reshape(blocks) >> shift
    q = torch.where(shift > cfg.fmt.man_bits, 0, q)
    q = q * f.sign.to(torch.int32).reshape(blocks)
    scale = float8.exp2i(a - cfg.fmt.bias - cfg.fmt.man_bits)
    return q, scale


def quantize_input(x: Tensor, cfg: TFConfig = DEFAULT) -> QuantizedOperand:
    """(..., M, K) -> q:(..., C, M, B) int8, scale:(..., C, M) f32."""
    *lead, m_dim, _ = x.shape
    xp = _pad_k(x, cfg.block, x.ndim - 1)
    n_chunks = xp.shape[-1] // cfg.block
    f = float8.decompose(xp, cfg.fmt)
    q, scale = _align(f, (*lead, m_dim, n_chunks, cfg.block), -1, cfg)
    return QuantizedOperand(
        q=q.transpose(-3, -2).to(torch.int8).contiguous(),
        scale=scale.transpose(-2, -1).contiguous())


def quantize_weight(w: Tensor, cfg: TFConfig = DEFAULT) -> QuantizedOperand:
    """(..., K, N) -> q:(..., C, B, N) int8, scale:(..., C, N) f32."""
    *lead, _, n_dim = w.shape
    wp = _pad_k(w, cfg.block, w.ndim - 2)
    n_chunks = wp.shape[-2] // cfg.block
    f = float8.decompose(wp, cfg.fmt)
    q, scale = _align(f, (*lead, n_chunks, cfg.block, n_dim), -2, cfg)
    return QuantizedOperand(q=q.to(torch.int8), scale=scale)


def dequantize_input(qx: QuantizedOperand, k_dim: int,
                     dtype=torch.float32) -> Tensor:
    """(...,C,M,B) int8 + (...,C,M) scale -> (...,M,K) block-aligned values
    (exact: 5-bit significands times power-of-two scales)."""
    *lead, c, m, b = qx.q.shape
    v = qx.q.to(torch.float32) * qx.scale[..., None]
    return v.transpose(-3, -2).reshape(*lead, m, c * b)[..., :k_dim].to(dtype)


def dequantize_weight(qw: QuantizedOperand, k_dim: int,
                      dtype=torch.float32) -> Tensor:
    *lead, c, b, n = qw.q.shape
    v = qw.q.to(torch.float32) * qw.scale[..., None, :]
    return v.reshape(*lead, c * b, n)[..., :k_dim, :].to(dtype)


def matmul_from_quantized(qx: QuantizedOperand, qw: QuantizedOperand,
                          cfg: TFConfig = DEFAULT) -> Tensor:
    """Chunk-ordered int8 MAC with rank-1 scales: the forward kernel's
    bit-exact spec. Each chunk's integer dot is taken in f32, which is
    exact (|p| <= 64*31^2 < 2^24) in any summation order; chunks then
    accumulate in order, ``acc + p*sx*sw``. 2-D operands only; an expert
    stack goes through K1's plain expert loop."""
    m_dim, n_dim = qx.q.shape[1], qw.q.shape[2]
    acc = torch.zeros((m_dim, n_dim), dtype=torch.float32, device=qx.q.device)
    for c in range(qx.q.shape[0]):
        p = qx.q[c].to(torch.float32) @ qw.q[c].to(torch.float32)
        p = _adc(p, cfg)
        acc = acc + p * qx.scale[c][:, None] * qw.scale[c][None, :]
    return acc


def matmul_separable_scan(x: Tensor, w: Tensor,
                          cfg: TFConfig = DEFAULT) -> Tensor:
    """(M,K) @ (K,N) via per-chunk int8 MACs (the K1 spec, end to end)."""
    return matmul_from_quantized(quantize_input(x, cfg),
                                 quantize_weight(w, cfg), cfg)


def matmul_separable(x: Tensor, w: Tensor, cfg: TFConfig = DEFAULT) -> Tensor:
    """Block-align-quantize, dequantize (exact), then ONE f32 matmul. Equal
    to the scan form up to f32 summation order. The per-chunk ADC needs the
    scan form, which it dispatches to when adc_bits is set."""
    if cfg.adc_bits is not None:
        return matmul_separable_scan(x, w, cfg)
    k_dim = x.shape[1]
    xd = dequantize_input(quantize_input(x, cfg), k_dim)
    wd = dequantize_weight(quantize_weight(w, cfg), k_dim)
    return xd @ wd


def matmul(x: Tensor, w: Tensor, cfg: TFConfig = DEFAULT) -> Tensor:
    """2-D TimeFloats matmul in the configured mode."""
    if cfg.mode == "separable":
        return matmul_separable(x, w, cfg)
    if cfg.mode == "pallas":
        from repro_torch.kernels import ops

        return ops.timefloats_matmul(x, w, cfg)
    if cfg.mode == "exact":
        raise NotImplementedError(
            "TimeFloats exact mode is not ported yet (training slice)")
    raise ValueError(f"unknown TimeFloats mode: {cfg.mode!r}")


def _prescale_of(a: Tensor, cfg: TFConfig, batch: int = 0) -> Tensor:
    """The per-tensor power-of-two amax scale of :func:`_pow2_prescale`,
    one per tensor of the ``batch`` leading dims."""
    amax = (a.abs().max() if not batch
            else a.abs().amax(dim=tuple(range(batch, a.ndim))))
    target = cfg.fmt.max_exp_code - 1 - cfg.fmt.bias
    log2a = float8.log2_floor(amax)
    e = torch.where(amax > 0, target - log2a, 0.0).to(torch.int32)
    return float8.exp2i(e)


def _pow2_prescale(a: Tensor, cfg: TFConfig, batch: int = 0
                   ) -> tuple[Tensor, Tensor]:
    """Per-tensor power-of-two amax scale, exact in FP8. The amax and its
    log2 are taken in ``a``'s own dtype, as in the reference; the product
    ``a * scale`` promotes to f32. Returns (scaled array, scale). With
    ``batch`` leading dims each of their tensors takes its own scale (the
    reference's vmap over experts); ``scale`` then has those dims."""
    scale = _prescale_of(a, cfg, batch)
    return a.to(torch.float32) * _lift(scale, a.ndim), scale


def _lift(scale: Tensor, ndim: int) -> Tensor:
    """A per-tensor scale of shape (E,) broadcast over (E, ...) of ``ndim``
    dims (a 0-dim scale stays as it is)."""
    return scale.reshape(scale.shape + (1,) * (ndim - scale.ndim)) \
        if scale.ndim else scale


def _scaled_matmul(x: Tensor, w: Tensor, cfg: TFConfig) -> Tensor:
    xs, sx = _pow2_prescale(x, cfg)
    ws, sw = _pow2_prescale(w, cfg)
    return matmul(xs, ws, cfg) / (sx * sw)


def matmul_separable_transposed(g: Tensor, qw: QuantizedOperand, k_dim: int,
                                cfg: TFConfig = DEFAULT) -> Tensor:
    """dx = g @ W^T as a transposed read of the stored weight planes: the
    planes are dequantized (exact) in W's own (K, N) layout and contracted
    over N; only the streamed ``g`` is quantized, along its contraction dim
    N. Transposed reads are modeled ADC-free (DESIGN.md §3)."""
    n_dim = g.shape[1]
    gd = dequantize_input(quantize_input(g, cfg), n_dim)   # (M2, N)
    c, b, _ = qw.q.shape
    wv = dequantize_weight(qw, c * b)                      # (Kpad, N)
    return (gd @ wv.T)[:, :k_dim]


def matmul_separable_outer(qx: QuantizedOperand, g: Tensor, k_dim: int,
                           cfg: TFConfig = DEFAULT) -> Tensor:
    """dW = x^T @ g as a transposed read of the stored activation planes;
    ``g`` is quantized once, chunked along M (its contraction dim here)."""
    m2 = g.shape[0]
    gd = dequantize_weight(quantize_weight(g, cfg), m2)    # (M2, N)
    c, _, b = qx.q.shape
    xd = dequantize_input(qx, c * b)                       # (M2, Kpad)
    return (xd.T @ gd)[:k_dim]


# ---------------------------------------------------------------------------
# Quantized-operand cache (DESIGN.md §3): operands are prescaled and
# quantized once; the backward pass reads the stored planes transposed.
# ---------------------------------------------------------------------------


class PreparedOperand(NamedTuple):
    """One prescaled, quantized operand: the unit of the cache.

    scale — () f32 per-tensor pow2 amax prescale; the planes encode
            ``operand * scale``.
    q     — block-aligned int8 planes and per-chunk scales.
    """

    scale: Tensor
    q: QuantizedOperand


# Calls of prepare_input / prepare_weight. The reference counts once per
# trace; the port runs eagerly and counts once per call, so a training step
# whose weights come from the per-step cache shows exactly one
# prepare_weight per eligible leaf, all made before the loss runs.
_QUANT_COUNTS = {"prepare_input": 0, "prepare_weight": 0}


def quant_trace_counts() -> dict:
    return dict(_QUANT_COUNTS)


def reset_quant_trace_counts() -> None:
    for k in _QUANT_COUNTS:
        _QUANT_COUNTS[k] = 0


def _check_mode(cfg: TFConfig) -> None:
    if cfg.mode == "exact":
        raise NotImplementedError("TimeFloats exact mode is not ported yet")
    if cfg.mode not in ("separable", "pallas"):
        raise ValueError(f"unknown TimeFloats mode: {cfg.mode!r}")


def prepare_input(x2: Tensor, cfg: TFConfig = DEFAULT) -> PreparedOperand:
    """(M, K) activation -> cache entry (quantized once; read by fwd + dW)."""
    _check_mode(cfg)
    _QUANT_COUNTS["prepare_input"] += 1
    xs, s = _pow2_prescale(x2, cfg)
    return PreparedOperand(scale=s, q=quantize_input(xs, cfg))


# Elements of weight quantized at once: the quantizer's temporaries take
# ~40 bytes an element, so a slab of 2^26 (a 7168 x 9362 column slab of
# deepseek-v3's head, 4 of its 7168 x 2048 experts) stays near 2.7 GB where
# the whole head would take ~40 GB.
QUANT_SLAB_ELEMS = 1 << 26


def _prepare_weight_slabs(w: Tensor, cfg: TFConfig, batch: int
                          ) -> PreparedOperand:
    """Prescale ``w`` (..., K, N) per tensor of its ``batch`` leading dims
    and quantize it in column slabs of at most ``QUANT_SLAB_ELEMS``
    elements, written into the whole planes: each column's blocks are its
    own, so the planes are bitwise those of one call on the whole."""
    s = _prescale_of(w, cfg, batch)
    n_dim = w.shape[-1]
    per = max(1, QUANT_SLAB_ELEMS // max(w.numel() // max(n_dim, 1), 1))
    if per >= n_dim:
        return PreparedOperand(scale=s, q=quantize_weight(
            w.to(torch.float32) * _lift(s, w.ndim), cfg))
    q = qs = None
    for n0 in range(0, n_dim, per):
        part = quantize_weight(w[..., n0:n0 + per].to(torch.float32)
                               * _lift(s, w.ndim), cfg)
        if q is None:
            q = part.q.new_empty(part.q.shape[:-1] + (n_dim,))
            qs = part.scale.new_empty(part.scale.shape[:-1] + (n_dim,))
        q[..., n0:n0 + per] = part.q
        qs[..., n0:n0 + per] = part.scale
    return PreparedOperand(scale=s, q=QuantizedOperand(q, qs))


def prepare_weight(w: Tensor, cfg: TFConfig = DEFAULT) -> PreparedOperand:
    """(K, N) weight -> cache entry (quantized once; read by fwd + dx)."""
    _check_mode(cfg)
    _QUANT_COUNTS["prepare_weight"] += 1
    return _prepare_weight_slabs(w, cfg, batch=0)


# ---------------------------------------------------------------------------
# Expert stacks (models/moe.py): the reference vmaps the dense layer over
# the experts, so every expert's operands take their own prescale.
# ---------------------------------------------------------------------------


def expert_groups(n_experts: int, k_dim: int, n_dim: int) -> list[slice]:
    """The expert ranges quantized and multiplied together: as many (K, N)
    experts as ``QUANT_SLAB_ELEMS`` holds, at least one."""
    per = max(1, QUANT_SLAB_ELEMS // max(k_dim * n_dim, 1))
    return [slice(i, min(i + per, n_experts))
            for i in range(0, n_experts, per)]


def prepare_input_experts(x: Tensor, cfg: TFConfig = DEFAULT
                          ) -> PreparedOperand:
    """(E, M, K) expert inputs -> one cache entry per expert, stacked:
    scale (E,), planes (E, C, M, B); bitwise ``prepare_input(x[e])``."""
    _check_mode(cfg)
    _QUANT_COUNTS["prepare_input"] += 1
    xs, s = _pow2_prescale(x, cfg, batch=1)
    return PreparedOperand(scale=s, q=quantize_input(xs, cfg))


def prepare_weight_experts(w: Tensor, cfg: TFConfig = DEFAULT
                           ) -> PreparedOperand:
    """(E, K, N) expert stack -> stacked cache entries: scale (E,), planes
    (E, C, B, N); bitwise ``prepare_weight(w[e])``. Callers bound E with
    :func:`expert_groups`."""
    _check_mode(cfg)
    _QUANT_COUNTS["prepare_weight"] += 1
    return _prepare_weight_slabs(w, cfg, batch=1)


def prepare_weight_stack(w: Tensor, cfg: TFConfig = DEFAULT
                         ) -> PreparedOperand:
    """:func:`prepare_weight_experts` over a whole (E, K, N) stack, group
    by group (the weight cache's ``expert`` rule)."""
    parts = [prepare_weight_experts(w[g], cfg)
             for g in expert_groups(*w.shape)]
    return _cat_prepared(parts)


def _cat_prepared(parts: list) -> PreparedOperand:
    if len(parts) == 1:
        return parts[0]
    return PreparedOperand(
        scale=torch.cat([p.scale for p in parts]),
        q=QuantizedOperand(torch.cat([p.q.q for p in parts]),
                           torch.cat([p.q.scale for p in parts])))


def _slice_prepared(p: PreparedOperand, g: slice) -> PreparedOperand:
    return PreparedOperand(p.scale[g], QuantizedOperand(p.q.q[g],
                                                        p.q.scale[g]))


def _matmul_prepared_experts(px: PreparedOperand, pw: PreparedOperand,
                             m_dim: int, k_dim: int, n_dim: int,
                             cfg: TFConfig) -> Tensor:
    """(E, M, N) products of stacked cache entries; expert e's is
    bit-identical to ``_matmul_prepared`` on its slices."""
    if cfg.mode == "pallas":
        from repro_torch.kernels import ops

        return ops.quantized_matmul_experts(px.q, pw.q, cfg)[
            :, :m_dim, :n_dim]
    if cfg.adc_bits is not None:
        return torch.stack([matmul_from_quantized(
            QuantizedOperand(px.q.q[e], px.q.scale[e]),
            QuantizedOperand(pw.q.q[e], pw.q.scale[e]), cfg)
            for e in range(px.q.q.shape[0])])
    return dequantize_input(px.q, k_dim) @ dequantize_weight(pw.q, k_dim)


def _expert_forward(x: Tensor, w: Tensor, pw, cfg: TFConfig, keep: bool):
    """Group by group: quantize the group's weights (unless cached) and
    inputs, multiply, unscale. Returns (y (E, M, N) f32, px, pw), the
    entries only when ``keep`` (the backward's residuals)."""
    e_dim, k_dim, n_dim = w.shape
    ys, pxs, pws = [], [], []
    for g in expert_groups(e_dim, k_dim, n_dim):
        pwg = (_slice_prepared(pw, g) if pw is not None
               else prepare_weight_experts(w[g], cfg))
        pxg = prepare_input_experts(x[g], cfg)
        y = _matmul_prepared_experts(pxg, pwg, x.shape[1], k_dim, n_dim, cfg)
        ys.append(y / _lift(pxg.scale * pwg.scale, 3))
        if keep:
            pxs.append(pxg)
            pws.append(pwg)
    y = torch.cat(ys) if len(ys) > 1 else ys[0]
    if not keep:
        return y, None, None
    return y, _cat_prepared(pxs), _cat_prepared(pws)


class _ExpertLinear(torch.autograd.Function):
    """:func:`expert_linear`: forward quantizes each expert's operands
    once (groups of experts at a time); backward runs each expert's
    transposed reads, as the reference's vmapped ``linear`` does."""

    @staticmethod
    def forward(ctx, x, w, pw_scale, pw_q, pw_s, cfg):
        ctx.cfg, ctx.k_dim, ctx.dtypes = cfg, x.shape[-1], (x.dtype, w.dtype)
        pw = (None if pw_q is None
              else PreparedOperand(pw_scale, QuantizedOperand(pw_q, pw_s)))
        keep = any(ctx.needs_input_grad[:2])
        y, px, pw = _expert_forward(x, w, pw, cfg, keep)
        if keep:
            _save(ctx, px, pw)
        return y

    @staticmethod
    def backward(ctx, g):
        px, pw = _load(ctx)
        x_dt, w_dt = ctx.dtypes
        dx, dw = [], []
        for e in range(g.shape[0]):
            a, b = _bwd_prepared(ctx.cfg, _slice_prepared(px, e),
                                 _slice_prepared(pw, e), g[e], ctx.k_dim)
            dx.append(a.to(x_dt))
            dw.append(b.to(w_dt))
        return (torch.stack(dx), torch.stack(dw)) + (None,) * 4


def expert_linear(x: Tensor, w: Tensor, pw: PreparedOperand | None = None,
                  cfg: TFConfig = DEFAULT) -> Tensor:
    """:func:`linear` over experts: x (E, M, K) @ w (E, K, N) -> (E, M, N)
    f32, expert e bitwise ``linear(x[e], w[e])`` (its own prescales, the
    reference's vmap). ``pw`` is the stack's cache entry
    (:func:`prepare_weight_stack`), if one was built."""
    if w.ndim != 3 or x.ndim != 3 or x.shape[0] != w.shape[0]:
        raise ValueError(f"expert_linear: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}: need (E, M, K) and (E, K, N)")
    parts = (None, None, None) if pw is None else (pw.scale, pw.q.q,
                                                   pw.q.scale)
    return _ExpertLinear.apply(x, w, *parts, cfg)


def _matmul_prepared(px: PreparedOperand, pw: PreparedOperand, m_dim: int,
                     k_dim: int, n_dim: int, cfg: TFConfig) -> Tensor:
    """Forward product from cache entries; bit-identical to
    ``matmul(xs, ws, cfg)`` on the prescaled operands."""
    if cfg.mode == "pallas":
        from repro_torch.kernels import ops

        return ops.quantized_matmul(px.q, pw.q, cfg)[:m_dim, :n_dim]
    if cfg.adc_bits is not None:
        return matmul_from_quantized(px.q, pw.q, cfg)
    return dequantize_input(px.q, k_dim) @ dequantize_weight(pw.q, k_dim)


def _bwd_prepared(cfg: TFConfig, px: PreparedOperand, pw: PreparedOperand,
                  g2: Tensor, k_dim: int) -> tuple[Tensor, Tensor]:
    """dx = g @ W^T and dW = x^T @ g from the stored operands. dx reads the
    stored weight planes transposed (K2 in pallas mode); dW, the in-situ
    update's outer product, stays a dequantize + matmul in every mode, as
    in the reference."""
    gs, sg = _pow2_prescale(g2, cfg)
    if cfg.mode == "pallas" and cfg.adc_bits is None:
        from repro_torch.kernels import ops

        dx = ops.timefloats_matmul_transposed(gs, pw.q, k_dim, cfg)
    else:
        dx = matmul_separable_transposed(gs, pw.q, k_dim, cfg)
    dw = matmul_separable_outer(px.q, gs, k_dim, cfg)
    return dx / (sg * pw.scale), dw / (px.scale * sg)


# ---------------------------------------------------------------------------
# A projection's forward with ``cfg.cache`` runs as two dispatcher ops, the
# weight's quantizer and the input's quantizer with the product, so that a
# selective checkpoint policy can keep its planes and output whole
# (models/model.py, remat="dots"). TFConfig crosses the op boundary as its
# fields.
# ---------------------------------------------------------------------------


def _cfg_args(cfg: TFConfig) -> tuple:
    return (cfg.fmt.exp_bits, cfg.fmt.man_bits, cfg.block, cfg.adc_bits,
            cfg.adc_mode, cfg.mode)


@functools.lru_cache(maxsize=None)
def _cfg_of(exp_bits: int, man_bits: int, block: int,
            adc_bits: Optional[int], adc_mode: str, mode: str) -> TFConfig:
    return TFConfig(FloatFormat(exp_bits, man_bits), block, adc_bits,
                    adc_mode, mode)


@torch.library.custom_op("repro_torch::tf_prepare_weight", mutates_args=())
def _prepare_weight_op(w: Tensor, exp_bits: int, man_bits: int, block: int,
                       adc_bits: Optional[int], adc_mode: str, mode: str
                       ) -> tuple[Tensor, Tensor, Tensor]:
    """:func:`prepare_weight` -> (scale, planes, chunk scales)."""
    pw = prepare_weight(w, _cfg_of(exp_bits, man_bits, block, adc_bits,
                                   adc_mode, mode))
    return pw.scale, pw.q.q, pw.q.scale


@torch.library.custom_op("repro_torch::tf_project", mutates_args=())
def _project_op(x2: Tensor, pw_scale: Tensor, pw_q: Tensor, pw_s: Tensor,
                n_dim: int, exp_bits: int, man_bits: int, block: int,
                adc_bits: Optional[int], adc_mode: str, mode: str
                ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """y = x2 @ w from w's cache entry -> (y, and x2's scale, planes and
    chunk scales)."""
    cfg = _cfg_of(exp_bits, man_bits, block, adc_bits, adc_mode, mode)
    px = prepare_input(x2, cfg)
    pw = PreparedOperand(pw_scale, QuantizedOperand(pw_q, pw_s))
    y = _matmul_prepared(px, pw, x2.shape[0], x2.shape[1], n_dim, cfg)
    return y / (px.scale * pw.scale), px.scale, px.q.q, px.q.scale


# The ops that make a projection's forward (overloads, as dispatch sees them).
PROJECTION_OPS = (torch.ops.repro_torch.tf_prepare_weight.default,
                  torch.ops.repro_torch.tf_project.default)


def _prepared(t) -> PreparedOperand:
    return PreparedOperand(t[0], QuantizedOperand(t[1], t[2]))


def _forward_prepared(x2: Tensor, pw: PreparedOperand, n_dim: int,
                      cfg: TFConfig) -> tuple[Tensor, PreparedOperand]:
    y, *px = _project_op(x2, pw.scale, pw.q.q, pw.q.scale, n_dim,
                         *_cfg_args(cfg))
    return y, _prepared(px)


# The residuals go through ctx.save_for_backward, so activation
# checkpointing (models/model.py, remat="full") can drop and recompute them.
def _save(ctx, *ops: PreparedOperand) -> None:
    ctx.save_for_backward(*(t for op in ops for t in (op.scale, op.q.q,
                                                      op.q.scale)))


def _load(ctx) -> list:
    t = ctx.saved_tensors
    return [_prepared(t[i:i + 3]) for i in range(0, len(t), 3)]


class _Linear(torch.autograd.Function):
    """``linear``: forward quantizes each operand once; backward reads the
    residuals (quantized planes with ``cfg.cache``, else the raw operands,
    re-quantized there: bit-identical)."""

    @staticmethod
    def forward(ctx, x2, w, cfg):
        ctx.cfg, ctx.k_dim, ctx.dtypes = cfg, x2.shape[1], (x2.dtype, w.dtype)
        if cfg.cache:
            pw = _prepared(_prepare_weight_op(w, *_cfg_args(cfg)))
            y, px = _forward_prepared(x2, pw, w.shape[1], cfg)
            _save(ctx, px, pw)
        else:
            y = _scaled_matmul(x2, w, cfg)
            ctx.save_for_backward(x2, w)
        return y

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        if cfg.cache:
            px, pw = _load(ctx)
        else:
            x2, w = ctx.saved_tensors
            px, pw = prepare_input(x2, cfg), prepare_weight(w, cfg)
        return _grads(ctx, px, pw, g) + (None,)


class _LinearCached(torch.autograd.Function):
    """``linear_cached``: the weight's cache entry ``pw`` is an input; it
    takes no gradient, and ``w`` is only the gradient's attachment point."""

    @staticmethod
    def forward(ctx, x2, w, pw_scale, pw_q, pw_s, cfg):
        ctx.cfg, ctx.k_dim, ctx.dtypes = cfg, x2.shape[1], (x2.dtype, w.dtype)
        pw = PreparedOperand(pw_scale, QuantizedOperand(pw_q, pw_s))
        y, px = _forward_prepared(x2, pw, w.shape[1], cfg)
        _save(ctx, px, pw)
        return y

    @staticmethod
    def backward(ctx, g):
        px, pw = _load(ctx)
        return _grads(ctx, px, pw, g) + (None,) * 4


def _grads(ctx, px: PreparedOperand, pw: PreparedOperand, g: Tensor
           ) -> tuple:
    """(dx in x's dtype, dW in w's dtype)."""
    x_dt, w_dt = ctx.dtypes
    dx, dw = _bwd_prepared(ctx.cfg, px, pw, g, ctx.k_dim)
    return dx.to(x_dt), dw.to(w_dt)


def linear(x: Tensor, w: Tensor, cfg: TFConfig = DEFAULT) -> Tensor:
    """Training linear layer y = x @ w in TimeFloats arithmetic, f32 out.

    Forward and backward both run "in the crossbar": y is the block-MAC of
    the prescaled, quantized operands; dx = g @ W^T is a transposed read of
    the same stored weight planes, and dW = x^T @ g an outer-product read of
    the stored activation planes. Only the streamed gradient is quantized
    in the backward. The quantizer passes gradients straight through. x may
    carry leading batch dims."""
    lead = x.shape[:-1]
    y = _Linear.apply(x.reshape(-1, x.shape[-1]), w, cfg)
    return y.reshape(*lead, w.shape[-1])


def linear_cached(x: Tensor, w: Tensor, pw: PreparedOperand,
                  cfg: TFConfig = DEFAULT) -> Tensor:
    """:func:`linear` with the weight's cache entry ``pw =
    prepare_weight(w, cfg)`` built beforehand (once per optimizer step,
    models/common.build_weight_cache). Gradients flow to ``w``; ``pw``
    gets none."""
    if w.ndim != 2:
        raise ValueError(f"w must be 2-D, got {tuple(w.shape)}")
    lead = x.shape[:-1]
    y = _LinearCached.apply(x.reshape(-1, x.shape[-1]), w, pw.scale, pw.q.q,
                            pw.q.scale, cfg)
    return y.reshape(*lead, w.shape[-1])
