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

Not ported yet: ``exact`` mode (the five ``step*`` functions,
``matmul_exact``, ``NoiseParams``) and the op census (``op_census``,
``census_scale``, ``backward_census``), which serves the hw twin.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

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
    if cfg.adc_mode != "fixed":
        fs = torch.clamp_min(pf.abs().max(), 1.0)
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
    """(M, K) -> q:(C, M, B) int8, scale:(C, M) f32."""
    m_dim = x.shape[0]
    xp = _pad_k(x, cfg.block, 1)
    n_chunks = xp.shape[1] // cfg.block
    f = float8.decompose(xp, cfg.fmt)
    q, scale = _align(f, (m_dim, n_chunks, cfg.block), 2, cfg)
    return QuantizedOperand(q=q.transpose(0, 1).to(torch.int8).contiguous(),
                            scale=scale.transpose(0, 1).contiguous())


def quantize_weight(w: Tensor, cfg: TFConfig = DEFAULT) -> QuantizedOperand:
    """(K, N) -> q:(C, B, N) int8, scale:(C, N) f32."""
    n_dim = w.shape[1]
    wp = _pad_k(w, cfg.block, 0)
    n_chunks = wp.shape[0] // cfg.block
    f = float8.decompose(wp, cfg.fmt)
    q, scale = _align(f, (n_chunks, cfg.block, n_dim), 1, cfg)
    return QuantizedOperand(q=q.to(torch.int8), scale=scale)


def dequantize_input(qx: QuantizedOperand, k_dim: int,
                     dtype=torch.float32) -> Tensor:
    """(C,M,B) int8 + (C,M) scale -> (M,K) block-aligned values (exact:
    5-bit significands times power-of-two scales)."""
    c, m, b = qx.q.shape
    v = qx.q.to(torch.float32) * qx.scale[:, :, None]
    return v.transpose(0, 1).reshape(m, c * b)[:, :k_dim].to(dtype)


def dequantize_weight(qw: QuantizedOperand, k_dim: int,
                      dtype=torch.float32) -> Tensor:
    c, b, n = qw.q.shape
    v = qw.q.to(torch.float32) * qw.scale[:, None, :]
    return v.reshape(c * b, n)[:k_dim].to(dtype)


def matmul_from_quantized(qx: QuantizedOperand, qw: QuantizedOperand,
                          cfg: TFConfig = DEFAULT) -> Tensor:
    """Chunk-ordered int8 MAC with rank-1 scales: the forward kernel's
    bit-exact spec. Each chunk's integer dot is taken in f32, which is
    exact (|p| <= 64*31^2 < 2^24) in any summation order; chunks then
    accumulate in order, ``acc + p*sx*sw``."""
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


def _pow2_prescale(a: Tensor, cfg: TFConfig) -> tuple[Tensor, Tensor]:
    """Per-tensor power-of-two amax scale, exact in FP8. The amax and its
    log2 are taken in ``a``'s own dtype, as in the reference; the product
    ``a * scale`` promotes to f32. Returns (scaled array, scale)."""
    amax = a.abs().max()
    target = cfg.fmt.max_exp_code - 1 - cfg.fmt.bias
    log2a = float8.log2_floor(amax)
    e = torch.where(amax > 0, target - log2a, 0.0).to(torch.int32)
    scale = float8.exp2i(e)
    return a.to(torch.float32) * scale, scale


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


def prepare_weight(w: Tensor, cfg: TFConfig = DEFAULT) -> PreparedOperand:
    """(K, N) weight -> cache entry (quantized once; read by fwd + dx)."""
    _check_mode(cfg)
    _QUANT_COUNTS["prepare_weight"] += 1
    ws, s = _pow2_prescale(w, cfg)
    return PreparedOperand(scale=s, q=quantize_weight(ws, cfg))


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


def _forward_prepared(x2: Tensor, pw: PreparedOperand, n_dim: int,
                      cfg: TFConfig) -> tuple[Tensor, PreparedOperand]:
    px = prepare_input(x2, cfg)
    y = _matmul_prepared(px, pw, x2.shape[0], x2.shape[1], n_dim, cfg)
    return y / (px.scale * pw.scale), px


# The residuals go through ctx.save_for_backward, so activation
# checkpointing (models/model.py, remat="full") can drop and recompute them.
def _save(ctx, *ops: PreparedOperand) -> None:
    ctx.save_for_backward(*(t for op in ops for t in (op.scale, op.q.q,
                                                      op.q.scale)))


def _load(ctx) -> list:
    t = ctx.saved_tensors
    return [PreparedOperand(t[i], QuantizedOperand(t[i + 1], t[i + 2]))
            for i in range(0, len(t), 3)]


class _Linear(torch.autograd.Function):
    """``linear``: forward quantizes each operand once; backward reads the
    residuals (quantized planes with ``cfg.cache``, else the raw operands,
    re-quantized there: bit-identical)."""

    @staticmethod
    def forward(ctx, x2, w, cfg):
        ctx.cfg, ctx.k_dim, ctx.dtypes = cfg, x2.shape[1], (x2.dtype, w.dtype)
        if cfg.cache:
            pw = prepare_weight(w, cfg)
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
