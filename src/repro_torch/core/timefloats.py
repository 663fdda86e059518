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

``mode="exact"`` is the paper's pipeline: the five steps literally
(:func:`scalar_product_steps`) and :func:`matmul_exact`, each 64-chunk of
each (row, column) pair aligned to its own joint max exponent, in plain
PyTorch as the reference computes it outside any kernel. Every step is an
integer or power-of-two operation and the f32 chunk sum keeps its order,
so it is bitwise the reference's on any device. Its noise branch (process
variability) waits for the variability slice.

The op census (:func:`op_census`, DESIGN.md §6) records every forward
crossbar read a program makes; ``hw/schedule.py`` prices it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core import float8
from repro_torch.core.float8 import E4M4, FloatFormat

Tensor = torch.Tensor


class NoiseParams(NamedTuple):
    """Process-variability model of Sec. III-D: C -> C * (1 + N(0, sigma)),
    applied separately to the exponent path (time-pulse representation of
    e_x + e_w) and to the mantissa path (crossbar product-sum)."""

    sigma_exp: float = 0.0
    sigma_mant: float = 0.0


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
    fs, levels, step = adc_constants(cfg, p.device)
    if cfg.adc_mode != "fixed":  # auto-ranged per (M, N) product
        dims = (-2, -1) if pf.ndim >= 2 else tuple(range(pf.ndim))
        fs = torch.clamp_min(pf.abs().amax(dim=dims, keepdim=True), 1.0)
        # XLA divides the run-time full scale by the constant level count
        # through the constant's f32 reciprocal.
        step = fs * torch.reciprocal(levels)
    return torch.round(pf / fs * levels) * step


def _pad_k(a: Tensor, block: int, axis: int) -> Tensor:
    pad = (-a.shape[axis]) % block
    if pad == 0:
        return a
    widths = [0, 0] * a.ndim
    widths[2 * (a.ndim - 1 - axis) + 1] = pad  # F.pad lists the last dim first
    return torch.nn.functional.pad(a, widths)


# ---------------------------------------------------------------------------
# The five steps, literally, for a single (x, w) pair (Fig. 2 of the paper).
# ---------------------------------------------------------------------------

_NO_EXP = -(2**30)   # the summed exponent of an invalid (zero) term


def step1_exponent_add(fx: float8.F8Fields, fw: float8.F8Fields) -> Tensor:
    """Element-wise e_x + e_w on stored codes (the RC-discharge adder)."""
    return fx.exp.to(torch.int32) + fw.exp.to(torch.int32)


def step2_max_detect(s: Tensor, valid: Tensor) -> Tensor:
    """Largest summed exponent (the D-FF/MUX tournament tree)."""
    return torch.where(valid, s, _NO_EXP).amax()


def step3_mantissa_scale(fx: float8.F8Fields, s: Tensor, e_max: Tensor,
                         fmt: FloatFormat) -> Tensor:
    """Right-shift input significands by (E_max - s_i); shifts past the
    significand width zero the term (the sparsity the paper notes)."""
    shift = torch.clamp(e_max - s, 0, 31)
    mhat = fx.significand(fmt) * fx.sign.to(torch.int32)
    mag = torch.abs(mhat) >> shift
    mag = torch.where(shift > fmt.man_bits, 0, mag)
    return torch.sign(mhat) * mag


def step4_mac(mx_scaled: Tensor, fw: float8.F8Fields,
              fmt: FloatFormat) -> Tensor:
    """Fixed-point scalar product against weight significands (crossbar),
    an int32 sum."""
    mw = fw.significand(fmt) * fw.sign.to(torch.int32)
    return torch.sum(mx_scaled * mw, dtype=torch.int32)


def step5_renormalize(p: Tensor, e_max: Tensor, cfg: TFConfig) -> Tensor:
    """Digitize and rescale the product-sum back to floating point."""
    return p.to(torch.float32) * float8.exp2i(e_max - cfg.out_scale_bias)


def _chunk_fields(f: float8.F8Fields, sl) -> float8.F8Fields:
    return float8.F8Fields(*(a[sl] for a in f))


def scalar_product_steps(x: Tensor, w: Tensor,
                         cfg: TFConfig = DEFAULT) -> Tensor:
    """Full 5-step scalar product of two 1-D vectors (any length; chunked):
    the chunks' f32 values summed in chunk order from zero."""
    (k,) = x.shape
    if w.shape != (k,):
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}")
    x = _pad_k(x, cfg.block, 0)
    w = _pad_k(w, cfg.block, 0)
    fx = float8.decompose(x, cfg.fmt)
    fw = float8.decompose(w, cfg.fmt)
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(x.shape[0] // cfg.block):
        sl = slice(c * cfg.block, (c + 1) * cfg.block)
        cx, cw = _chunk_fields(fx, sl), _chunk_fields(fw, sl)
        valid = cx.nonzero & cw.nonzero
        s = step1_exponent_add(cx, cw)
        e_max = step2_max_detect(s, valid)
        mx = step3_mantissa_scale(cx, s, e_max, cfg.fmt)
        mx = torch.where(valid, mx, 0)
        p = _adc(step4_mac(mx, cw, cfg.fmt), cfg)
        acc = acc + torch.where(valid.any(), step5_renormalize(p, e_max, cfg),
                                0.0)
    return acc


# ---------------------------------------------------------------------------
# Exact-mode matmul: per-(row, column, chunk) joint max alignment, one
# chunk at a time in order (the reference's scan over K chunks).
# ---------------------------------------------------------------------------

NOISE_NOT_PORTED = (
    "matmul_exact's process-variability noise replays jax.random and comes "
    "with the variability slice (ROADMAP Queue 1 item 7); only noise-free "
    "NoiseParams are accepted")


def matmul_exact(x: Tensor, w: Tensor, cfg: TFConfig = DEFAULT, *,
                 noise: Optional[NoiseParams] = None, key=None) -> Tensor:
    """(M, K) @ (K, N) with per-(row, column, chunk) joint max alignment:
    the faithful oracle, not a fast path. Each chunk materializes an
    (M, block, N) exponent-sum tensor, takes its int32 product-sum over the
    block, and adds ``p * 2^(e_max - bias)`` to an f32 accumulator, chunk by
    chunk. ``noise`` and ``key`` are the reference's variability inputs:
    any nonzero noise raises (see ``NOISE_NOT_PORTED``)."""
    if noise is not None and (noise.sigma_exp > 0 or noise.sigma_mant > 0):
        raise NotImplementedError(NOISE_NOT_PORTED)
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_exact: x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)}")
    m_dim, n_dim = x.shape[0], w.shape[1]
    xp = _pad_k(x, cfg.block, 1)
    wp = _pad_k(w, cfg.block, 0)
    n_chunks = xp.shape[1] // cfg.block
    fx = float8.decompose(xp, cfg.fmt)
    fw = float8.decompose(wp, cfg.fmt)
    # (C, M, B) and (C, B, N) layouts, one chunk at a time.
    cx = float8.F8Fields(*(a.reshape(m_dim, n_chunks, cfg.block)
                           .transpose(0, 1) for a in fx))
    cw = float8.F8Fields(*(a.reshape(n_chunks, cfg.block, n_dim)
                           for a in fw))
    mw_all = cw.significand(cfg.fmt) * cw.sign.to(torch.int32)
    mx_all = cx.significand(cfg.fmt)
    sx_all = cx.sign.to(torch.int32)
    acc = torch.zeros((m_dim, n_dim), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        s = (cx.exp[c].to(torch.int32)[:, :, None]
             + cw.exp[c].to(torch.int32)[None, :, :])       # (M, B, N)
        valid = cx.nonzero[c][:, :, None] & cw.nonzero[c][None, :, :]
        s_eff = torch.where(valid, s, _NO_EXP)
        e_max = s_eff.amax(dim=1)                            # (M, N)
        shift = torch.clamp(e_max[:, None, :] - s_eff, 0, 31)
        mx = mx_all[c][:, :, None] >> shift
        mx = torch.where(shift > cfg.fmt.man_bits, 0, mx)
        mx = torch.where(valid, mx, 0)
        p = torch.sum(mx * sx_all[c][:, :, None] * mw_all[c][None, :, :],
                      dim=1, dtype=torch.int32)              # (M, N)
        p = _adc(p, cfg)
        contrib = torch.where(
            valid.any(dim=1),
            p.to(torch.float32) * float8.exp2i(e_max - cfg.out_scale_bias),
            0.0)
        acc = acc + contrib
    return acc


def expected_sparsity(x: Tensor, w: Tensor,
                      cfg: TFConfig = DEFAULT) -> Tensor:
    """Fraction of chunk terms zeroed by shift-truncation (the paper's
    'enhancing sparsity'); exact-mode bookkeeping, an f32 0-dim tensor."""
    xp = _pad_k(x, cfg.block, 1)
    wp = _pad_k(w, cfg.block, 0)
    fx = float8.decompose(xp, cfg.fmt)
    fw = float8.decompose(wp, cfg.fmt)
    m_dim, k_pad = xp.shape
    n_dim = wp.shape[1]
    c = k_pad // cfg.block
    ex = fx.exp.to(torch.int32).reshape(m_dim, c, cfg.block)
    ew = fw.exp.to(torch.int32).reshape(c, cfg.block, n_dim)
    s = ex[:, :, :, None] + ew[None, :, :, :]               # (M, C, B, N)
    valid = (fx.nonzero.reshape(m_dim, c, cfg.block)[:, :, :, None]
             & fw.nonzero.reshape(c, cfg.block, n_dim)[None])
    e_max = torch.where(valid, s, _NO_EXP).amax(dim=2, keepdim=True)
    dropped = valid & ((e_max - s) > cfg.fmt.man_bits)
    n_valid = valid.sum(dtype=torch.int32)
    return (dropped.sum(dtype=torch.int32).to(torch.float32)
            / torch.clamp_min(n_valid, 1).to(torch.float32))


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
        return matmul_exact(x, w, cfg)
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
    _record_op("fwd", x.shape[0], x.shape[1], w.shape[1])
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
    q     — block-aligned int8 planes and per-chunk scales (None in exact
            mode).
    fq    — exact mode: the prescaled operand on the FP8 grid (f32), which
            ``matmul_exact`` re-decomposes; None in the other modes.
    """

    scale: Tensor
    q: Optional[QuantizedOperand]
    fq: Optional[Tensor] = None


def _parts(p: PreparedOperand) -> tuple:
    """The tensors of an entry, as it crosses an op or autograd boundary:
    (scale, planes, chunk scales), or (scale, fq) in exact mode."""
    return (p.scale, p.fq) if p.q is None else (p.scale, p.q.q, p.q.scale)


def _from_parts(t) -> PreparedOperand:
    if len(t) == 2:
        return PreparedOperand(t[0], None, t[1])
    return PreparedOperand(t[0], QuantizedOperand(t[1], t[2]))


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
    if cfg.mode not in ("exact", "separable", "pallas"):
        raise ValueError(f"unknown TimeFloats mode: {cfg.mode!r}")


def prepare_input(x2: Tensor, cfg: TFConfig = DEFAULT) -> PreparedOperand:
    """(M, K) activation -> cache entry (quantized once; read by fwd + dW)."""
    _check_mode(cfg)
    _QUANT_COUNTS["prepare_input"] += 1
    xs, s = _pow2_prescale(x2, cfg)
    return _quantized_entry(xs, s, cfg, quantize_input)


# Elements of weight quantized at once: the quantizer's temporaries take
# ~40 bytes an element, so a slab of 2^26 (a 7168 x 9362 column slab of
# deepseek-v3's head, 4 of its 7168 x 2048 experts) stays near 2.7 GB where
# the whole head would take ~40 GB.
QUANT_SLAB_ELEMS = 1 << 26


def _quantized_entry(a: Tensor, s: Tensor, cfg: TFConfig,
                     quantizer) -> PreparedOperand:
    """The entry of a prescaled operand ``a``: its planes, or in exact mode
    its values on the FP8 grid."""
    if cfg.mode == "exact":
        return PreparedOperand(scale=s, q=None,
                               fq=float8.quantize(a, cfg.fmt))
    return PreparedOperand(scale=s, q=quantizer(a, cfg))


def _prepare_weight_slabs(w: Tensor, cfg: TFConfig, batch: int
                          ) -> PreparedOperand:
    """Prescale ``w`` (..., K, N) per tensor of its ``batch`` leading dims
    and quantize it in column slabs of at most ``QUANT_SLAB_ELEMS``
    elements, written into the whole planes: each column's blocks are its
    own, so the planes are bitwise those of one call on the whole."""
    s = _prescale_of(w, cfg, batch)
    n_dim = w.shape[-1]
    per = max(1, QUANT_SLAB_ELEMS // max(w.numel() // max(n_dim, 1), 1))
    if per >= n_dim or cfg.mode == "exact":
        return _quantized_entry(w.to(torch.float32) * _lift(s, w.ndim), s,
                                cfg, quantize_weight)
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
    return _quantized_entry(xs, s, cfg, quantize_input)


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
    return _from_parts([torch.cat(ts) for ts in zip(*map(_parts, parts))])


def _slice_prepared(p: PreparedOperand, g) -> PreparedOperand:
    return _from_parts([t[g] for t in _parts(p)])


def _matmul_prepared_experts(px: PreparedOperand, pw: PreparedOperand,
                             m_dim: int, k_dim: int, n_dim: int,
                             cfg: TFConfig) -> Tensor:
    """(E, M, N) products of stacked cache entries; expert e's is
    bit-identical to ``_matmul_prepared`` on its slices."""
    with census_scale(px.q.q.shape[0]):   # the group's experts
        _record_op("fwd", m_dim, k_dim, n_dim)
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
    if x.is_meta:
        with census_scale(w.shape[0]):
            return _meta_product(x.shape[1], x.shape[2], w.shape[2], x,
                                 lead=(w.shape[0],))
    if cfg.mode == "exact":   # expert by expert: the oracle, not a fast path
        return torch.stack([
            linear(x[e], w[e], cfg) if pw is None
            else linear_cached(x[e], w[e], _slice_prepared(pw, e), cfg)
            for e in range(w.shape[0])])
    parts = (None, None, None) if pw is None else (pw.scale, pw.q.q,
                                                   pw.q.scale)
    return _ExpertLinear.apply(x, w, *parts, cfg)


def _matmul_prepared(px: PreparedOperand, pw: PreparedOperand, m_dim: int,
                     k_dim: int, n_dim: int, cfg: TFConfig) -> Tensor:
    """Forward product from cache entries; bit-identical to
    ``matmul(xs, ws, cfg)`` on the prescaled operands."""
    _record_op("fwd", m_dim, k_dim, n_dim)
    if cfg.mode == "exact":
        return matmul_exact(px.fq, pw.fq, cfg)
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
    in the reference. Exact mode re-MACs the stored FP8 values with joint
    alignment (the oracle)."""
    gs, sg = _pow2_prescale(g2, cfg)
    if cfg.mode == "exact":
        dx = matmul_exact(gs, pw.fq.T, cfg) / (sg * pw.scale)
        dw = matmul_exact(px.fq.T, gs, cfg) / (px.scale * sg)
        return dx, dw
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


def _prepare_weight_entry(w: Tensor, cfg: TFConfig) -> PreparedOperand:
    """A projection's weight entry: through its op, or directly in exact
    mode (whose entry is no plane set)."""
    if cfg.mode == "exact":
        return prepare_weight(w, cfg)
    return _from_parts(_prepare_weight_op(w, *_cfg_args(cfg)))


def _forward_prepared(x2: Tensor, pw: PreparedOperand, n_dim: int,
                      cfg: TFConfig) -> tuple[Tensor, PreparedOperand]:
    if cfg.mode == "exact":
        px = prepare_input(x2, cfg)
        y = _matmul_prepared(px, pw, x2.shape[0], x2.shape[1], n_dim, cfg)
        return y / (px.scale * pw.scale), px
    y, *px = _project_op(x2, pw.scale, pw.q.q, pw.q.scale, n_dim,
                         *_cfg_args(cfg))
    return y, _from_parts(px)


# The residuals go through ctx.save_for_backward, so activation
# checkpointing (models/model.py, remat="full") can drop and recompute them.
def _save(ctx, *ops: PreparedOperand) -> None:
    parts = [_parts(op) for op in ops]
    ctx.n_parts = [len(p) for p in parts]
    ctx.save_for_backward(*(t for p in parts for t in p))


def _load(ctx) -> list:
    t, out, at = ctx.saved_tensors, [], 0
    for n in ctx.n_parts:
        out.append(_from_parts(t[at:at + n]))
        at += n
    return out


class _Linear(torch.autograd.Function):
    """``linear``: forward quantizes each operand once; backward reads the
    residuals (quantized planes with ``cfg.cache``, else the raw operands,
    re-quantized there: bit-identical)."""

    @staticmethod
    def forward(ctx, x2, w, cfg):
        ctx.cfg, ctx.k_dim, ctx.dtypes = cfg, x2.shape[1], (x2.dtype, w.dtype)
        if cfg.cache:
            pw = _prepare_weight_entry(w, cfg)
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
    """``linear_cached``: the weight's cache entry ``pw`` is an input (its
    tensors, :func:`_parts`); it takes no gradient, and ``w`` is only the
    gradient's attachment point."""

    @staticmethod
    def forward(ctx, x2, w, cfg, *pw_parts):
        ctx.cfg, ctx.k_dim, ctx.dtypes = cfg, x2.shape[1], (x2.dtype, w.dtype)
        y, px = _forward_prepared(x2, _from_parts(pw_parts), w.shape[1], cfg)
        _save(ctx, px, _from_parts(pw_parts))
        return y

    @staticmethod
    def backward(ctx, g):
        px, pw = _load(ctx)
        return _grads(ctx, px, pw, g) + (None,) * (1 + sum(ctx.n_parts[1:]))


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
    x2 = x.reshape(-1, x.shape[-1])
    y = (_meta_product(*x2.shape, w.shape[1], x2) if x.is_meta
         else _Linear.apply(x2, w, cfg))
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
    x2 = x.reshape(-1, x.shape[-1])
    y = (_meta_product(*x2.shape, w.shape[1], x2) if x.is_meta
         else _LinearCached.apply(x2, w, cfg, *_parts(pw)))
    return y.reshape(*lead, w.shape[-1])


def _meta_product(m_dim: int, k_dim: int, n_dim: int, like: Tensor,
                  lead: tuple = ()) -> Tensor:
    """A projection on meta tensors (the hw twin's census trace,
    ``hw/schedule.capture_census``): record its forward read as the real
    call would and return an f32 output of its shape, without tracing the
    quantizer's ops, which only shapes would come of."""
    _record_op("fwd", m_dim, k_dim, n_dim)
    return like.new_empty(lead + (m_dim, n_dim), dtype=torch.float32)


# ---------------------------------------------------------------------------
# Op census (DESIGN.md §6). Each forward crossbar read records, at the call
# that makes it, its static matmul shape, a crossbar-access tag and the
# execution multiplier of the enclosing census_scale() contexts:
#
#   fwd     — forward read:            y  = x @ W          (ADC digitizes)
#   bwd_dx  — transposed read:         dx = g @ W^T        (ADC-free, §3)
#   bwd_dw  — outer-product read:      dW = x^T @ g        (ADC-free, §3)
#
# Shapes are the (M, K, N) of the equivalent crossbar matmul with K the
# contraction dim: bwd_dx is (M, N_fwd, K_fwd) and bwd_dw (K_fwd, M_fwd,
# N_fwd).
#
# Only the forward records (tag "fwd"); backward_census() synthesizes the
# training tags, one transposed dx read and one outer dW read per
# differentiated linear. The reference records once per trace with the
# scan's trip count as multiplier; the port runs its layer, microbatch and
# dispatch-chunk loops in Python, so a read records once per execution
# (multiplier 1), and an expert group's product records once with the
# group's expert count. Nothing records inside an autograd backward: the
# recomputation of a checkpointed block (remat="full"/"dots") re-runs its
# forward there, and counting it would count the block twice.
# ---------------------------------------------------------------------------


class OpRecord(NamedTuple):
    """One crossbar matmul: tag, (M, K, N), static multiplier."""

    tag: str
    m: int
    k: int
    n: int
    mult: int


_OP_CENSUS: Optional[list] = None
_CENSUS_SCALE: int = 1


@contextlib.contextmanager
def op_census():
    """Collect OpRecords for every forward read made inside the context:

        with op_census() as events:
            loss_fn(params, batch, cfg)
        cost = hw.schedule.census_cost(backward_census(events))

    (``hw/schedule.capture_census`` does this on meta tensors, without
    running a step.) Nested uses stack: each context sees only its own
    records."""
    global _OP_CENSUS
    prev = _OP_CENSUS
    events: list = []
    _OP_CENSUS = events
    try:
        yield events
    finally:
        _OP_CENSUS = prev


@contextlib.contextmanager
def census_scale(n: int):
    """Multiply the census weight of records made inside by ``n``."""
    global _CENSUS_SCALE
    prev = _CENSUS_SCALE
    _CENSUS_SCALE = prev * int(n)
    try:
        yield
    finally:
        _CENSUS_SCALE = prev


def _record_op(tag: str, m: int, k: int, n: int) -> None:
    if _OP_CENSUS is not None and torch._C._current_graph_task_id() == -1:
        _OP_CENSUS.append(OpRecord(tag, int(m), int(k), int(n),
                                   _CENSUS_SCALE))


def backward_census(events) -> list:
    """Expand a forward census into the full training-step census: every
    differentiated linear's forward read (M, K, N) is joined by its
    transposed dx read (M, N, K) and outer dW read (K, M, N), which the
    backward executes against the stored planes."""
    out = list(events)
    for ev in events:
        if ev.tag == "fwd":
            out.append(OpRecord("bwd_dx", ev.m, ev.n, ev.k, ev.mult))
            out.append(OpRecord("bwd_dw", ev.k, ev.m, ev.n, ev.mult))
    return out
