"""TimeFloats scalar products in PyTorch: the forward subset.

Port of ``repro.core.timefloats``: the block-aligned (separable) int8
quantization, the chunk-ordered int8 MAC that is the forward kernel's
bit-exact spec, the dequantize-and-matmul ``separable`` form, the per-tensor
pow2 prescale and a forward ``linear``. ``mode="pallas"`` routes the MAC
through the hand-written CUDA kernel K1 (kernels/timefloats_matmul.py); the
mode keeps its reference name so configs map one to one.

Not ported yet (training slice): ``exact`` mode, the autograd function with
the transposed-read backward, the prepared-operand cache and the op census.
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

    The reference's ``cache`` field (residuals for the backward pass) comes
    with the training slice.
    """

    fmt: FloatFormat = E4M4
    block: int = 64
    adc_bits: int | None = None
    adc_mode: str = "dynamic"
    mode: str = "exact"

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
    fs = torch.tensor(float(cfg.block * cfg.max_significand**2),
                      dtype=torch.float32, device=device)
    levels = torch.tensor(float((1 << cfg.adc_bits) - 1),
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


def linear(x: Tensor, w: Tensor, cfg: TFConfig = DEFAULT) -> Tensor:
    """Forward TimeFloats linear layer: y = x @ w with per-tensor pow2
    prescaling of both operands. Accepts leading batch dims on x; returns
    f32. (The backward pass, a transposed read of the stored planes, comes
    with the training slice.)"""
    lead = x.shape[:-1]
    y = _scaled_matmul(x.reshape(-1, x.shape[-1]), w, cfg)
    return y.reshape(*lead, w.shape[-1])
