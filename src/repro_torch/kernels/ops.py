"""Public entry points of the TimeFloats matmul kernels (port of
``repro.kernels.ops``).

``timefloats_matmul(x, w, cfg)`` is what ``core.timefloats.matmul`` calls in
``mode="pallas"``: it quantizes both operands, pads them to K1's granule (M
to 8 rows, N to 16 columns; pad blocks carry scale 1 and zero planes, so
they contribute nothing; the kernel masks the edges of its own tiles), runs
K1 and slices the result back.
``quantized_matmul`` does the same on operands already quantized (the
training path's cache entries), ``quantized_matmul_experts`` on an MoE
layer's stacked expert operands (one K1 launch for the group). ``timefloats_matmul_transposed(g, qw,
k_dim, cfg)`` is the backward's dx: it quantizes only ``g``, along its
contraction dim N, pads M, C and N, and runs K2 on the stored planes.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.timefloats import (DEFAULT, QuantizedOperand, TFConfig,
                                         matmul_separable_transposed,
                                         quantize_input, quantize_weight)
from repro_torch.kernels import timefloats_matmul as kernel_mod


def _pad_to(a: torch.Tensor, mults: Sequence[int],
            pad_value: float = 0.0) -> torch.Tensor:
    extra = [(-s) % m for s, m in zip(a.shape, mults)]
    if not any(extra):
        return a
    widths = []
    for e in reversed(extra):  # F.pad lists the last dim first
        widths += [0, e]
    return F.pad(a, widths, value=pad_value)


def padded_operands(qx: QuantizedOperand, qw: QuantizedOperand
                    ) -> tuple[torch.Tensor, ...]:
    """(qx, sx, qw, sw) padded to K1's granule: M to ``PAD_M`` rows, N to
    ``PAD_N`` columns, pad blocks with zero planes and scale 1."""
    blk = qx.q.shape[2]
    bm, bn = kernel_mod.PAD_M, kernel_mod.PAD_N
    return (_pad_to(qx.q, (1, bm, blk)).contiguous(),
            _pad_to(qx.scale, (1, bm), pad_value=1.0).contiguous(),
            _pad_to(qw.q, (1, blk, bn)).contiguous(),
            _pad_to(qw.scale, (1, bn), pad_value=1.0).contiguous())


def quantized_matmul(qx: QuantizedOperand, qw: QuantizedOperand,
                     cfg: TFConfig = DEFAULT) -> torch.Tensor:
    """K1 on quantized operands; returns the padded (M', N') product."""
    return kernel_mod.timefloats_matmul_quantized(*padded_operands(qx, qw),
                                                  cfg=cfg)


def padded_expert_operands(qx: QuantizedOperand, qw: QuantizedOperand
                           ) -> tuple[torch.Tensor, ...]:
    """Stacked expert operands, (E,C,M,B) and (E,C,B,N) with (E,C,M),
    (E,C,N) scales, padded as :func:`padded_operands` pads one expert."""
    blk = qx.q.shape[-1]
    bm, bn = kernel_mod.PAD_M, kernel_mod.PAD_N
    return (_pad_to(qx.q, (1, 1, bm, blk)).contiguous(),
            _pad_to(qx.scale, (1, 1, bm), pad_value=1.0).contiguous(),
            _pad_to(qw.q, (1, 1, blk, bn)).contiguous(),
            _pad_to(qw.scale, (1, 1, bn), pad_value=1.0).contiguous())


def quantized_matmul_experts(qx: QuantizedOperand, qw: QuantizedOperand,
                             cfg: TFConfig = DEFAULT) -> torch.Tensor:
    """K1 over a group of experts on stacked quantized operands; returns
    the padded (E, M', N') products."""
    return kernel_mod.timefloats_matmul_experts(
        *padded_expert_operands(qx, qw), cfg=cfg)


def timefloats_matmul(x: torch.Tensor, w: torch.Tensor,
                      cfg: TFConfig = DEFAULT) -> torch.Tensor:
    """f32/bf16 (M,K) @ (K,N) through the TimeFloats kernel; f32 out."""
    m_dim, n_dim = x.shape[0], w.shape[1]
    y = quantized_matmul(quantize_input(x, cfg), quantize_weight(w, cfg), cfg)
    return y[:m_dim, :n_dim]


def padded_transposed_operands(qg: QuantizedOperand, qw: QuantizedOperand
                               ) -> tuple[torch.Tensor, ...]:
    """(qg, sg, qw, sw) padded to K2's tile: M to ``TILE_M_T`` rows, C to
    ``PLANES_T`` planes, and qw's N to the D*64 columns g was chunked into;
    pad blocks with zero planes and scale 1."""
    blk = qg.q.shape[2]
    bm, bc = kernel_mod.TILE_M_T, kernel_mod.PLANES_T
    return (_pad_to(qg.q, (1, bm, 1)).contiguous(),
            _pad_to(qg.scale, (1, bm), pad_value=1.0).contiguous(),
            _pad_to(qw.q, (bc, 1, blk)).contiguous(),
            _pad_to(qw.scale, (bc, blk), pad_value=1.0).contiguous())


def timefloats_matmul_transposed(g: torch.Tensor, qw: QuantizedOperand,
                                 k_dim: int, cfg: TFConfig = DEFAULT
                                 ) -> torch.Tensor:
    """dx = g @ W^T, (M,N) against the stored (C,64,N) planes, through K2:
    no re-quantization of the weight and no materialized W^T (DESIGN.md
    §3). With an ADC configured it takes the reference path, as the
    reference does: transposed reads are ADC-free, so the numbers agree,
    and the kernel rejects ``adc_bits``."""
    if cfg.adc_bits is not None:
        return matmul_separable_transposed(g, qw, k_dim, cfg)
    m_dim = g.shape[0]
    dx = kernel_mod.timefloats_matmul_transposed_quantized(
        *padded_transposed_operands(quantize_input(g, cfg), qw), cfg=cfg)
    return dx[:m_dim, :k_dim]
