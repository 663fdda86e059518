"""Public entry points of the TimeFloats matmul kernel (port of
``repro.kernels.ops``, forward only).

``timefloats_matmul(x, w, cfg)`` is what ``core.timefloats.matmul`` calls in
``mode="pallas"``: it quantizes both operands, pads them to the CUDA
kernel's tile (M to 8 or 64 rows, N to 128 columns; pad blocks carry scale 1
and zero planes, so they contribute nothing), runs K1 and slices the result
back.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.timefloats import (DEFAULT, QuantizedOperand, TFConfig,
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
    """(qx, sx, qw, sw) padded to K1's tile: M to ``tile_m(M)`` rows, N to
    ``TILE_N`` columns, pad blocks with zero planes and scale 1."""
    _, m_dim, blk = qx.q.shape
    bm, bn = kernel_mod.tile_m(m_dim), kernel_mod.TILE_N
    return (_pad_to(qx.q, (1, bm, blk)).contiguous(),
            _pad_to(qx.scale, (1, bm), pad_value=1.0).contiguous(),
            _pad_to(qw.q, (1, blk, bn)).contiguous(),
            _pad_to(qw.scale, (1, bn), pad_value=1.0).contiguous())


def timefloats_matmul(x: torch.Tensor, w: torch.Tensor,
                      cfg: TFConfig = DEFAULT) -> torch.Tensor:
    """f32/bf16 (M,K) @ (K,N) through the TimeFloats kernel; f32 out."""
    m_dim, n_dim = x.shape[0], w.shape[1]
    y = kernel_mod.timefloats_matmul_quantized(
        *padded_operands(quantize_input(x, cfg), quantize_weight(w, cfg)),
        cfg=cfg)
    return y[:m_dim, :n_dim]
