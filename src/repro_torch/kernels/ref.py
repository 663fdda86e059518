"""Plain-PyTorch oracles for the TimeFloats matmul kernels (port of
``repro.kernels.ref``): the chunk-ordered int8 MAC on quantized operands is
K1's bit-exact spec; the transposed read on the separable path is K2's."""
from __future__ import annotations

import torch

from repro_torch.core.timefloats import (DEFAULT, QuantizedOperand, TFConfig,
                                         matmul_from_quantized,
                                         matmul_separable_transposed)


def quantized_matmul_ref(qx: QuantizedOperand, qw: QuantizedOperand,
                         cfg: TFConfig = DEFAULT) -> torch.Tensor:
    """Oracle on pre-quantized operands (the kernel's input contract)."""
    return matmul_from_quantized(qx, qw, cfg)


def timefloats_matmul_transposed_ref(g: torch.Tensor, qw: QuantizedOperand,
                                     k_dim: int, cfg: TFConfig = DEFAULT
                                     ) -> torch.Tensor:
    """Oracle for the transposed read: dx = g @ W^T against the stored
    planes (DESIGN.md §3), on the separable path."""
    return matmul_separable_transposed(g, qw, k_dim, cfg)
