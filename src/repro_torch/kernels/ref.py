"""Plain-PyTorch oracle for the TimeFloats matmul kernel (port of
``repro.kernels.ref``): the chunk-ordered int8 MAC on quantized operands is
the kernel's bit-exact spec."""
from __future__ import annotations

import torch

from repro_torch.core.timefloats import (DEFAULT, QuantizedOperand, TFConfig,
                                         matmul_from_quantized)


def quantized_matmul_ref(qx: QuantizedOperand, qw: QuantizedOperand,
                         cfg: TFConfig = DEFAULT) -> torch.Tensor:
    """Oracle on pre-quantized operands (the kernel's input contract)."""
    return matmul_from_quantized(qx, qw, cfg)
