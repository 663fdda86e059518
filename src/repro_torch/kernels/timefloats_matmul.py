"""K1: the TimeFloats block-aligned int8 MAC (hand-written CUDA kernel).

Replaces the Pallas TPU kernel ``_kernel`` / ``timefloats_matmul_quantized``
of ``repro.kernels.timefloats_matmul``. The CUDA source is
``csrc/timefloats_matmul.cu``; its header says what bounds it on the card
and how the design keeps it bitwise equal to the spec.

Beside the kernel: its plain PyTorch version (the chunk-ordered
``matmul_from_quantized`` via kernels/ref.py, which the CPU tests run and
``chip_smoke.py`` holds the kernel against) and a launch counter,
``timefloats_matmul_quantized.launches``, bumped once per kernel launch.
"""
from __future__ import annotations

import torch

from repro_torch.core.timefloats import (QuantizedOperand, TFConfig,
                                         adc_constants)
from repro_torch.kernels import _build, dispatch, ref

BLOCK = 64       # crossbar height the kernel is written for
TILE_N = 128     # output columns per CUDA block


def tile_m(m: int) -> int:
    """Rows per CUDA block: 8 for decode-sized calls, else 64."""
    return 8 if m <= 8 else 64


def timefloats_matmul_plain(qx: torch.Tensor, sx: torch.Tensor,
                            qw: torch.Tensor, sw: torch.Tensor,
                            cfg: TFConfig) -> torch.Tensor:
    """The kernel's plain version: the spec itself, on any device."""
    return ref.quantized_matmul_ref(QuantizedOperand(qx, sx),
                                    QuantizedOperand(qw, sw), cfg)


def _check(qx, sx, qw, sw, cfg: TFConfig) -> None:
    if cfg.adc_bits is not None and cfg.adc_mode != "fixed":
        raise ValueError("the TimeFloats kernel supports adc_mode='fixed' "
                         "only; dynamic ranging needs a global max")
    c, m, blk = qx.shape
    n = qw.shape[2]
    if blk != BLOCK or qw.shape != (c, blk, n):
        raise ValueError(f"operand shapes {tuple(qx.shape)} x "
                         f"{tuple(qw.shape)}: need (C,M,{BLOCK}) x "
                         f"(C,{BLOCK},N)")
    if sx.shape != (c, m) or sw.shape != (c, n):
        raise ValueError(f"scale shapes {tuple(sx.shape)}, {tuple(sw.shape)}"
                         f" do not match (C,M)=({c},{m}), (C,N)=({c},{n})")
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise TypeError("qx and qw must be int8")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError("sx and sw must be float32")
    if m % tile_m(m) or n % TILE_N:
        raise ValueError(f"M={m}, N={n}: pad M to {tile_m(m)} and N to "
                         f"{TILE_N} first (kernels/ops.py)")
    for t in (qx, sx, qw, sw):
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def timefloats_matmul_quantized(qx: torch.Tensor, sx: torch.Tensor,
                                qw: torch.Tensor, sw: torch.Tensor, *,
                                cfg: TFConfig) -> torch.Tensor:
    """(C,M,64) int8 x (C,64,N) int8 with (C,M), (C,N) f32 scales -> (M,N)
    f32, chunks accumulated in order. Operands must be padded (M to
    ``tile_m(M)``, N to ``TILE_N``; kernels/ops.py does it). A CUDA tensor
    launches K1 (or raises); a CPU tensor runs the plain version."""
    _check(qx, sx, qw, sw, cfg)
    if not dispatch.use_kernel(qx):
        return timefloats_matmul_plain(qx, sx, qw, sw, cfg)
    if not all(t.is_cuda and t.device == qx.device for t in (sx, qw, sw)):
        raise ValueError("all operands must lie on the same CUDA device")
    c, m, _ = qx.shape
    n = qw.shape[2]
    out = torch.empty((m, n), dtype=torch.float32, device=qx.device)
    adc = cfg.adc_bits is not None
    fs, levels, step = ((float(v) for v in adc_constants(cfg)) if adc
                        else (1.0, 1.0, 1.0))
    err = _build.load("timefloats_matmul").tf_matmul(
        qx.data_ptr(), sx.data_ptr(), qw.data_ptr(), sw.data_ptr(),
        out.data_ptr(), c, m, n, int(adc), fs, levels, step,
        _build.stream_ptr())
    _build.check(err, "timefloats_matmul")
    timefloats_matmul_quantized.launches += 1
    return out


timefloats_matmul_quantized.launches = 0
