"""The TimeFloats matmul kernels, hand-written in CUDA.

K1, the block-aligned int8 MAC, replaces the Pallas TPU kernel ``_kernel``
/ ``timefloats_matmul_quantized`` of ``repro.kernels.timefloats_matmul``;
its source is ``csrc/timefloats_matmul.cu``. K2, the transposed read
dx = g @ W^T of the stored weight planes, replaces ``_kernel_transposed`` /
``timefloats_matmul_transposed_quantized``; its source is
``csrc/timefloats_matmul_transposed.cu``. Each source's header says what
bounds the kernel on the card and how its design meets its contract.

Beside each kernel: its plain PyTorch version, which the CPU tests run and
``chip_smoke.py`` holds the kernel against (K1's is the chunk-ordered
``matmul_from_quantized`` via kernels/ref.py, K2's a dequantize and one f32
matmul), and a launch counter, ``<wrapper>.launches``, bumped once per
kernel launch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.timefloats import (QuantizedOperand, TFConfig,
                                         adc_constants)
from repro_torch.kernels import _build, dispatch, ref

BLOCK = 64       # crossbar height the kernels are written for
TILE_N = 128     # K1: output columns per CUDA block
TILE_M_T = 128   # K2: output rows per CUDA block (two wgmma warpgroups)
PLANES_T = 2     # K2: weight planes (64 output columns each) per CUDA block
MIN_CHUNKS_PER_SPLIT = 8   # K2: a split's run of N must fill its stage ring
MAX_SPLITS = 8             # K2: a tile's splits form one (portable) cluster


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


# ---------------------------------------------------------------------------
# K2: the transposed read (DESIGN.md §3).
# ---------------------------------------------------------------------------


def dequantize_transposed(qg: torch.Tensor, sg: torch.Tensor,
                          qw: torch.Tensor, sw: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's operands as f32 values: gd (M, D*64) and wd (C*64, N). Exact:
    5-bit significands times power-of-two scales."""
    d, m, blk = qg.shape
    c, bk, n = qw.shape
    gd = (qg.to(torch.float32) * sg[:, :, None]).transpose(0, 1)
    wd = qw.to(torch.float32) * sw[:, None, :]
    return gd.reshape(m, d * blk), wd.reshape(c * bk, n)


def timefloats_matmul_transposed_plain(qg: torch.Tensor, sg: torch.Tensor,
                                       qw: torch.Tensor, sw: torch.Tensor
                                       ) -> torch.Tensor:
    """K2's plain version: dequantize both operands, then one f32 matmul
    contracting N (the reference's ``matmul_separable_transposed`` on the
    same planes)."""
    gd, wd = dequantize_transposed(qg, sg, qw, sw)
    return gd @ wd.T


def _check_t(qg, sg, qw, sw, cfg: TFConfig) -> None:
    if cfg.adc_bits is not None:
        raise ValueError("transposed reads are modeled ADC-free (DESIGN.md "
                         "§3); the ADC applies to forward reads only")
    d, m, blk = qg.shape
    c, bk, n = qw.shape
    if blk != BLOCK or bk != BLOCK or n != d * BLOCK:
        raise ValueError(f"operand shapes {tuple(qg.shape)} x "
                         f"{tuple(qw.shape)}: need (D,M,{BLOCK}) x "
                         f"(C,{BLOCK},D*{BLOCK})")
    if sg.shape != (d, m) or sw.shape != (c, n):
        raise ValueError(f"scale shapes {tuple(sg.shape)}, {tuple(sw.shape)}"
                         f" do not match (D,M)=({d},{m}), (C,N)=({c},{n})")
    if qg.dtype != torch.int8 or qw.dtype != torch.int8:
        raise TypeError("qg and qw must be int8")
    if sg.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError("sg and sw must be float32")
    if m % TILE_M_T or c % PLANES_T:
        raise ValueError(f"M={m}, C={c}: pad M to {TILE_M_T} and C to "
                         f"{PLANES_T} first (kernels/ops.py)")
    for t in (qg, sg, qw, sw):
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def split_plan(d_chunks: int, splits: int) -> list[tuple[int, int]]:
    """K2's cut of the contraction: split s takes the 64-chunks
    [s*D // splits, (s+1)*D // splits), as ``csrc/timefloats_matmul_
    transposed.cu`` computes it in each block."""
    return [(s * d_chunks // splits, (s + 1) * d_chunks // splits)
            for s in range(splits)]


def k2_splits(m: int, c: int, d_chunks: int, sms: int) -> int:
    """How many runs of N a K2 call cuts its contraction into: of the
    counts that keep the (M/128) * (C/2) * splits blocks, one per SM at a
    time, within one wave of the card's ``sms`` (rounded up), with at least
    ``MIN_CHUNKS_PER_SPLIT`` chunks a split, the one that leaves the fewest
    SMs idle (the least among equals)."""
    tiles = (m // TILE_M_T) * (c // PLANES_T)
    most = min(math.ceil(sms / tiles), d_chunks // MIN_CHUNKS_PER_SPLIT,
               MAX_SPLITS)
    best, best_use = 1, 0.0
    for splits in range(1, max(1, most) + 1):
        blocks = tiles * splits
        use = blocks / (math.ceil(blocks / sms) * sms)
        if use > best_use + 1e-9:
            best, best_use = splits, use
    return best


def timefloats_matmul_transposed_quantized(qg: torch.Tensor, sg: torch.Tensor,
                                           qw: torch.Tensor, sw: torch.Tensor,
                                           *, cfg: TFConfig,
                                           splits: int | None = None
                                           ) -> torch.Tensor:
    """(D,M,64) int8 gradient planes x the stored (C,64,N=D*64) weight
    planes, with (D,M), (C,N) f32 scales -> dx (M, C*64) f32. Operands must
    be padded (M to ``TILE_M_T``, C to ``PLANES_T``; kernels/ops.py does
    it). A CUDA tensor launches K2 (or raises), its contraction cut into
    ``splits`` runs (default :func:`k2_splits` for the card); a CPU tensor
    runs the plain version."""
    _check_t(qg, sg, qw, sw, cfg)
    if not dispatch.use_kernel(qg):
        return timefloats_matmul_transposed_plain(qg, sg, qw, sw)
    if not all(t.is_cuda and t.device == qg.device for t in (sg, qw, sw)):
        raise ValueError("all operands must lie on the same CUDA device")
    if any(t.data_ptr() % 16 for t in (qg, sg, qw, sw)):
        raise ValueError("K2's bulk copies need 16-byte-aligned operands")
    if cfg.fmt.man_bits > 5:
        raise ValueError("K2 converts codes |q| <= 63 (man_bits <= 5)")
    d, m, _ = qg.shape
    c = qw.shape[0]
    if splits is None:
        splits = k2_splits(m, c, d, torch.cuda.get_device_properties(
            qg.device).multi_processor_count)
    if not 1 <= splits <= min(d, MAX_SPLITS):
        raise ValueError(f"splits={splits}: 1 to min(D={d}, {MAX_SPLITS})")
    out = torch.empty((m, c * BLOCK), dtype=torch.float32, device=qg.device)
    err = _build.load("timefloats_matmul_transposed").tf_matmul_t(
        qg.data_ptr(), sg.data_ptr(), qw.data_ptr(), sw.data_ptr(),
        out.data_ptr(), d, m, c, splits, _build.stream_ptr())
    _build.check(err, "timefloats_matmul_transposed")
    timefloats_matmul_transposed_quantized.launches += 1
    return out


timefloats_matmul_transposed_quantized.launches = 0
