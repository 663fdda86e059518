"""The TimeFloats matmul kernels, hand-written in CUDA.

K1, the block-aligned int8 MAC, replaces the Pallas TPU kernel ``_kernel``
/ ``timefloats_matmul_quantized`` of ``repro.kernels.timefloats_matmul``;
its source is ``csrc/timefloats_matmul.cu``. K2, the transposed read
dx = g @ W^T of the stored weight planes, replaces ``_kernel_transposed`` /
``timefloats_matmul_transposed_quantized``; its source is
``csrc/timefloats_matmul_transposed.cu``. Each source's header says what
bounds the kernel on the card and how its design meets its contract.
``timefloats_matmul_experts`` launches K1 once over a group of experts,
the counterpart of the reference's ``jax.vmap`` over
``timefloats_matmul_quantized`` in an MoE layer.

Beside each kernel: its plain PyTorch version, which the CPU tests run and
``chip_smoke.py`` holds the kernel against (K1's is the chunk-ordered
``matmul_from_quantized`` via kernels/ref.py, K2's a dequantize and one f32
matmul), and a launch counter, ``<wrapper>.launches``, bumped once per
kernel launch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.timefloats import (QuantizedOperand, TFConfig,
                                         adc_constants)
from repro_torch.kernels import _build, dispatch, ref

BLOCK = 64       # crossbar height the kernels are written for
PAD_M = 8        # K1: rows are padded to this (the kernel's TMA boxes)
PAD_N = 16       # K1: columns are padded to this (16-byte weight rows)
TILE_M_T = 128   # K2: output rows per CUDA block (two wgmma warpgroups)
PLANES_T = 2     # K2: weight planes (64 output columns each) per CUDA block
MIN_CHUNKS_PER_SPLIT = 8   # K2: a split's run of N must fill its stage ring
MAX_SPLITS = 8             # K1, K2: a tile's splits form one (portable) cluster
SMEM_LIMIT = 232448        # shared memory a block may use on the card


class K1Config(NamedTuple):
    """One of K1's tile configurations, as ``csrc/timefloats_matmul.cu``'s
    switch in ``tf_matmul_experts`` lists them: ``nt`` n8 token tiles per consumer
    warp, ``wm`` x ``wn`` consumer warps (32 columns each), ``stages`` ring
    depth."""

    nt: int
    wm: int
    wn: int
    stages: int

    @property
    def bm(self) -> int:
        return 8 * self.nt * self.wm

    @property
    def bn(self) -> int:
        return 32 * self.wn

    def smem(self, terms: int) -> int:
        """Dynamic shared memory of a launch keeping ``terms`` chunks of
        terms (the kernel's ``Cfg::smem_bytes``)."""
        r128 = lambda b: -(-b // 128) * 128  # noqa: E731
        stage = (BLOCK * self.bn + self.bm * BLOCK + r128(4 * self.bm)
                 + r128(4 * self.bn))
        return (1024 + self.stages * stage + 16 * self.stages
                + terms * self.bm * self.bn * 4)


CONFIGS = (K1Config(1, 1, 1, 16), K1Config(1, 1, 4, 6),    # decode, BM 8
           K1Config(4, 1, 1, 10), K1Config(4, 1, 2, 8),     # prefill, BM 32
           K1Config(4, 1, 4, 5),
           K1Config(4, 2, 4, 4), K1Config(4, 2, 2, 5))      # training
SMALL_M = {8: (1, 0), 32: (4, 3, 2)}      # config indices, widest first
LARGE_M = (5, 6)                          # 64x128, 64x64
SPLIT_MAX_M = 256       # above it, no split: the terms do not fit
SPLIT_MIN_C = 32        # below it, no split: a cluster costs more than it saves
FILL = 15 / 16          # a plan fills the card at this share of its SMs


class K1Plan(NamedTuple):
    config: int     # index into CONFIGS
    splits: int     # blocks (one cluster) sharing each tile's chunks


def split_chunks(c: int, splits: int) -> list[tuple[int, int]]:
    """The chunks [c_lo, c_hi) that each of a tile's ``splits`` blocks
    computes, as the kernel cuts them."""
    return [(r * c // splits, (r + 1) * c // splits) for r in range(splits)]


def k1_plan(m: int, c: int, n: int, sms: int, experts: int = 1) -> K1Plan:
    """K1's tile and split for an (M, C chunks, N) call on a card with
    ``sms`` SMs. Decode (M <= 8) and prefill (M <= 256) are bytes-bound with
    few tiles: the widest tile that fills the card, else the narrowest,
    split (from ``SPLIT_MIN_C`` chunks on) into the fewest splits that fill
    it (at most 8, at most C, terms fitting shared memory), else the most
    that fit. Larger M is operations-bound: the larger tile if it fills the
    card, else the smaller, unsplit (a split's terms would not fit). The
    choices follow chip_smoke.py's sweeps on the H100 (PERF.md). A launch
    over ``experts`` experts has that many times the tiles."""
    fill = FILL * sms
    tiles = lambda i: (experts * (-(-m // CONFIGS[i].bm))  # noqa: E731
                       * (-(-n // CONFIGS[i].bn)))
    if m > SPLIT_MAX_M:
        for i in LARGE_M:
            if tiles(i) >= fill:
                return K1Plan(i, 1)
        return K1Plan(LARGE_M[-1], 1)
    family = SMALL_M[8] if m <= 8 else SMALL_M[32]
    for i in family:
        if tiles(i) >= fill:
            return K1Plan(i, 1)
    i = family[-1]
    best = 1
    most = min(MAX_SPLITS, c) if c >= SPLIT_MIN_C else 1
    for s in range(2, most + 1):
        if CONFIGS[i].smem(-(-c // s)) > SMEM_LIMIT:
            continue
        best = s
        if tiles(i) * s >= fill:
            break
    return K1Plan(i, best)


def check_plan(plan: K1Plan, m: int, c: int, n: int) -> None:
    """Raise unless the kernel takes ``plan`` for an (M, C, N) call."""
    if not 0 <= plan.config < len(CONFIGS):
        raise ValueError(f"K1 config {plan.config}: 0 to {len(CONFIGS) - 1}")
    if not 1 <= plan.splits <= min(c, MAX_SPLITS):
        raise ValueError(f"K1 splits={plan.splits}: 1 to min(C={c}, "
                         f"{MAX_SPLITS})")
    terms = -(-c // plan.splits) if plan.splits > 1 else 0
    if CONFIGS[plan.config].smem(terms) > SMEM_LIMIT:
        raise ValueError(f"K1 {plan}: the split's terms do not fit in shared "
                         "memory")


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
    if m % PAD_M or n % PAD_N:
        raise ValueError(f"M={m}, N={n}: pad M to {PAD_M} and N to "
                         f"{PAD_N} first (kernels/ops.py)")
    for t in (qx, sx, qw, sw):
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def timefloats_matmul_quantized(qx: torch.Tensor, sx: torch.Tensor,
                                qw: torch.Tensor, sw: torch.Tensor, *,
                                cfg: TFConfig,
                                plan: K1Plan | None = None) -> torch.Tensor:
    """(C,M,64) int8 x (C,64,N) int8 with (C,M), (C,N) f32 scales -> (M,N)
    f32, chunks accumulated in order. Operands must be padded (M to
    ``PAD_M``, N to ``PAD_N``; kernels/ops.py does it). A CUDA tensor
    launches K1 (or raises) with ``plan`` (default :func:`k1_plan` for the
    card); a CPU tensor runs the plain version."""
    _check(qx, sx, qw, sw, cfg)
    if not dispatch.use_kernel(qx):
        return timefloats_matmul_plain(qx, sx, qw, sw, cfg)
    out = _launch(qx[None], sx[None], qw[None], sw[None], cfg, plan)[0]
    timefloats_matmul_quantized.launches += 1
    return out


timefloats_matmul_quantized.launches = 0


def _launch(qx, sx, qw, sw, cfg: TFConfig, plan: K1Plan | None
            ) -> torch.Tensor:
    """One K1 launch over the E experts of checked (E,C,M,64), (E,C,M),
    (E,C,64,N), (E,C,N) CUDA operands -> (E,M,N) f32."""
    if not all(t.is_cuda and t.device == qx.device for t in (sx, qw, sw)):
        raise ValueError("all operands must lie on the same CUDA device")
    if any(t.data_ptr() % 16 for t in (qx, sx, qw, sw)):
        raise ValueError("K1's tensor-map copies need 16-byte-aligned "
                         "operands")
    e, c, m, _ = qx.shape
    n = qw.shape[3]
    if plan is None:
        plan = k1_plan(m, c, n, _build.sm_count(qx.device), experts=e)
    check_plan(plan, m, c, n)
    out = torch.empty((e, m, n), dtype=torch.float32, device=qx.device)
    adc = cfg.adc_bits is not None
    fs, levels, step = ((float(v) for v in adc_constants(cfg)) if adc
                        else (1.0, 1.0, 1.0))
    err = _build.load("timefloats_matmul").tf_matmul_experts(
        qx.data_ptr(), sx.data_ptr(), qw.data_ptr(), sw.data_ptr(),
        out.data_ptr(), e, c, m, n, plan.config, plan.splits, int(adc), fs,
        levels, step, _build.stream_ptr())
    _build.check(err, "timefloats_matmul")
    return out


def timefloats_matmul_experts_plain(qx: torch.Tensor, sx: torch.Tensor,
                                    qw: torch.Tensor, sw: torch.Tensor,
                                    cfg: TFConfig) -> torch.Tensor:
    """The expert launch's plain version: the 2-D plain version, expert by
    expert."""
    return torch.stack([timefloats_matmul_plain(qx[e], sx[e], qw[e], sw[e],
                                                cfg)
                        for e in range(qx.shape[0])])


def timefloats_matmul_experts(qx: torch.Tensor, sx: torch.Tensor,
                              qw: torch.Tensor, sw: torch.Tensor, *,
                              cfg: TFConfig,
                              plan: K1Plan | None = None) -> torch.Tensor:
    """E experts' (C,M,64) x (C,64,N) products: qx (E,C,M,64), sx (E,C,M),
    qw (E,C,64,N), sw (E,C,N) -> (E,M,N) f32, each expert's bitwise the 2-D
    call on its slices. Padded as the 2-D call is (M to ``PAD_M``, N to
    ``PAD_N``). A CUDA tensor launches K1 once for all E (or raises) with
    ``plan`` (default :func:`k1_plan` over E experts' tiles); a CPU tensor
    runs the plain version."""
    if qx.ndim != 4 or qw.ndim != 4 or sx.ndim != 3 or sw.ndim != 3:
        raise ValueError(f"expert operands {tuple(qx.shape)}, "
                         f"{tuple(qw.shape)}: need (E,C,M,{BLOCK}) and "
                         f"(E,C,{BLOCK},N) with (E,C,M), (E,C,N) scales")
    e = qx.shape[0]
    if not e or any(t.shape[0] != e for t in (sx, qw, sw)):
        raise ValueError("every operand needs the same number of experts")
    _check(qx[0], sx[0], qw[0], sw[0], cfg)
    for t in (qx, sx, qw, sw):
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if not dispatch.use_kernel(qx):
        return timefloats_matmul_experts_plain(qx, sx, qw, sw, cfg)
    out = _launch(qx, sx, qw, sw, cfg, plan)
    timefloats_matmul_experts.launches += 1
    return out


timefloats_matmul_experts.launches = 0


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
        splits = k2_splits(m, c, d, _build.sm_count(qg.device))
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
