"""Table I energy model (port of ``repro.hw.energy``, DESIGN.md §1, §6).

This module owns the paper's per-module energy constants plus the
digital-twin extensions (write energy, timing, endurance). ``core.energy``
re-exports the Table I surface so the two can never drift; new hardware
code should import from here.

TimeFloats-chip energy is a *model* of the paper's crossbar, not a
measurement of the device the port runs on; the trainer and serving
telemetry in `hw/schedule.py` book it. Constants are the
paper's Table I values at 15 nm (see DESIGN.md §1 for the two text/table
discrepancies — we follow Table I, which is the set consistent with the
headline 22.1 TOPS/W).

Beyond Table I the twin needs three constants the paper does not give;
they are explicit modeling assumptions (DESIGN.md §6):

- ``WRITE_PJ_PER_CELL`` — energy to program one memristor cell during the
  in-situ dW update. Representative RRAM SET/RESET figures span
  0.1–10 pJ/bit; we take 1 pJ/cell (one E4M4 code per cell pair in the
  paper's differential encoding; the twin books one write per weight).
- ``T_CHUNK_READ_NS`` — latency of one 64-element time-domain scalar
  product (exponent add → max detect → scale → MAC → ADC). The paper's
  RC stages are single-digit ns; 10 ns per chunk read is the projection.
- ``T_CELL_WRITE_NS`` / ``ENDURANCE_WRITES`` — 100 ns program pulse and
  1e9-cycle endurance, standard filamentary-RRAM planning numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable

# Table I: energy per 64-element FP8 scalar product (one crossbar chunk,
# one output column), in picojoules.
TABLE1_PJ: Dict[str, float] = {
    "exp_add": 1.28,      # mixed-signal exponent adder (Fig 3)
    "max_detect": 3.25,   # D-FF + MUX tournament tree (Fig 4)
    "mantissa_scale": 0.023,  # time-domain subtract + right shift (Fig 5)
    "crossbar_mac": 1.23,  # memristor crossbar (Fig 6)
    "adc": 0.021,          # shared 4-bit SAR ADC
}

CHUNK_ELEMS = 64          # crossbar height
OPS_PER_CHUNK = 2 * CHUNK_ELEMS  # 64 multiplies + 64 accumulates = 128 ops

# Digital-twin constants (modeling assumptions, not Table I — see header).
WRITE_PJ_PER_CELL = 1.0   # pJ per programmed weight cell (in-situ update)
T_CHUNK_READ_NS = 10.0    # ns per 64-element chunk scalar product
T_CELL_WRITE_NS = 100.0   # ns per cell program pulse (row-parallel writes)
ENDURANCE_WRITES = 1e9    # program/erase cycles per cell before drift


def chunk_energy_pj(*, adc: bool = True) -> float:
    """Total energy of one 64-element FP8 scalar product (paper: 5.8 pJ).

    ``adc=False`` models the transposed backward read, which bypasses the
    shared SAR ADC (DESIGN.md §3: transposed reads are ADC-free).
    """
    e = sum(TABLE1_PJ.values())
    return e if adc else e - TABLE1_PJ["adc"]


def tops_per_watt() -> float:
    """Paper headline: 128 ops / 5.8 pJ = 22.1 TOPS/W."""
    return OPS_PER_CHUNK / chunk_energy_pj()  # pJ^-1 == TOPS/W numerically


def matmul_chunks(m: int, k: int, n: int, block: int = CHUNK_ELEMS) -> int:
    """Chunk scalar products consumed by an (M,K)@(K,N) crossbar matmul:
    every output element reads ceil(K/block) chunks."""
    return m * n * math.ceil(k / block)


def matmul_energy_pj(m: int, k: int, n: int, block: int = CHUNK_ELEMS,
                     *, adc: bool = True) -> float:
    """Energy of an (M,K)@(K,N) TimeFloats matmul."""
    return matmul_chunks(m, k, n, block) * chunk_energy_pj(adc=adc)


def matmul_energy_breakdown_pj(m: int, k: int, n: int,
                               block: int = CHUNK_ELEMS) -> Dict[str, float]:
    chunks = matmul_chunks(m, k, n, block)
    return {name: chunks * e for name, e in TABLE1_PJ.items()}


def effective_tops_per_watt(m: int, k: int, n: int) -> float:
    """2MKN useful ops over modeled energy. Equals tops_per_watt() when K is
    a multiple of 64; degrades with chunk padding waste otherwise."""
    return (2 * m * k * n) / matmul_energy_pj(m, k, n)


# Table II: state-of-the-art MAC macros the paper compares against.
# (reference tag, technology, domain, input/weight precision, memory, TOPS/W)
TABLE2_SOTA = [
    ("Ours (TimeFloats)", "15nm", "Time", "FP8", "FP8", "Memristor", (22.1, 22.1)),
    ("[10] ISSCC'23 Wu", "22nm", "Hybrid", "BF16", "BF16", "SRAM", (16.22, 17.59)),
    ("[11] ISSCC'23 Guo", "28nm", "Digital", "BF16/INT8", "BF16/INT8", "SRAM", (19.5, 44.0)),
    ("[12] ISSCC'22 Wu", "28nm", "Time", "INT8/INT4", "INT8/INT4", "SRAM", (21.10, 27.75)),
    ("[13] ISSCC'24 Yuan", "28nm", "Hybrid", "BF16/INT8", "BF16/INT8", "SRAM", (22.78, 50.53)),
    ("[14] JSSC'24 Wu", "22nm", "Hybrid", "BF16", "BF16", "SRAM", (72.12, 72.12)),
    ("[15] ISSCC'21 Su", "28nm", "Analog", "INT8/INT4", "INT8/INT4", "SRAM", (15.02, 22.75)),
]


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    """Projected TimeFloats-chip energy for a model workload."""

    total_pj: float
    breakdown_pj: Dict[str, float]
    macs: int

    @property
    def total_joules(self) -> float:
        return self.total_pj * 1e-12

    @property
    def tops_per_watt(self) -> float:
        return (2 * self.macs) / self.total_pj


def model_energy(matmul_shapes: Iterable[tuple]) -> EnergyReport:
    """Aggregate energy for a list of (M, K, N) matmuls — e.g. one training
    step's projections, produced by the model's shape census."""
    total = 0.0
    macs = 0
    breakdown = {k: 0.0 for k in TABLE1_PJ}
    for m, k, n in matmul_shapes:
        for name, e in matmul_energy_breakdown_pj(m, k, n).items():
            breakdown[name] += e
        total += matmul_energy_pj(m, k, n)
        macs += m * k * n
    return EnergyReport(total_pj=total, breakdown_pj=breakdown, macs=macs)
