"""Analytical energy model reproducing Table I / Table II of the paper
(port of ``repro.core.energy``).

A re-export: the Table I constants and the workload aggregation live in
``repro_torch.hw.energy``, so the arithmetic-side and hardware-side models
cannot drift. ``repro_torch.core.energy`` and ``repro_torch.hw.energy``
hold the same objects.
"""
from __future__ import annotations

from repro_torch.hw.energy import (  # noqa: F401
    CHUNK_ELEMS,
    OPS_PER_CHUNK,
    TABLE1_PJ,
    TABLE2_SOTA,
    EnergyReport,
    chunk_energy_pj,
    effective_tops_per_watt,
    matmul_chunks,
    matmul_energy_breakdown_pj,
    matmul_energy_pj,
    model_energy,
    tops_per_watt,
)

__all__ = [
    "CHUNK_ELEMS", "OPS_PER_CHUNK", "TABLE1_PJ", "TABLE2_SOTA",
    "EnergyReport", "chunk_energy_pj", "effective_tops_per_watt",
    "matmul_chunks", "matmul_energy_breakdown_pj", "matmul_energy_pj",
    "model_energy", "tops_per_watt",
]
