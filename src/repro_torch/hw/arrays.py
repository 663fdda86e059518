"""Crossbar tile geometry and macro inventory (port of ``repro.hw.arrays``,
DESIGN.md §6).

The paper evaluates a single 64x128 memristor array: 64 rows (the
exponent-alignment block — one chunk scalar product reads a full column
over all 64 rows) by 128 columns, with the mixed-signal exponent pipeline
shared along the rows and one SAR ADC shared across the columns. The
digital twin keeps that array as the *tile*, groups tiles into *macros*
(banks sharing peripheral circuitry and one write circuit), and lets a
placement duplicate tiles for read bandwidth:

- ``rows``        — crossbar height; MUST equal the arithmetic's alignment
                    block (``TFConfig.block``), because one time-domain
                    scalar product spans exactly one column of one tile.
- ``cols``        — crossbar width (output columns per tile).
- ``tiles_per_macro`` — banks behind one shared exponent pipeline + ADC.
                    Only one bank reads per cycle; banking amortizes the
                    periphery over capacity, duplication buys bandwidth.
- ``duplication`` — read-bandwidth copies of every placed weight. Copies
                    serve forward/transposed reads in parallel; every copy
                    must also be written on each in-situ update, so the
                    write/endurance books scale with it.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    rows: int = 64            # crossbar height == alignment block (paper)
    cols: int = 128           # crossbar width (paper's evaluation array)
    tiles_per_macro: int = 8  # banks sharing one exponent pipeline + ADC
    duplication: int = 1      # read-bandwidth copies of every placement

    def __post_init__(self):
        assert self.rows > 0 and self.cols > 0
        assert self.tiles_per_macro > 0 and self.duplication >= 1

    @property
    def cells_per_tile(self) -> int:
        return self.rows * self.cols

    def tiles_for(self, rows: int, cols: int) -> tuple:
        """(tiles_r, tiles_c) grid covering a rows x cols weight matrix."""
        return (math.ceil(rows / self.rows), math.ceil(cols / self.cols))

    def macros_for(self, tiles: int) -> int:
        return math.ceil(tiles / self.tiles_per_macro)


DEFAULT_GEOMETRY = TileGeometry()
