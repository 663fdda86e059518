"""The crossbar digital twin (port of ``repro.hw``, DESIGN.md §6).

Submodules (imported directly; this init stays empty so ``core.energy``
can re-export ``hw.energy`` without a cycle):

- ``hw.energy``   — Table I per-module energies (re-exported by
                    ``core.energy``), write-energy and timing constants,
                    workload energy aggregation.
- ``hw.arrays``   — crossbar tile geometry and macro inventory.
- ``hw.mapper``   — weight -> tile placement for a model's parameter tree,
                    with the weight cache's per-leaf rules.
- ``hw.schedule`` — the op census's costs, the step schedule, per-tile
                    write and read books, the trainer's ``HwMonitor``, the
                    serving engines' ``ServeEnergyModel`` and the
                    scheduler's admission cost.
"""
