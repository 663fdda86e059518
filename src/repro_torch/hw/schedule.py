"""Read/write scheduler and cost model (port of ``repro.hw.schedule``,
DESIGN.md §6).

Turns an op census (``core.timefloats.op_census``) plus a tile
``Placement`` (``hw/mapper.py``) into the digital twin's projections:

- **energy** — forward reads pay the full Table I chunk energy (the SAR
  ADC digitizes every partial sum); transposed backward reads (``bwd_dx``,
  ``bwd_dw``) are ADC-free (DESIGN.md §3); in-situ dW updates pay
  ``WRITE_PJ_PER_CELL`` per programmed cell per optimizer step.
- **latency** — a throughput bound: all placed tiles (x duplication) read
  one chunk per ``T_CHUNK_READ_NS`` concurrently; writes are row-parallel
  (one ``T_CELL_WRITE_NS`` pulse per tile row). Lower bounds.
- **TOPS/W** — ``hardware_tops_per_watt`` counts every chunk at the
  paper's 128 ops (the 22.1 headline when K % 64 == 0);
  ``effective_tops_per_watt`` counts only the 2·M·K·N useful MACs, so
  chunk padding waste shows up as the gap.
- **endurance** — per-tile write counters: every optimizer step programs
  every placed cell once (each copy), so tiles age at one write per step;
  lifetime = ``ENDURANCE_WRITES`` steps.

A census is taken on the meta device (:func:`capture_census`), the port's
counterpart of the reference's ``jax.eval_shape``: shapes only, no step
run. ``HwMonitor`` adapts the twin to the training loop
(``train/trainer.run_loop(hw_monitor=)``); ``ServeEnergyModel`` to the
serving engine (per-request pJ attribution and slot-utilization
telemetry); ``AdmissionCost`` scores the scheduler's ``policy="cost"``.
``TileWearBook.export_gauges`` and ``HwMonitor.export_gauges`` write the
wear books into an ``obs.metrics.MetricsRegistry``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core import timefloats
from repro_torch.hw import energy as hw_energy
from repro_torch.hw.arrays import DEFAULT_GEOMETRY, TileGeometry
from repro_torch.hw.mapper import Placement

TAGS = ("fwd", "bwd_dx", "bwd_dw")
_ADC_BY_TAG = {"fwd": True, "bwd_dx": False, "bwd_dw": False}


@dataclasses.dataclass(frozen=True)
class CensusCost:
    """Aggregate crossbar-read cost of one traced program (e.g. one train
    step or one decode step), weighted by the census multipliers."""

    chunks_by_tag: Dict[str, int]
    energy_pj_by_tag: Dict[str, float]
    macs_by_tag: Dict[str, int]
    n_records: int

    @property
    def chunks(self) -> int:
        return sum(self.chunks_by_tag.values())

    @property
    def energy_pj(self) -> float:
        return sum(self.energy_pj_by_tag.values())

    @property
    def macs(self) -> int:
        return sum(self.macs_by_tag.values())

    @property
    def hardware_tops_per_watt(self) -> float:
        """Chunk-throughput ops (128/chunk) per energy — the paper's
        accounting; 22.1 for pure full-chunk forward reads."""
        if self.energy_pj == 0:
            return 0.0
        return self.chunks * hw_energy.OPS_PER_CHUNK / self.energy_pj

    @property
    def effective_tops_per_watt(self) -> float:
        """Useful 2·M·K·N ops per energy (padding waste included)."""
        return (2 * self.macs / self.energy_pj) if self.energy_pj else 0.0


def census_cost(events: Iterable[timefloats.OpRecord],
                block: int = hw_energy.CHUNK_ELEMS) -> CensusCost:
    chunks = {t: 0 for t in TAGS}
    macs = {t: 0 for t in TAGS}
    n = 0
    for ev in events:
        n += 1
        if ev.tag not in chunks:  # future tags: count conservatively as fwd
            chunks[ev.tag] = 0
            macs[ev.tag] = 0
        chunks[ev.tag] += ev.mult * hw_energy.matmul_chunks(
            ev.m, ev.k, ev.n, block)
        macs[ev.tag] += ev.mult * ev.m * ev.k * ev.n
    e = {t: c * hw_energy.chunk_energy_pj(adc=_ADC_BY_TAG.get(t, True))
         for t, c in chunks.items()}
    return CensusCost(chunks_by_tag=chunks, energy_pj_by_tag=e,
                      macs_by_tag=macs, n_records=n)


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to("meta")
    return x


def capture_census(trace_fn, *args, **kwargs) -> List[timefloats.OpRecord]:
    """Run ``trace_fn(*args, **kwargs)`` on the meta device with the op
    census on and return its records: the port's counterpart of the
    reference's ``jax.eval_shape`` trace. Every tensor (and numpy array)
    in the arguments, at any depth of dicts, lists and NamedTuples, is
    replaced by a meta tensor of its shape and dtype, so no device work
    runs, no live state (a cache, a page pool, an optimizer's buffers) is
    written, nothing is captured, and the kernel wrappers take their plain
    versions and count no launch; a projection on meta tensors records
    its read without quantizing (``core/timefloats._meta_product``).

    ``trace_fn`` must be a FORWARD program (loss/logits/decode), not a
    grad: only forward reads record (see the census header in
    core/timefloats.py). For a training census, pass the loss and expand
    with ``timefloats.backward_census``.
    """
    with torch.no_grad(), timefloats.op_census() as events:
        trace_fn(*tree_lib.tree_map(_to_meta, args),
                 **tree_lib.tree_map(_to_meta, kwargs))
    return events


# ---------------------------------------------------------------------------
# Step-level schedule: reads + writes against a placement.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepSchedule:
    """Cost of ONE optimizer step (reads from the census, writes from the
    placement) on the placed tile inventory."""

    read: CensusCost
    cells_written: int            # per step, incl. duplicated copies
    write_energy_pj: float
    read_latency_ns: float        # throughput lower bound over all tiles
    write_latency_ns: float       # row-parallel program pulses
    tiles: int

    @property
    def energy_pj(self) -> float:
        return self.read.energy_pj + self.write_energy_pj

    @property
    def latency_ns(self) -> float:
        return self.read_latency_ns + self.write_latency_ns


def schedule_step(placement: Placement, events, *,
                  train: bool = True) -> StepSchedule:
    """Schedule one step's census onto the placement. ``train=False``
    (serving) books no writes — inference never programs the arrays."""
    geom = placement.geometry
    read = census_cost(events, block=geom.rows)
    tiles = max(placement.tiles, 1)
    read_lat = read.chunks / tiles * hw_energy.T_CHUNK_READ_NS
    if train:
        cells = placement.cells_written_per_update
        # Row-parallel programming: each tile writes its rows sequentially,
        # all tiles in parallel -> geom.rows pulses per full rewrite.
        write_lat = geom.rows * hw_energy.T_CELL_WRITE_NS
    else:
        cells, write_lat = 0, 0.0
    return StepSchedule(
        read=read, cells_written=cells,
        write_energy_pj=cells * hw_energy.WRITE_PJ_PER_CELL,
        read_latency_ns=read_lat, write_latency_ns=write_lat,
        tiles=placement.tiles)


# ---------------------------------------------------------------------------
# Per-tile wear books (DESIGN.md §13).
# ---------------------------------------------------------------------------


class TileWearBook:
    """Per-tile write/read accounting keyed by the mapper's physical tile
    ids (`Placement.tile_spans()` — leaf ``i`` owns ids ``[start, stop)``).

    Two vectors over the full tile inventory:

    - ``writes`` (int64) — full-array program operations per tile. The
      in-situ dW update rewrites every placed cell each optimizer step, so
      training bumps every tile by exactly 1 per step; the scalar
      ``HwMonitor.writes_per_tile`` stays pinned to ``writes.max()``
      (exact under uniform traffic — the wear-leveling remap PR is what
      will make the vector diverge from the scalar).
    - ``reads`` (float64) — crossbar read *chunks* per tile. Serving books
      one forward pass per executed token via the analytic per-token
      census (`per_token_forward_cost` leaf logic), spread evenly over
      each leaf's tiles; MoE expert stacks count only the routed top_k
      copies when a ``cfg`` is given. Training reads (no per-leaf census
      attribution survives the backward expansion) spread uniformly.

    Conservation invariant (held by tests/test_torch_hw.py): under uniform
    training traffic ``writes.sum() * cells_written_per_update ==
    hw_cum_cell_writes * n_tiles`` exactly, in integers.
    """

    def __init__(self, placement: Placement, cfg: Optional[Any] = None):
        self.placement = placement
        self.spans = placement.tile_spans()
        self.n_tiles = placement.tiles
        self.writes = np.zeros(self.n_tiles, dtype=np.int64)
        self.reads = np.zeros(self.n_tiles, dtype=np.float64)
        # Read-chunks-for-ONE-token vector: per_token_forward_cost's
        # per-leaf accounting, spread evenly over the leaf's physical
        # tiles (duplication exists for read bandwidth, so duplicated
        # copies genuinely share the read traffic).
        top_k = num_experts = None
        if cfg is not None and getattr(cfg, "moe", None) is not None:
            top_k, num_experts = cfg.moe.top_k, cfg.moe.num_experts
        geom = placement.geometry
        self._token_read = np.zeros(self.n_tiles, dtype=np.float64)
        for (key, start, stop), lp in zip(self.spans, placement.leaves):
            copies = lp.copies
            if lp.rule == "expert" and top_k is not None:
                copies = max(copies // num_experts, 1) * top_k
            chunks = hw_energy.matmul_chunks(
                1, lp.rows, lp.cols, geom.rows) * copies
            if stop > start:
                self._token_read[start:stop] = chunks / (stop - start)

    # -- write side (training) --------------------------------------------
    def on_train_step(self, n: int = 1) -> None:
        """One in-situ update programs every placed tile once."""
        if self.n_tiles:
            self.writes += int(n)

    def resume_at(self, step: int) -> None:
        """Fast-forward to an absolute step count (checkpoint restore):
        every tile was programmed once per step before this process, so
        the whole vector floors at ``step`` — elementwise max keeps any
        wear already booked above it (project-then-step == step-then-step,
        regression-pinned)."""
        if self.n_tiles:
            np.maximum(self.writes, int(step), out=self.writes)

    # -- read side (serving + training) -----------------------------------
    def add_token_reads(self, tokens: int) -> None:
        """Book ``tokens`` forward passes through every placed leaf at the
        analytic per-token census (serve attribution: prefill/decode)."""
        if self.n_tiles and tokens:
            self.reads += float(tokens) * self._token_read

    def add_read_chunks(self, chunks: float) -> None:
        """Book ``chunks`` read chunks spread uniformly (train census
        reads — fwd+bwd, no per-leaf attribution)."""
        if self.n_tiles and chunks:
            self.reads += float(chunks) / self.n_tiles

    # -- views ------------------------------------------------------------
    @property
    def writes_max(self) -> int:
        return int(self.writes.max()) if self.n_tiles else 0

    @property
    def writes_sum(self) -> int:
        return int(self.writes.sum()) if self.n_tiles else 0

    @property
    def reads_max(self) -> float:
        return float(self.reads.max()) if self.n_tiles else 0.0

    @property
    def reads_sum(self) -> float:
        return float(self.reads.sum()) if self.n_tiles else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "tiles_tracked": float(self.n_tiles),
            "tile_writes_max": float(self.writes_max),
            "tile_writes_sum": float(self.writes_sum),
            "tile_reads_max": self.reads_max,
            "tile_reads_sum": self.reads_sum,
            "max_tile_endurance_frac": (self.writes_max
                                        / hw_energy.ENDURANCE_WRITES),
        }

    def export_gauges(self, registry, prefix: str = "hw_tile") -> None:
        """Labeled per-leaf gauges into an `obs.metrics.MetricsRegistry`:
        ``{prefix}_writes_max{leaf=...}`` / ``{prefix}_read_chunks{leaf=...}``
        plus unlabeled inventory totals."""
        registry.gauge(f"{prefix}s_tracked").set(float(self.n_tiles))
        registry.gauge(f"{prefix}_writes_max").set(float(self.writes_max))
        registry.gauge(f"{prefix}_writes_sum").set(float(self.writes_sum))
        registry.gauge(f"{prefix}_read_chunks_sum").set(self.reads_sum)
        for key, start, stop in self.spans:
            if stop <= start:
                continue
            registry.gauge(f"{prefix}_writes_max", leaf=key).set(
                float(self.writes[start:stop].max()))
            registry.gauge(f"{prefix}_read_chunks", leaf=key).set(
                float(self.reads[start:stop].sum()))


# ---------------------------------------------------------------------------
# Trainer telemetry.
# ---------------------------------------------------------------------------


class HwMonitor:
    """Digital-twin telemetry for the training loop.

    Built once per run from the step's census and the model's
    placement (static shapes ⇒ every step costs the same); `on_step()`
    accumulates and returns the metrics `train/trainer.run_loop` merges
    into its logging stream.
    """

    def __init__(self, placement: Placement, events):
        self.placement = placement
        self.step_schedule = schedule_step(placement, events, train=True)
        self.steps = 0
        # Per-tile wear book (DESIGN.md §13). The in-situ update rewrites
        # every placed cell each step, so under the twin's uniform traffic
        # the scalar fallback stays exactly the vector's max (one write
        # per tile per step); the vector is what the wear-leveling remap
        # will eventually skew.
        self.wear = TileWearBook(placement)
        self.writes_per_tile = 0

    @classmethod
    def for_training(cls, params, batch, model_cfg, *,
                     geom: TileGeometry = DEFAULT_GEOMETRY) -> "HwMonitor":
        """Build from one meta-device trace of the loss on a full step's
        batch (:func:`capture_census`). The forward census is expanded
        with the structural backward (one transposed dx + one outer dW
        read per linear); per-step read totals are set by the step's
        token count, so grad-accumulation microbatching does not change
        them."""
        from repro_torch.hw.mapper import map_params
        from repro_torch.models import model as model_lib

        placement = map_params(params, model_cfg, geom=geom)
        events = capture_census(
            lambda p, b: model_lib.loss_fn(p, b, model_cfg), params, batch)
        return cls(placement, timefloats.backward_census(events))

    def resume_at(self, step: int) -> None:
        """Fast-forward the wear/energy books to an absolute step count —
        called by the training loop after a checkpoint restore, so the
        cumulative writes/endurance reflect every step the modeled arrays
        were actually programmed, not just this process's. Both sides of
        the wear book advance: writes floor elementwise at ``step``, and
        the skipped steps' census read chunks are booked uniformly, so
        project-then-step equals step-then-step (regression-pinned by
        tests/test_torch_hw.py; reads agree to float rounding)."""
        delta = max(int(step) - self.steps, 0)
        self.steps = max(self.steps, int(step))
        self.wear.resume_at(step)
        if delta:
            self.wear.add_read_chunks(self.step_schedule.read.chunks * delta)
        self.writes_per_tile = self.wear.writes_max

    def on_step(self) -> Dict[str, float]:
        self.steps += 1
        self.wear.on_train_step()
        self.wear.add_read_chunks(self.step_schedule.read.chunks)
        self.writes_per_tile = self.wear.writes_max
        s = self.step_schedule
        return {
            "hw_step_energy_uj": s.energy_pj * 1e-6,
            "hw_step_read_uj": s.read.energy_pj * 1e-6,
            "hw_step_write_uj": s.write_energy_pj * 1e-6,
            "hw_cum_energy_mj": self.steps * s.energy_pj * 1e-9,
            "hw_cum_cell_writes": float(self.steps * s.cells_written),
            "hw_writes_per_tile": float(self.writes_per_tile),
            "hw_endurance_frac": (self.writes_per_tile
                                  / hw_energy.ENDURANCE_WRITES),
            "hw_tile_writes_max": float(self.wear.writes_max),
            "hw_tile_writes_sum": float(self.wear.writes_sum),
            "hw_max_tile_endurance_frac": (self.wear.writes_max
                                           / hw_energy.ENDURANCE_WRITES),
            "hw_tops_per_watt": s.read.hardware_tops_per_watt,
        }

    def summary(self) -> Dict[str, float]:
        s = self.step_schedule
        return {
            "steps": self.steps,
            "tiles": self.placement.tiles,
            "macros": self.placement.macros,
            "utilization": self.placement.utilization,
            "total_energy_j": self.steps * s.energy_pj * 1e-12,
            "total_cell_writes": self.steps * s.cells_written,
            "writes_per_tile": self.writes_per_tile,
            "endurance_frac": (self.writes_per_tile
                               / hw_energy.ENDURANCE_WRITES),
            "step_latency_us_lower_bound": s.latency_ns * 1e-3,
            "tile_writes_max": float(self.wear.writes_max),
            "tile_writes_sum": float(self.wear.writes_sum),
            "tile_reads_sum": self.wear.reads_sum,
            "tiles_tracked": float(self.wear.n_tiles),
        }

    def export_gauges(self, registry) -> None:
        """Per-tile wear gauges into an `obs.metrics.MetricsRegistry`."""
        self.wear.export_gauges(registry)
        registry.gauge("hw_endurance_frac").set(
            self.writes_per_tile / hw_energy.ENDURANCE_WRITES)


# ---------------------------------------------------------------------------
# Serving telemetry.
# ---------------------------------------------------------------------------


class ServeEnergyModel:
    """Per-request crossbar-energy attribution for the serving engines.

    Reads only (serving never writes the arrays). The decode batch runs
    all `slots` rows through every projection whether or not a slot holds
    a request, and the census energy of a dense-family decode step is
    exactly linear in the batch dim — so the per-slot decode cost is
    ``cost(slots) / slots`` and attribution is additive and independent of
    which slot a request landed in. The
    idle remainder is NOT attributed to any request; it surfaces as the
    engine's slot-utilization telemetry instead. MoE capacity padding
    makes the per-slot share approximate for MoE families (documented in
    DESIGN.md §6).

    Prefill is bucket-aware (the fused engine, DESIGN.md §7): one census
    per (bucket, batch) shape key (`prefill_bucket_pj`), then
    `on_prefill_wave` books the whole padded batched call and hands each
    REAL admitted request a ``cost / slots`` row share. A request is
    charged its full bucket-length row (admitting it caused that padded
    read); only DUMMY rows (admission-wave padding) stay unattributed,
    exactly like empty decode slots. (The reference's per-length mode,
    ``prefill_pj``/``on_prefill``, serves its legacy engine, which the
    port does not have.)
    """

    def __init__(self, slots: int, wear: Optional[TileWearBook] = None,
                 census: Callable[..., list] = None):
        self.slots = slots
        # How a step's census is taken: capture_census, or an engine's
        # memo over it (engines of one configuration share their censuses).
        self.census = census or capture_census
        # Optional per-tile wear book (DESIGN.md §13): when present, every
        # booking method's ``tokens=`` count (PADDED/executed positions,
        # like total_pj — not the attributed share) lands per-tile read
        # chunks via the analytic per-token census.
        self.wear = wear
        self.prefill_read_tokens = 0
        self.decode_read_tokens = 0
        self.decode_step_pj: Optional[float] = None   # full-batch decode
        self._prefill_pj: Dict[Any, float] = {}       # shape key -> pJ
        self.attributed_pj = 0.0
        self.prefill_attributed_pj = 0.0  # prefill share of attributed_pj
        self.decode_attributed_pj = 0.0   # decode share of attributed_pj
        self.total_pj = 0.0
        self.decode_steps = 0
        self.active_slot_steps = 0
        self.prefill_waves = 0
        # Prefix-reuse credit (paged engine, DESIGN.md §8): crossbar reads
        # the radix hit let the engine SKIP. Never added to total_pj —
        # it's energy that did not happen; telemetry reports it so the
        # savings are visible next to the attributed spend.
        self.prefix_saved_pj = 0.0
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        # Speculative decoding (DESIGN.md §12): the fused verify step's
        # crossbar reads split by chain position into accepted (emitted
        # tokens) vs rejected (verified-but-discarded) work. Both halves
        # are real spend — they also land in decode_attributed_pj — the
        # split is what prices speculation (pJ per ACCEPTED token).
        self.spec_accepted_pj = 0.0
        self.spec_rejected_pj = 0.0
        self.spec_accepted_tokens = 0
        self.spec_rejected_tokens = 0

    # -- census capture (engines pass model-level callables, which
    # capture_census runs on meta tensors: no step, no graph, no count) ---
    def observe_decode(self, decode_fn, *args) -> None:
        if self.decode_step_pj is None:
            ev = self.census(decode_fn, *args)
            self.decode_step_pj = census_cost(ev).energy_pj

    def prefill_bucket_pj(self, key, prefill_fn, *args) -> float:
        """Total pJ of one batched bucketed prefill call, traced at most
        once per shape ``key`` (the engine uses (bucket, batch))."""
        if key not in self._prefill_pj:
            ev = self.census(prefill_fn, *args)
            self._prefill_pj[key] = census_cost(ev).energy_pj
        return self._prefill_pj[key]

    # -- accounting -------------------------------------------------------
    @property
    def decode_pj_per_slot(self) -> float:
        return (self.decode_step_pj or 0.0) / self.slots

    def _book_reads(self, tokens: int, *, decode: bool) -> None:
        if not tokens:
            return
        if decode:
            self.decode_read_tokens += int(tokens)
        else:
            self.prefill_read_tokens += int(tokens)
        if self.wear is not None:
            self.wear.add_token_reads(int(tokens))

    def on_prefix_hit(self, saved_pj: float, tokens: int) -> None:
        """Book one radix prefix hit: ``saved_pj`` is the engine-computed
        cost delta between the bucket the full prompt needed and the
        executed suffix bucket (0 when pow2 bucketing absorbs the skip);
        ``tokens`` is the prefill positions skipped."""
        self.prefix_hits += 1
        self.prefix_tokens_saved += int(tokens)
        self.prefix_saved_pj += saved_pj

    def on_prefill_wave(self, pj_total: float, n_real: int,
                        tokens: int = 0) -> float:
        """Book one padded batched prefill (`pj_total` covers all `slots`
        rows at the bucket length); returns the per-request row share
        (bucket padding included — see the class docstring). The census
        is linear in the batch dim for dense families, so the share is
        independent of the engine's slot count."""
        self.prefill_waves += 1
        self.total_pj += pj_total
        share = pj_total / max(self.slots, 1)
        self.attributed_pj += share * n_real
        self.prefill_attributed_pj += share * n_real
        self._book_reads(tokens, decode=False)
        return share

    def on_decode_step(self, active_slots: int, tokens: int = 0) -> float:
        """Book one full-batch decode; returns the per-active-slot share.

        The decode accumulators add ``share * active_slots`` in booking
        order — the same float-addition sequence an event-order fold over
        the tracer's decode spans performs, which is what makes the §11
        span-pJ-equals-telemetry contract EXACT rather than approximate
        (same for the prefill accumulators in `on_prefill_wave`)."""
        self.decode_steps += 1
        self.active_slot_steps += active_slots
        self.total_pj += self.decode_step_pj or 0.0
        share = self.decode_pj_per_slot
        self.attributed_pj += share * active_slots
        self.decode_attributed_pj += share * active_slots
        self._book_reads(tokens, decode=True)
        return share

    def on_spec_step(self, active_slots: int, emitted: int, chain: int,
                     tokens: int = 0) -> Tuple[float, float, float, float]:
        """Book one fused verify step of a speculative engine
        (DESIGN.md §12): the batched call runs ``chain`` (= K+1) positions
        for all ``slots`` rows, so the per-position cost is
        ``step_pj / (slots * chain)``. An active slot's row share is its
        ``chain`` positions (identical to the non-spec per-slot share);
        across the step's active rows, ``emitted`` positions were accepted
        and the rest rejected. Returns ``(row_share, accepted_pj,
        rejected_pj, step_total)`` where ``step_total = accepted +
        rejected`` is a SINGLE float the decode accumulators add once per
        step — the same addition sequence an event-order fold over the
        decode spans' ``attributed_pj`` (and ``accepted_pj`` /
        ``rejected_pj``) args performs, keeping the §11 exactness
        contract."""
        self.decode_steps += 1
        self.active_slot_steps += active_slots
        self.total_pj += self.decode_step_pj or 0.0
        pos_share = (self.decode_step_pj or 0.0) / max(self.slots * chain, 1)
        rejected = active_slots * chain - emitted
        acc = pos_share * emitted
        rej = pos_share * rejected
        step_total = acc + rej
        self.attributed_pj += step_total
        self.decode_attributed_pj += step_total
        self.spec_accepted_pj += acc
        self.spec_rejected_pj += rej
        self.spec_accepted_tokens += int(emitted)
        self.spec_rejected_tokens += int(rejected)
        self._book_reads(tokens, decode=True)
        return pos_share * chain, acc, rej, step_total

    def telemetry(self) -> Dict[str, float]:
        out = self._telemetry_base()
        if self.wear is not None:
            out.update({
                "tile_read_chunks_sum": self.wear.reads_sum,
                "tile_read_chunks_max": self.wear.reads_max,
                "tiles_tracked": float(self.wear.n_tiles),
                "prefill_read_tokens": float(self.prefill_read_tokens),
                "decode_read_tokens": float(self.decode_read_tokens),
            })
        return out

    def _telemetry_base(self) -> Dict[str, float]:
        return {
            "attributed_pj": self.attributed_pj,
            "prefill_attributed_pj": self.prefill_attributed_pj,
            "decode_attributed_pj": self.decode_attributed_pj,
            "total_pj": self.total_pj,
            "idle_pj": self.total_pj - self.attributed_pj,
            "prefix_saved_pj": self.prefix_saved_pj,
            "prefix_hits": float(self.prefix_hits),
            "prefix_tokens_saved": float(self.prefix_tokens_saved),
            "decode_steps": float(self.decode_steps),
            "prefill_waves": float(self.prefill_waves),
            "slot_utilization": (self.active_slot_steps
                                 / (self.decode_steps * self.slots)
                                 if self.decode_steps and self.slots
                                 else 0.0),
            "decode_pj_per_token": self.decode_pj_per_slot,
            "spec_accepted_pj": self.spec_accepted_pj,
            "spec_rejected_pj": self.spec_rejected_pj,
            "spec_accepted_tokens": float(self.spec_accepted_tokens),
            "spec_rejected_tokens": float(self.spec_rejected_tokens),
            # The speculation price: ALL verify spend (accepted + rejected
            # positions) per accepted token. 0 when speculation is off.
            "spec_pj_per_accepted_token": (
                (self.spec_accepted_pj + self.spec_rejected_pj)
                / self.spec_accepted_tokens
                if self.spec_accepted_tokens else 0.0),
        }


# ---------------------------------------------------------------------------
# Admission cost + per-step budget (serve/sched.py, DESIGN.md §10).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepBudget:
    """Per-engine-step prefill admission budget (DESIGN.md §10).

    ``prefill_tokens`` bounds the prefill positions launched per step (the
    latency knob: one chunk wave of `slots * chunk_tokens` is the natural
    setting); ``prefill_pj`` bounds the projected crossbar read energy of
    those positions (the energy knob the TimeFloats twin prices). None
    disables that axis. Chunk CONTINUATIONS are pre-charged before any new
    admission — a request mid-prefill always makes progress."""

    prefill_tokens: Optional[int] = None
    prefill_pj: Optional[float] = None

    def tracker(self) -> "BudgetTracker":
        return BudgetTracker(self)


class BudgetTracker:
    """Mutable within-step remainder of a `StepBudget`."""

    def __init__(self, budget: Optional[StepBudget]):
        b = budget or StepBudget()
        self.tokens_left = (float("inf") if b.prefill_tokens is None
                            else int(b.prefill_tokens))
        self.pj_left = (float("inf") if b.prefill_pj is None
                        else float(b.prefill_pj))

    def fits(self, tokens: int, pj: float) -> bool:
        return tokens <= self.tokens_left and pj <= self.pj_left

    def spend(self, tokens: int, pj: float) -> None:
        self.tokens_left -= tokens
        self.pj_left -= pj


class AdmissionCost:
    """Host-side per-chunk prefill pJ + projected decode occupancy used by
    `serve/sched.Scheduler` to score queued requests. Built from the
    analytic per-token forward census (`per_token_forward_cost` over the
    mapped placement — shape-only, no tracing), so scoring a deep queue is
    pure arithmetic. Without a placement (quant != "timefloats") the costs
    fall back to 1.0 pJ/token: scores degrade gracefully to token counts,
    and the budget's pJ axis becomes a token bound."""

    def __init__(self, token_pj: float = 1.0, decode_token_pj: float = 1.0,
                 *, wear_weight: float = 0.0,
                 endurance: Optional[Callable[[], float]] = None):
        self.token_pj = float(token_pj)
        self.decode_token_pj = float(decode_token_pj)
        # Wear-aware admission (DESIGN.md §12 satellite): ``endurance`` is
        # a live source of the twin's endurance_frac (e.g. ``lambda:
        # monitor.summary()["endurance_frac"]``); with a positive
        # ``wear_weight`` every projected token surcharges by
        # ``wear_weight * endurance_frac * token_pj``, deprioritizing
        # token-hungry requests as the modeled array wears. The default
        # weight 0.0 keeps scores bit-identical to the unweighted cost.
        self.wear_weight = float(wear_weight)
        self._endurance = endurance

    @property
    def endurance_frac(self) -> float:
        return float(self._endurance()) if self._endurance is not None \
            else 0.0

    @classmethod
    def for_model(cls, params, cfg, *, wear_weight: float = 0.0,
                  endurance: Optional[Callable[[], float]] = None
                  ) -> "AdmissionCost":
        if getattr(cfg, "quant", None) != "timefloats":
            return cls(wear_weight=wear_weight, endurance=endurance)
        from repro_torch.hw.mapper import map_params

        c = per_token_forward_cost(map_params(params, cfg), cfg)
        return cls(token_pj=c.energy_pj, decode_token_pj=c.energy_pj,
                   wear_weight=wear_weight, endurance=endurance)

    def prefill_pj(self, tokens: int) -> float:
        """Projected crossbar pJ of prefilling ``tokens`` positions (one
        chunk, one bucket row — the census is linear in positions)."""
        return tokens * self.token_pj

    def request_score(self, remaining_prompt: int, max_new: int) -> float:
        """Total projected cost of finishing a request from here: the
        un-prefilled prompt remainder plus its decode-slot occupancy
        (max_new decode reads), plus the optional wear surcharge (see
        ``__init__``). Lower = cheaper to serve = admitted first under
        the "cost" policy."""
        score = (remaining_prompt * self.token_pj
                 + max_new * self.decode_token_pj)
        if self.wear_weight and self._endurance is not None:
            score += (self.wear_weight * self.endurance_frac
                      * (remaining_prompt + max_new) * self.token_pj)
        return score


def edge_mlp_forward(ws, x, tf_cfg):
    """The paper-scale edge MLP's forward as the twin traces it: the
    layers' TimeFloats ``linear``s back to back (what the crossbar reads;
    the activation between them is digital)."""
    h = x
    for w in ws:
        h = timefloats.linear(h, w, tf_cfg)
    return h


def edge_mlp_schedule(cfg, *, geom: TileGeometry = DEFAULT_GEOMETRY,
                      events=None) -> Tuple[Placement, "StepSchedule"]:
    """The census-driven projection of one training step of the edge MLP
    (``configs/timefloats_mlp.EdgeMLPConfig``): forward reads plus the
    structural backward (transposed dx, outer dW) plus the in-situ writes,
    on ``hw.mapper.map_edge_mlp``'s placement. ``events`` is a forward
    census taken elsewhere (a real forward under ``op_census``); by
    default the forward is traced on meta tensors. The paper's 22.1 TOPS/W
    is ``schedule.read.hardware_tops_per_watt``."""
    from repro_torch.hw.mapper import map_edge_mlp

    pl = map_edge_mlp(cfg, geom=geom)
    if events is None:
        dims = (cfg.in_dim, *cfg.hidden, cfg.n_classes)
        ws = [torch.empty((k, n)) for k, n in zip(dims[:-1], dims[1:])]
        x = torch.empty((cfg.batch, cfg.in_dim))
        events = capture_census(edge_mlp_forward, ws, x, cfg.tf)
    return pl, schedule_step(pl, timefloats.backward_census(events),
                             train=True)


def per_token_forward_cost(placement: Placement,
                           cfg: Optional[Any] = None) -> CensusCost:
    """Analytic forward-read census for ONE token through every placed
    array: each copy of each leaf is one (1, rows, cols) read, except MoE
    expert stacks where a token reads only its routed top_k experts (per
    layer), and shared experts/dense leaves read every copy."""
    top_k = num_experts = None
    if cfg is not None and getattr(cfg, "moe", None) is not None:
        top_k, num_experts = cfg.moe.top_k, cfg.moe.num_experts
    events = []
    for lp in placement.leaves:
        copies = lp.copies
        if lp.rule == "expert" and top_k is not None:
            copies = max(copies // num_experts, 1) * top_k  # layers x top_k
        events.append(timefloats.OpRecord("fwd", 1, lp.rows, lp.cols, copies))
    return census_cost(events, block=placement.geometry.rows)
