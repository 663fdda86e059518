"""Training loop with the fault-tolerance machinery (port of
``repro.train.trainer``):

- auto-resume from the latest checkpoint;
- periodic and final checkpoints (atomic, keep-N, async);
- a step watchdog: a step slower than ``straggler_factor`` times the running
  median is counted as a straggler event and triggers an emergency
  checkpoint;
- deterministic data: batch = f(seed, step), so a restart replays the same
  stream;
- digital-twin telemetry (DESIGN.md §6): pass ``hw_monitor`` (an
  ``hw.schedule.HwMonitor``, built from the step's census and the model's
  crossbar placement) and every step's metrics carry the projected crossbar
  energy, cumulative in-situ cell writes and per-tile endurance; a resumed
  run fast-forwards the books to its step, and the loop report and the
  final checkpoint's metadata carry the run totals;
- observability (DESIGN.md §11, §13): with a ``tracer`` the loop emits
  ``train.batch``, ``train.step`` (step, loss, the twin's step energy),
  ``train.checkpoint`` (periodic, straggler, final) and ``train.restore``
  spans, ``train.straggler`` instants and an ``hw.endurance_frac``
  counter track; ``metrics_registry`` gets ``train_step_s``,
  ``train_steps``, ``train_straggler_events`` and ``train_loss`` (and the
  twin's per-tile wear gauges at the end); ``health`` watches the
  ``train.step_s`` series and the twin's per-step tile write rate.

The step donates its state (train/step.py): the state it returns is its
own buffers, which its next call overwrites, so a checkpoint copies every
leaf to the host on this thread before the next step (as
``CheckpointManager.save`` does), and a restored state is copied into the
buffers by the step itself.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.obs.trace import NOOP, TID_TRAIN
from repro_torch.train.step import TrainState


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep: int = 3
    straggler_factor: float = 3.0
    min_median_window: int = 5


@dataclasses.dataclass
class LoopReport:
    steps_run: int
    final_step: int
    losses: List[float]
    straggler_events: int
    resumed_from: Optional[int]
    hw: Optional[Dict[str, float]] = None   # HwMonitor.summary() totals


def run_loop(state: TrainState, train_step: Callable,
             batch_fn: Callable[[int], Dict[str, torch.Tensor]],
             cfg: LoopConfig, *,
             on_metrics: Optional[Callable[[int, Dict[str, float]], None]]
             = None, hw_monitor: Optional[Any] = None, tracer=None,
             metrics_registry=None, health: Optional[Any] = None
             ) -> tuple[TrainState, LoopReport]:
    tr = tracer or NOOP
    m_step_s = m_steps = m_stragglers = m_loss = None
    if metrics_registry is not None:
        m_step_s = metrics_registry.histogram("train_step_s")
        m_steps = metrics_registry.counter("train_steps")
        m_stragglers = metrics_registry.counter("train_straggler_events")
        m_loss = metrics_registry.gauge("train_loss")
    mgr = (CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
           if cfg.ckpt_dir else None)
    resumed_from = None
    if mgr is not None:
        latest = mgr.latest_step()
        if latest is not None:
            with tr.span("train.restore", "train", tid=TID_TRAIN,
                         step=latest):
                state = mgr.restore(latest, state)
            resumed_from = latest

    losses: List[float] = []
    durations: List[float] = []
    stragglers = 0
    start = int(state.step)
    if hw_monitor is not None and start:
        # A resumed run: the modeled arrays were already programmed
        # ``start`` times.
        hw_monitor.resume_at(start)
    for step in range(start, cfg.total_steps):
        with tr.span("train.batch", "train", tid=TID_TRAIN, step=step):
            batch = batch_fn(step)
        t0 = time.monotonic()
        # The loss read waits for the device, so the span covers the
        # step's device work, not only its launch.
        with tr.span("train.step", "train", tid=TID_TRAIN,
                     step=step) as sp:
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
        dt = time.monotonic() - t0
        losses.append(loss)
        if hw_monitor is not None:  # the twin's energy and write books
            prev_wpt = hw_monitor.writes_per_tile
            metrics = dict(metrics)
            metrics.update(hw_monitor.on_step())
            if tr.enabled:
                sp.set(step_energy_uj=float(metrics["hw_step_energy_uj"]))
                tr.counter("hw.endurance_frac",
                           float(metrics["hw_endurance_frac"]),
                           tid=TID_TRAIN)
            if health is not None:
                # The per-step write rate: the cumulative count only grows
                # and would always alert.
                health.observe(
                    "hw.tile_write_rate",
                    float(metrics["hw_writes_per_tile"]) - float(prev_wpt))
        if health is not None:
            health.observe("train.step_s", dt)
        if tr.enabled:
            sp.set(loss=loss)
        if m_steps is not None:
            m_steps.inc()
            m_step_s.observe(dt)
            m_loss.set(loss)

        if len(durations) >= cfg.min_median_window:
            med = statistics.median(durations)
            if dt > cfg.straggler_factor * med:
                stragglers += 1
                if m_stragglers is not None:
                    m_stragglers.inc()
                tr.instant("train.straggler", "train", tid=TID_TRAIN,
                           step=step, dt=dt, median=med)
                if mgr is not None:  # emergency checkpoint
                    with tr.span("train.checkpoint", "train",
                                 tid=TID_TRAIN, step=step + 1,
                                 reason="straggler"):
                        mgr.save(step + 1, state, {"reason": "straggler",
                                                   "dt": dt, "median": med})
        durations.append(dt)

        if on_metrics and (step % cfg.log_every == 0
                           or step == cfg.total_steps - 1):
            on_metrics(step, dict({k: float(v) for k, v in metrics.items()},
                                  step_s=dt))
        if mgr is not None and (step + 1) % cfg.ckpt_every == 0:
            with tr.span("train.checkpoint", "train", tid=TID_TRAIN,
                         step=step + 1, reason="periodic"):
                mgr.save(step + 1, state)

    hw = hw_monitor.summary() if hw_monitor is not None else None
    if mgr is not None:
        with tr.span("train.checkpoint", "train", tid=TID_TRAIN,
                     step=cfg.total_steps, reason="final"):
            mgr.save(cfg.total_steps, state,
                     None if hw is None else {"hw": hw})
            mgr.wait()
    if hw_monitor is not None and metrics_registry is not None:
        # The per-tile wear gauges: labeled per-leaf write and read books.
        hw_monitor.export_gauges(metrics_registry)
    return state, LoopReport(steps_run=cfg.total_steps - start,
                             final_step=int(state.step), losses=losses,
                             straggler_events=stragglers,
                             resumed_from=resumed_from, hw=hw)
