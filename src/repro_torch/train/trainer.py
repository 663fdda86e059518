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
  final checkpoint's metadata carry the run totals.

The step donates its state (train/step.py): the state it returns is its
own buffers, which its next call overwrites, so a checkpoint copies every
leaf to the host on this thread before the next step (as
``CheckpointManager.save`` does), and a restored state is copied into the
buffers by the step itself.

The reference's observability hooks (tracer, metrics registry, health
monitors) wait for the port's observability slice.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
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
             = None, hw_monitor: Optional[Any] = None
             ) -> tuple[TrainState, LoopReport]:
    mgr = (CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
           if cfg.ckpt_dir else None)
    resumed_from = None
    if mgr is not None:
        latest = mgr.latest_step()
        if latest is not None:
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
        batch = batch_fn(step)
        t0 = time.monotonic()
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])  # waits for the device: the step's end
        dt = time.monotonic() - t0
        losses.append(loss)
        if hw_monitor is not None:  # the twin's energy and write books
            metrics = dict(metrics)
            metrics.update(hw_monitor.on_step())

        if len(durations) >= cfg.min_median_window:
            med = statistics.median(durations)
            if dt > cfg.straggler_factor * med:
                stragglers += 1
                if mgr is not None:  # emergency checkpoint
                    mgr.save(step + 1, state, {"reason": "straggler",
                                               "dt": dt, "median": med})
        durations.append(dt)

        if on_metrics and (step % cfg.log_every == 0
                           or step == cfg.total_steps - 1):
            on_metrics(step, dict({k: float(v) for k, v in metrics.items()},
                                  step_s=dt))
        if mgr is not None and (step + 1) % cfg.ckpt_every == 0:
            mgr.save(step + 1, state)

    hw = hw_monitor.summary() if hw_monitor is not None else None
    if mgr is not None:
        mgr.save(cfg.total_steps, state, None if hw is None else {"hw": hw})
        mgr.wait()
    return state, LoopReport(steps_run=cfg.total_steps - start,
                             final_step=int(state.step), losses=losses,
                             straggler_events=stragglers,
                             resumed_from=resumed_from, hw=hw)
