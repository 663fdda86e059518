"""Where a training step of the port's training path spends its time,
with its CUDA graph and without.

Trains ``--arch`` (default qwen3-0.6b; ``--n-layers`` cuts the depth, as
``deepseek-v3-671b --n-layers 1`` gives the MLA training vehicle) at full
width (random weights from ``--seed``, TimeFloats ``mode="pallas"``, bf16
activations, ``remat="full"``, ``--optimizer``, default AdamW) on batches
of ``--batch`` x ``--seq`` tokens, in two arms in one process: the step
replaying its captured CUDA graph (``make_train_step(graphs=True)``), then
the same step eagerly (``graphs=False``), each from the same initial state
with the other's memory freed. Per arm: the first step's seconds (an eager
warm-up, and in the graph arm its capture), then ``--steps`` steps with
the profiler off and ``--steps`` more under ``torch.profiler``. It
prints:

- with the profiler off, wall ms per step (host clock around steps that
  end by reading the loss), the host CPU ms this process spent per step
  (all threads) and their ratio, the host CPU share, the graph's warm-up
  and capture seconds and the arm's peak device memory;
- with the profiler on, wall ms per step, device ms and kernel launches per
  step, the device's busy share of the wall time, and the shares of the
  hand kernels K1 (forward) and K2 (dx);
- the top operators by the device time of the kernels they launch
  themselves, and the top kernels by name.

Run from the repository root on a machine with an NVIDIA GPU:
``PYTHONPATH=src python3 -m repro_torch.launch.profile_train``.
"""
from __future__ import annotations

import argparse
import gc
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import timefloats as tf
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.profile_decode import report
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.train import step as tsl


def profile_arm(cfg, tcfg, args, graphs: bool) -> None:
    """One arm: init, first step, ``args.steps`` timed steps, then
    ``args.steps`` profiled steps."""
    # The initial state waits on the host, so the card holds one copy (the
    # step's buffers) beside the step's temporaries.
    state = tsl.on_host(tsl.init_state(cfg, tcfg, args.seed, "cuda"))
    pipe = DataPipeline(cfg, args.batch, args.seq, seed=args.seed, kind="lm",
                        device="cuda")
    step_fn = tsl.make_train_step(cfg, tcfg, graphs=graphs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    what = f"training step ({'graphs' if graphs else 'eager'})"

    def run(n: int) -> float:
        nonlocal state
        t0 = time.monotonic()
        for _ in range(n):
            state, m = step_fn(state, pipe.batch_at(state.step))
            float(m["loss"])  # waits for the device: the step's end
        return 1e3 * (time.monotonic() - t0) / n

    first_s = run(1) / 1e3  # warm-up (and capture): kernel builds, pools
    c0 = time.process_time()
    wall_ms = run(args.steps)
    cpu_ms = 1e3 * (time.process_time() - c0) / args.steps
    g = step_fn.graphs
    print(f"{what}, profiler off: wall_ms={wall_ms:.3f} "
          f"host_cpu_ms={cpu_ms:.3f} host_cpu_share={cpu_ms / wall_ms:.4f} "
          f"first_step_s={first_s:.3f} warm_up_s={sum(g.warm_s.values()):.3f}"
          f" capture_s={sum(g.capture_s.values()):.3f} "
          f"step_programs={g.counts} peak_mem_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = run(args.steps)
    report(prof, steps=args.steps, wall_ms=wall_ms, what=what, top=args.top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="override the configuration's depth")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["sgd", "adamw", "adafactor"])
    ap.add_argument("--momentum", type=float, default=0.9,
                    help="SGD's momentum (0: no optimizer state)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    over = {} if args.n_layers is None else {"n_layers": args.n_layers}
    cfg = get_config(args.arch, tf=tf.TFConfig(mode="pallas"), **over)
    tcfg = tsl.TrainConfig(optimizer=OptimizerConfig(
        name=args.optimizer, warmup=1, momentum=args.momentum))
    print(f"device: {torch.cuda.get_device_name(0)}; {cfg.name} "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, mode pallas, "
          f"{cfg.dtype}, remat {cfg.remat}, {args.optimizer} (momentum "
          f"{args.momentum}), batch {args.batch} x {args.seq}", flush=True)
    for graphs in (True, False):
        profile_arm(cfg, tcfg, args, graphs)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
