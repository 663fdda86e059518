"""Where a training step of the port's training path spends its time.

Trains qwen3-0.6b at full width (random weights from ``--seed``, TimeFloats
``mode="pallas"``, bf16 activations, ``remat="full"``, AdamW) on batches of
``--batch`` x ``--seq`` tokens: one warm-up step, then ``--steps`` steps
with the profiler off and ``--steps`` more under ``torch.profiler``. It
prints:

- with the profiler off, wall ms per step (host clock around steps that
  end by reading the loss) and the host CPU ms this process spent per step
  (all threads), so their ratio says how busy the host was;
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-0.6b", tf=tf.TFConfig(mode="pallas"))
    tcfg = tsl.TrainConfig(optimizer=OptimizerConfig(name="adamw", warmup=1))
    state = tsl.init_state(cfg, tcfg, args.seed, "cuda")
    pipe = DataPipeline(cfg, args.batch, args.seq, seed=args.seed, kind="lm",
                        device="cuda")
    step_fn = tsl.make_train_step(cfg, tcfg)
    print(f"device: {torch.cuda.get_device_name(0)}; {cfg.name} "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, mode pallas, "
          f"{cfg.dtype}, remat {cfg.remat}, batch {args.batch} x "
          f"{args.seq}", flush=True)

    def run(n: int) -> float:
        nonlocal state
        t0 = time.monotonic()
        for _ in range(n):
            state, m = step_fn(state, pipe.batch_at(state.step))
            float(m["loss"])  # waits for the device: the step's end
        return 1e3 * (time.monotonic() - t0) / n

    run(1)  # warm-up: allocator, cuBLAS handles, kernel builds
    c0 = time.process_time()
    wall_ms = run(args.steps)
    cpu_ms = 1e3 * (time.process_time() - c0) / args.steps
    print(f"training step, profiler off: wall_ms={wall_ms:.3f} "
          f"host_cpu_ms={cpu_ms:.3f} host_cpu_share={cpu_ms / wall_ms:.4f} "
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.2f}",
          flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = run(args.steps)
    report(prof, steps=args.steps, wall_ms=wall_ms, what="training step",
           top=args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
