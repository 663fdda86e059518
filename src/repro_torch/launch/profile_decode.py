"""Where a decode step of the port's serving path spends its time.

Serves qwen3-0.6b at full width (random weights from ``--seed``, TimeFloats
``mode="pallas"``, bf16 activations) through ``Engine(slots=4,
max_len=512)``, dense by default and with ``--paged`` on the paged pool
(16-token pages, fused split-K decode through K4): four 32-token prompts
are admitted and warmed up, then ``--steps`` engine steps (one fused
decode each) run with the profiler off and ``--steps`` more under
``torch.profiler``. It prints:

- with the profiler off, wall ms per step (host clock around steps that
  end in a synchronize) and the host CPU ms this process spent per step
  (all threads), so their ratio says how busy the host was;
- with the profiler on, wall ms per step;
- device ms and kernel launches per step in all, the device's busy share
  of the wall time, and the shares of the hand kernels (K1, K3, and K4
  on the paged engine, counted as its split kernel and its combine; K2
  runs only in training, K6 only in prefill waves and unfused decode);
- the top operators by the device time of the kernels they launch
  themselves, and the top kernels by name;
- the elapsed ms (CUDA events) of prescaling and quantizing every weight
  that one decode step reads: the work a serving weight cache would
  remove. Elapsed, not busy: it includes the gaps in which the device
  waits for the host to launch the next operator.

Run from the repository root on a machine with an NVIDIA GPU:
``PYTHONPATH=src python3 -m repro_torch.launch.profile_decode``.
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import timefloats as tf
from repro_torch.models import model as model_lib
from repro_torch.serve.engine import Engine
from repro_torch.serve.request import Request

HAND_KERNELS = {"K1": "tf_matmul_kernel", "K2": "tf_matmul_t_kernel",
                "K3": "sample_kernel", "K4": "gqa_",
                "K6": "gather_pages_kernel"}


def step_weights(params) -> list:
    """Every 2-D weight one decode step contracts, as ``dense`` reshapes it
    (``wo`` over its two leading dims), then the tied head."""
    ws = []
    for lp in params["layers"]:
        for name, w in {**lp["mixer"], **lp["ffn"]}.items():
            if w.ndim < 2:
                continue
            k = math.prod(w.shape[:-1]) if name == "wo" else w.shape[0]
            ws.append(w.reshape(k, -1))
    ws.append(params["embed"].T)
    return ws


def weight_quant_ms(params, cfg, reps: int = 3) -> float:
    """Elapsed ms between CUDA events around prescaling and quantizing
    every weight of one step (device time plus launch gaps)."""
    ws = step_weights(params)

    def run():
        for w in ws:
            tf.quantize_weight(tf._pow2_prescale(w, cfg.tf)[0], cfg.tf)

    run()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_steps(params, cfg, *, steps: int, seed: int, top: int,
                  paged: bool = False) -> None:
    eng = Engine(params, cfg, slots=4, max_len=512, seed=seed, paged=paged,
                 device=params["embed"].device)
    rng = np.random.default_rng(seed)
    for i in range(4):
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 32)
                           .astype(np.int32), max_new_tokens=2 * steps + 4))
    eng.step()   # admission wave + first decode
    eng.step()   # one warm decode
    torch.cuda.synchronize()
    t0, c0 = time.monotonic(), time.process_time()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.monotonic() - t0) / steps
    cpu_ms = 1e3 * (time.process_time() - c0) / steps
    what = "paged decode step" if paged else "decode step"
    print(f"{what}, profiler off: wall_ms={wall_ms:.3f} "
          f"host_cpu_ms={cpu_ms:.3f} host_cpu_share={cpu_ms / wall_ms:.4f}",
          flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0) / steps

    report(prof, steps=steps, wall_ms=wall_ms, what=what, top=top)


def report(prof, *, steps: int, wall_ms: float, what: str, top: int) -> None:
    """Print a profile's device ms, busy share and launches per step, the
    hand kernels' shares, and the top operators and kernels."""
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if dev_ms <= 0:
        raise SystemExit("profile: the profiler recorded no device time; "
                         "time the step with CUDA events instead")
    launches = sum(e.count for e in kernels) / steps
    print(f"{what}, profiler on: wall_ms={wall_ms:.3f} "
          f"device_ms={dev_ms:.3f} "
          f"busy_share={dev_ms / wall_ms:.4f} launches={launches:g}",
          flush=True)
    for label, key in HAND_KERNELS.items():
        ms = sum(e.self_device_time_total for e in kernels
                 if key in e.key) / 1e3 / steps
        n = sum(e.count for e in kernels if key in e.key) / steps
        print(f"{label} ({key}): device_ms={ms:.3f} share={ms / dev_ms:.4f} "
              f"launches_per_step={n:g}", flush=True)
    for title, rows in (("operators", ops), ("kernels", kernels)):
        rows = sorted(rows, key=lambda e: -e.self_device_time_total)[:top]
        print(f"top {title} by device time per step:", flush=True)
        for e in rows:
            ms = e.self_device_time_total / 1e3 / steps
            print(f"  {ms:9.3f} ms {ms / dev_ms:7.4f} calls/step="
                  f"{e.count / steps:g} {e.key[:90]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--paged", action="store_true",
                    help="profile the paged engine's decode step (K4)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 1
    cfg = get_config("qwen3-0.6b", tf=tf.TFConfig(mode="pallas"))
    params = model_lib.init(cfg, args.seed)
    print(f"device: {torch.cuda.get_device_name(0)}; {cfg.name} "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, mode pallas, "
          f"{cfg.dtype}", flush=True)
    profile_steps(params, cfg, steps=args.steps, seed=args.seed,
                  top=args.top, paged=args.paged)
    print(f"weights of one step ({len(step_weights(params))}): prescale + "
          f"quantize elapsed_ms={weight_quant_ms(params, cfg):.3f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
