"""Where a decode step of the port's serving path spends its time.

Serves ``--arch`` (qwen3-0.6b by default; ``--n-layers`` cuts its depth,
as the reference's ``get_config`` overrides do, so ``--arch
deepseek-v3-671b --n-layers 3`` runs deepseek-v3's three dense MLA layers,
and ``--n-layers 4 --param-dtype bfloat16`` adds its first MoE layer)
at full width (random weights from ``--seed``, TimeFloats
``mode="pallas"``, bf16 activations) through ``Engine(slots=4,
max_len=512)``, dense by default and with ``--paged`` on the paged pool
(16-token pages, fused split-K decode through K4, or K5 for MLA), with
each step callable captured into a CUDA graph and replayed (``--graphs``,
the engine's default on the card; ``--no-graphs`` runs it eagerly): four
32-token prompts are admitted and warmed up (the admission wave's and the
decode's graphs are captured there), then ``--steps`` engine steps (one
fused decode each) run with the profiler off and ``--steps`` more under
``torch.profiler``. It prints:

- the graphs captured while warming up, their capture seconds and the
  peak device memory;
- with the profiler off, wall ms per step (host clock around steps that
  end in a synchronize) and the host CPU ms this process spent per step
  (all threads), so their ratio says how busy the host was;
- with the profiler on, wall ms per step;
- device ms and kernel launches per step in all, the device's busy share
  of the wall time, and the shares of the hand kernels (K1, K3, and K4
  or K5 on the paged engine, one kernel each; K2 runs only in training,
  K6 only in prefill waves and unfused decode);
- the top operators by the device time of the kernels they launch
  themselves, and the top kernels by name;
- the elapsed ms (CUDA events) of prescaling and quantizing every weight
  that one decode step reads: the work a serving weight cache would
  remove. Elapsed, not busy: it includes the gaps in which the device
  waits for the host to launch the next operator.

Run from the repository root on a machine with an NVIDIA GPU:
``PYTHONPATH=src python3 -m repro_torch.launch.profile_decode [--paged]
[--arch deepseek-v3-671b --n-layers 3] [--param-dtype bfloat16]
[--no-graphs]``.
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

HAND_KERNELS = {"K1": "tf_mma_kernel", "K2": "tf_matmul_t_kernel",
                "K3": "sample_kernel", "K4": "gqa_", "K5": "mla_",
                "K6": "gather_pages_kernel"}


def step_weights(params) -> list:
    """Every weight one decode step contracts through ``dense``, as it
    reshapes it (``wo`` over its two leading dims), an MoE layer's (E, K,
    N) expert stacks as they are, then the head (the untied ``lm_head`` or
    the tied table's transpose). MLA's ``wkv_b`` is not among them (the
    absorbed decode reads it through f32 einsums), nor the f32 router."""
    ws = []
    for lp in params["layers"]:
        for name, w in {**lp["mixer"], **lp["ffn"]}.items():
            if w.ndim < 2 or name in ("wkv_b", "router"):
                continue
            if name in ("wg", "wu", "wd") and w.ndim == 3:
                ws.append(w)
                continue
            k = math.prod(w.shape[:-1]) if name == "wo" else w.shape[0]
            ws.append(w.reshape(k, -1))
    ws.append(params["lm_head"] if "lm_head" in params
              else params["embed"].T)
    return ws


def weight_quant_ms(params, cfg, reps: int = 3) -> float:
    """Elapsed ms between CUDA events around prescaling and quantizing
    every weight of one step (device time plus launch gaps)."""
    ws = step_weights(params)

    def run():
        for w in ws:
            if w.ndim == 3:
                tf.prepare_weight_stack(w, cfg.tf)
            else:
                tf.prepare_weight(w, cfg.tf)

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
                  paged: bool = False, graphs: bool = True) -> None:
    eng = Engine(params, cfg, slots=4, max_len=512, seed=seed, paged=paged,
                 device=params["embed"].device, graphs=graphs)
    rng = np.random.default_rng(seed)
    for i in range(4):
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 32)
                           .astype(np.int32), max_new_tokens=2 * steps + 4))
    eng.step()   # admission wave + first decode
    eng.step()   # one warm decode
    torch.cuda.synchronize()
    g = eng.graphs
    print(f"graphs={'on' if g.capture else 'off'}: step callables "
          f"{sorted(g.counts)} capture_s="
          + ",".join(f"{k}:{v:.2f}" for k, v in sorted(g.capture_s.items()))
          + f" peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.2f}",
          flush=True)
    t0, c0 = time.monotonic(), time.process_time()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.monotonic() - t0) / steps
    cpu_ms = 1e3 * (time.process_time() - c0) / steps
    what = ("paged decode step" if paged else "decode step") + (
        " (graphs)" if graphs else " (eager)")
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
                    help="profile the paged engine's decode step (K4/K5)")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="override the configuration's depth")
    ap.add_argument("--param-dtype", default=None,
                    help="override the parameters' dtype (bfloat16 for "
                    "the MoE cut)")
    ap.add_argument("--graphs", action=argparse.BooleanOptionalAction,
                    default=True, help="replay captured CUDA graphs (the "
                    "engine's default); --no-graphs steps eagerly")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 1
    over = {k: v for k, v in (("n_layers", args.n_layers),
                              ("param_dtype", args.param_dtype))
            if v is not None}
    cfg = get_config(args.arch, tf=tf.TFConfig(mode="pallas"), **over)
    params = model_lib.init(cfg, args.seed)
    print(f"device: {torch.cuda.get_device_name(0)}; {cfg.name} "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, mode pallas, "
          f"{cfg.dtype}", flush=True)
    profile_steps(params, cfg, steps=args.steps, seed=args.seed,
                  top=args.top, paged=args.paged, graphs=args.graphs)
    print(f"weights of one step ({len(step_weights(params))}): prescale + "
          f"quantize elapsed_ms={weight_quant_ms(params, cfg):.3f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
