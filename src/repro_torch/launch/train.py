"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --batch 4 --seq 256 --steps 3 --ckpt-dir /path/to/ckpt

Trains on one device (``--device``, default ``cuda``) with TimeFloats
arithmetic in ``--tf-mode`` (default ``pallas``: every forward projection
through the K1 kernel, every dx through K2; on a CPU tensor each kernel's
plain version runs instead). Fault tolerance comes from train/trainer.py:
atomic keep-N checkpoints, auto-resume, the straggler watchdog and
restartable data. On the card each batch shape's step is captured into a
CUDA graph at its first call and replayed after (``--graphs``, the
default there); ``--no-graphs`` runs the same step eagerly, and the CPU
takes no graphs. With ``--quant timefloats`` the hw twin's ``HwMonitor``
(placement plus a meta-device census of the loss) books each step's
projected crossbar energy and cell writes; the log lines carry the step's
uJ, the end prints the run's totals, and the final checkpoint's metadata
holds them under ``hw``. ``--trace-out PATH`` writes the run's
Chrome/Perfetto trace (``train.*`` spans, the twin's totals as its
metadata) and ``--metrics-out PATH`` the metrics registry (``.json`` a
flat dict, else Prometheus text), with the twin's per-tile wear gauges.
The reference's ``--mesh`` and ``--fake-devices`` wait for the parallel
slice.
"""
import argparse
import dataclasses
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--quant", default="timefloats",
                    choices=["timefloats", "none"])
    ap.add_argument("--tf-mode", default="pallas",
                    choices=["pallas", "separable", "exact"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["sgd", "adamw", "adafactor"])
    ap.add_argument("--insitu", action="store_true",
                    help="paper-faithful E4M4 in-situ weight updates")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced (smoke) config of the chosen arch")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto/Chrome trace-event JSON of the "
                         "run (load at ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics registry snapshot (.json = "
                         "flat dict, else Prometheus text)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--graphs", action=argparse.BooleanOptionalAction,
                    default=None, help="capture each batch shape's step into "
                    "a CUDA graph (the default on the card); --no-graphs "
                    "steps eagerly")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.core.timefloats import TFConfig
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train import step as tsl
    from repro_torch.train.trainer import LoopConfig, run_loop

    # Dequantized f32 matmuls (dW, the plain kernels) are exact only
    # without TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_for_smoke(cfg)
    cfg = dataclasses.replace(cfg, quant=args.quant,
                              tf=dataclasses.replace(cfg.tf,
                                                     mode=args.tf_mode))
    tcfg = tsl.TrainConfig(
        accum=args.accum,
        optimizer=OptimizerConfig(
            name=args.optimizer, lr=args.lr, total_steps=args.steps,
            insitu=TFConfig() if args.insitu else None))
    device = torch.device(args.device)
    if args.graphs and device.type != "cuda":
        ap.error("--graphs needs a CUDA device; the CPU steps eagerly")
    graphs = device.type == "cuda" if args.graphs is None else args.graphs
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"device {where}; arch={args.arch} quant={args.quant} "
          f"tf_mode={args.tf_mode} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} vocab={cfg.vocab_size} "
          f"graphs={'on' if graphs else 'off'}", flush=True)

    state = tsl.init_state(cfg, tcfg, args.seed, device)
    pipe = DataPipeline(cfg, batch=args.batch, seq=args.seq, seed=args.seed,
                        kind="markov" if cfg.vocab_size <= 65536 else "lm",
                        device=device)
    step_fn = tsl.make_train_step(cfg, tcfg, graphs=graphs)

    # Digital-twin telemetry (DESIGN.md §6): placement and census once,
    # then per-step energy and write counters ride the metrics.
    hw_monitor = None
    if args.quant == "timefloats":
        from repro_torch.hw.schedule import HwMonitor

        hw_monitor = HwMonitor.for_training(state.params, pipe.batch_at(0),
                                            cfg)
        pl = hw_monitor.placement
        print(f"hw twin: {pl.tiles} tiles / {pl.macros} macros "
              f"(util {pl.utilization:.1%}), "
              f"{hw_monitor.step_schedule.energy_pj / 1e6:.2f} uJ/step, "
              f"{hw_monitor.step_schedule.cells_written} cell writes/step",
              flush=True)

    def on_metrics(step, m):
        hw = (f" hw {m['hw_step_energy_uj']:.2f}uJ"
              if "hw_step_energy_uj" in m else "")
        print(f"step {step:5d} loss {m['loss']:.4f} gnorm "
              f"{m['grad_norm']:.2f} {m['step_s']:.2f}s{hw}", flush=True)

    tracer = registry = None
    if args.trace_out or args.metrics_out:
        from repro_torch.obs.metrics import MetricsRegistry
        from repro_torch.obs.trace import Tracer

        tracer = Tracer() if args.trace_out else None
        registry = MetricsRegistry()

    loop = LoopConfig(total_steps=args.steps, log_every=args.log_every,
                      ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir)
    t0 = time.monotonic()
    state, report = run_loop(state, step_fn, pipe.batch_at, loop,
                             on_metrics=on_metrics, hw_monitor=hw_monitor,
                             tracer=tracer, metrics_registry=registry)
    last = report.losses[-1] if report.losses else float("nan")
    print(f"done: steps={report.steps_run} resumed_from="
          f"{report.resumed_from} stragglers={report.straggler_events} "
          f"final_loss={last:.4f} "
          f"wall={time.monotonic() - t0:.1f}s", flush=True)
    if report.hw is not None:
        print(f"hw twin totals: {report.hw['total_energy_j']:.3e} J, "
              f"{report.hw['total_cell_writes']:.3g} cell writes, "
              f"endurance used {report.hw['endurance_frac']:.2e}",
              flush=True)
    if args.metrics_out:
        from repro_torch.obs.export import write_metrics

        write_metrics(args.metrics_out, registry)
        print(f"metrics written to {args.metrics_out}")
    if args.trace_out:
        from repro_torch.obs.export import write_chrome_trace

        payload = write_chrome_trace(
            args.trace_out, tracer,
            metadata={"hw": report.hw, "arch": args.arch})
        print(f"trace written to {args.trace_out} "
              f"({payload['metadata']['events']} events, "
              f"{payload['metadata']['dropped']} dropped)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
