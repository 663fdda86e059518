"""Serving launcher (port of ``repro.launch.serve``): bring up the fused
engine on a model config, drain a synthetic request stream, and print the
throughput and latency report and, on a paged engine, the pool and radix
counters.

    PYTHONPATH=src python -m repro_torch.launch.serve --paged --prefix-len 48

runs full-width qwen3-0.6b on the card; ``--device cpu --reduced`` runs
the reduced config on the CPU, where every kernel's plain version runs.
``--chunk-tokens C`` prefills prompts longer than C in C-token chunk waves;
``--spec`` (greedy only) drafts ``--spec-k`` tokens a step by prompt
lookup and verifies them in one call. The request stream from ``--seed``
is the reference launcher's: prompts of 4 to min(64, max_len / 2) tokens
(with ``--spec``, tiles of one 8-token motif), each after ``--prefix-len``
shared tokens. ``--sched cost`` admits the cheapest projected crossbar
energy first (the hw twin's ``AdmissionCost``); ``--wear-weight`` adds a
wear surcharge read from a ``HwMonitor`` pre-aged by ``--wear-prior-steps``
optimizer steps. At ``--quant timefloats`` the report ends with the twin's
energy books: total and idle uJ, slot utilization, pJ per token (p50) and,
paged, the prefix credit. The report also prints the metrics registry's
TTFT and ITL percentiles (log-bucket upper bounds).

Observability (DESIGN.md §11, §13): ``--trace-out PATH`` writes the
drain's Chrome/Perfetto trace (the energy books embedded as its
metadata, checked by ``obs.export.validate_trace``), ``--metrics-out
PATH`` the registry (``.json`` a flat dict, else Prometheus text),
``--health`` runs the drift detectors and the p95 TTFT/ITL SLOs
(``--slo-ttft-p95``, ``--slo-itl-p95``), ``--inject-lag STEP:SECONDS``
sleeps before every step from STEP on (a latency regression the
detectors must catch) and ``--expect-alert`` exits 1 unless an alert
fired. Spans are host wall-clock: on the card a step's spans time its
launches, and its device work shows up in ``host_transfer``.
``python -m repro_torch.launch.obs_report TRACE --metrics METRICS
--validate`` summarizes and re-checks the written files. The reference's
``--engine legacy`` waits for the slice that ports the legacy engine.
"""
import argparse
import dataclasses
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--quant", default="timefloats",
                    choices=["timefloats", "none"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="paged cache pool + radix prefix cache")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="shared system-prompt tokens prepended to every "
                         "request (exercises the radix prefix cache)")
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="chunked prefill: pow2 chunk size (0 = whole-prompt"
                         " waves)")
    ap.add_argument("--sched", default="fcfs", choices=["fcfs", "cost"],
                    help="admission policy: arrival order or pJ-scored "
                         "cost-aware (hw twin Table-I costs)")
    ap.add_argument("--spec", action="store_true",
                    help="speculative decoding: ngram draft + batched chain "
                         "verify (greedy only)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculative chain depth (draft tokens per step)")
    ap.add_argument("--wear-weight", type=float, default=0.0,
                    help="wear-aware admission: surcharge request scores by "
                         "weight x endurance_frac (requires --sched cost, "
                         "timefloats quant)")
    ap.add_argument("--wear-prior-steps", type=int, default=0,
                    help="pre-age the wear monitor by this many optimizer "
                         "steps before serving (a fleet mid-life chip)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto/Chrome trace-event JSON of the "
                         "drain (load at ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics registry snapshot (.json = "
                         "flat dict, else Prometheus text)")
    ap.add_argument("--trace-capacity", type=int, default=1 << 16,
                    help="tracer ring size; overflow voids the trace's "
                         "energy certification")
    ap.add_argument("--health", action="store_true",
                    help="streaming drift detectors + SLO burn report")
    ap.add_argument("--slo-ttft-p95", type=float, default=5.0,
                    help="p95 TTFT objective in seconds")
    ap.add_argument("--slo-itl-p95", type=float, default=1.0,
                    help="p95 ITL objective in seconds")
    ap.add_argument("--inject-lag", default=None, metavar="STEP:SECONDS",
                    help="sleep SECONDS before every engine step from step "
                         "STEP on — a synthetic latency regression the "
                         "drift detector must catch")
    ap.add_argument("--expect-alert", action="store_true",
                    help="exit 1 unless at least one health alert fired")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--graphs", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="capture each step callable into a CUDA graph and "
                    "replay it (default: on for a CUDA device; a CPU "
                    "engine runs eagerly)")
    args = ap.parse_args(argv)
    if args.spec and args.temperature > 0:
        print("--spec requires greedy decoding (temperature 0)",
              file=sys.stderr)
        return 2
    if args.wear_weight and (args.quant != "timefloats"
                             or args.sched != "cost"):
        print("--wear-weight needs the pJ-scored scheduler on the "
              "timefloats twin (--sched cost --quant timefloats)",
              file=sys.stderr)
        return 2

    import torch

    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.core.timefloats import TFConfig
    from repro_torch.models import model as M
    from repro_torch.obs.export import (validate_health, validate_trace,
                                        write_chrome_trace, write_metrics)
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.request import Request, percentile
    from repro_torch.serve.spec import SpecConfig

    # The plain K1 takes each chunk's integer dot as an f32 matmul, exact
    # only without TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch, tf=TFConfig(mode="pallas"))
    if args.reduced:
        cfg = reduced_for_smoke(cfg)
    cfg = dataclasses.replace(cfg, quant=args.quant)
    device = torch.device(args.device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"device {where}; arch={args.arch} reduced={args.reduced} "
          f"quant={args.quant} layers={cfg.n_layers} slots={args.slots} "
          f"paged={args.paged} chunk_tokens={args.chunk_tokens} "
          f"spec={args.spec}", flush=True)

    params = M.init(cfg, args.seed, device=device)
    wear_monitor = wear_endurance = None
    if args.wear_weight:
        # A live endurance source: the per-tile wear books, optionally
        # pre-aged; census-free (an empty census costs zeros).
        from repro_torch.hw.mapper import map_params
        from repro_torch.hw.schedule import HwMonitor

        wear_monitor = HwMonitor(map_params(params, cfg), events=[])
        if args.wear_prior_steps:
            wear_monitor.resume_at(args.wear_prior_steps)
        wear_endurance = lambda: wear_monitor.summary()["endurance_frac"]
    tracer = Tracer(capacity=args.trace_capacity) if args.trace_out else None
    hm = None
    slos = ()
    if args.health:
        from repro_torch.obs.health import HealthMonitor, default_serve_slos

        hm = HealthMonitor(tracer=tracer)
        slos = default_serve_slos(args.slo_ttft_p95, args.slo_itl_p95)
    eng = Engine(params, cfg, slots=args.slots, max_len=args.max_len,
                 seed=args.seed, paged=args.paged, page_size=args.page_size,
                 chunk_tokens=args.chunk_tokens or None,
                 spec=SpecConfig(k=args.spec_k) if args.spec else None,
                 device=device, graphs=args.graphs, sched=args.sched,
                 wear_weight=args.wear_weight,
                 wear_endurance=wear_endurance, tracer=tracer, health=hm,
                 slos=slos)
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, cfg.vocab_size,
                          size=args.prefix_len).astype(np.int32)
    motif = rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
    for uid in range(args.requests):
        plen = int(rng.integers(4, min(64, args.max_len // 2)))
        if args.spec:
            # Repetitive prompts the ngram draft can extend.
            prompt = np.tile(motif, plen // len(motif) + 1)[:plen]
        else:
            prompt = rng.integers(0, cfg.vocab_size,
                                  size=plen).astype(np.int32)
        if args.prefix_len:
            prompt = np.concatenate([shared, prompt])
        eng.submit(Request(uid=uid, prompt=prompt,
                           max_new_tokens=args.max_new,
                           temperature=args.temperature))
    t0 = time.time()
    if args.inject_lag:
        # Sleeping between steps inflates the inter-token latency (its
        # basis is the previous step's token time): the series the drift
        # detector watches.
        lag_step, lag_s = args.inject_lag.split(":")
        lag_step, lag_s = int(lag_step), float(lag_s)
        done, n_steps = [], 0
        while (eng.active or eng._chunking or eng.queue) and n_steps < 10_000:
            if n_steps >= lag_step:
                time.sleep(lag_s)
            done.extend(eng.step())
            n_steps += 1
        if n_steps >= 10_000:
            print("--inject-lag: the drain did not end", file=sys.stderr)
            return 1
    else:
        done = eng.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    new_tokens = sum(len(f.tokens) for f in done)
    print(f"served {len(done)}/{args.requests} requests, {new_tokens} tokens "
          f"in {dt:.1f}s ({new_tokens / max(dt, 1e-9):.1f} tok/s)")
    lats = [f.latency_s for f in done if f.latency_s > 0]
    ttfts = [f.ttft_s for f in done if f.ttft_s > 0]
    traces = eng.compile_cache_stats()
    print(f"latency p50 {percentile(lats, 50):.2f}s p95 "
          f"{percentile(lats, 95):.2f}s | ttft p50 "
          f"{percentile(ttfts, 50):.2f}s p95 {percentile(ttfts, 95):.2f}s | "
          f"steps {eng.steps} | compiles: prefill {traces['prefill_total']}, "
          f"decode {traces['decode_total']} | host transfers "
          f"{eng.host_transfers}")

    def _hp(name: str, p: float) -> float:
        h = eng.metrics.get(name)
        return h.percentile(p) if h is not None and h.count else 0.0

    # Histogram percentiles from the always-on registry (log-bucket upper
    # bounds, within ~9% above the sample).
    print("metrics: ttft "
          + " ".join(f"p{p} {_hp('serve_ttft_s', p) * 1e3:.1f}ms"
                     for p in (50, 95, 99))
          + " | itl "
          + " ".join(f"p{p} {_hp('serve_itl_s', p) * 1e3:.2f}ms"
                     for p in (50, 95, 99)))
    graphs = eng.graphs
    print(f"graphs={'on' if graphs.capture else 'off'}: "
          f"{len(graphs.counts)} step callables "
          + (f"captured in {sum(graphs.capture_s.values()):.2f}s "
             if graphs.capture else "")
          + " ".join(sorted(graphs.counts)))
    st = eng.stats()
    hw = eng.hw_telemetry()
    if hw is not None:  # the twin: projected crossbar energy, utilization
        per_tok = [f.pj_per_token for f in done]
        p50 = f"{percentile(per_tok, 50):.0f}" if per_tok else "n/a"
        print(f"hw twin: {hw['total_pj'] / 1e6:.2f} uJ total "
              f"({hw['idle_pj'] / 1e6:.2f} uJ idle), slot utilization "
              f"{hw['slot_utilization']:.1%}, pJ/token p50 {p50}")
        if args.paged:
            print(f"prefix credit: {hw['prefix_saved_pj'] / 1e6:.2f} uJ "
                  f"saved over {int(hw['prefix_hits'])} hits "
                  f"({int(hw['prefix_tokens_saved'])} prefill positions)")
        if args.spec and hw.get("spec_accepted_tokens"):
            print(f"spec energy: {hw['spec_pj_per_accepted_token']:.0f} "
                  f"pJ/accepted-token "
                  f"({hw['spec_rejected_pj'] / 1e6:.2f} uJ on rejected "
                  f"positions)")
    if wear_monitor is not None:
        s = wear_monitor.summary()
        print(f"wear admission: weight {args.wear_weight:g}, endurance "
              f"frac {s['endurance_frac']:.3g} "
              f"({int(s['writes_per_tile'])} writes/tile pre-aged)")
        if args.metrics_out:
            wear_monitor.export_gauges(eng.metrics)
    health_doc = None
    if hm is not None:
        from repro_torch.obs.health import export_slo_gauges

        rep = hm.report(slos=slos, metrics=eng.metrics)
        export_slo_gauges(eng.metrics, rep.slos)  # before write_metrics
        health_doc = rep.to_dict()
        print(f"health: {len(rep.alerts)} alerts over "
              f"{len(rep.series)} series "
              f"({', '.join(sorted(rep.series))})")
        for a in rep.alerts:
            print(f"  ALERT {a.series} {a.direction} at sample {a.sample}: "
                  f"value {a.value:.4g} vs baseline {a.baseline:.4g} "
                  f"(z={a.z:.1f}, {a.kind} score {a.score:.1f})")
        for slo in rep.slos:
            print(f"  SLO {slo.name}: {slo.objective}({slo.metric}) "
                  f"{slo.observed:.4g} vs target {slo.target:g} — "
                  f"burn rate {slo.burn_rate:.2f}, "
                  f"budget {slo.budget_remaining:+.2f}, "
                  f"{'OK' if slo.ok else 'VIOLATED'}")
        if args.expect_alert and not rep.alerts:
            print("expected a health alert; none fired", file=sys.stderr)
            return 1
    if args.metrics_out:
        write_metrics(args.metrics_out, eng.metrics)
        print(f"metrics written to {args.metrics_out}")
    if args.trace_out:
        meta = {"hw": hw, "engine": "fused", "arch": args.arch}
        if health_doc is not None:
            meta["health"] = health_doc
        payload = write_chrome_trace(args.trace_out, tracer, metadata=meta)
        problems = validate_trace(payload)
        if health_doc is not None:
            problems += validate_health(payload)
        print(f"trace written to {args.trace_out} "
              f"({payload['metadata']['events']} events, "
              f"{payload['metadata']['dropped']} dropped)")
        for p in problems:
            print(f"trace INVALID: {p}", file=sys.stderr)
        if problems:
            return 1
    if args.chunk_tokens:
        print(f"chunked: {eng.chunk_waves} chunk waves "
              f"(chunk_tokens={args.chunk_tokens}, sched={args.sched}), "
              f"{eng.decode_stall_steps} stalled steps")
    if args.spec:
        print(f"spec: k={args.spec_k} accept rate "
              f"{st['spec_accept_rate']:.1%} ({int(st['spec_accepted'])}/"
              f"{int(st['spec_proposed'])} drafts), "
              f"{st['spec_tokens_per_step']:.2f} emitted tokens/step")
        if st["spec_proposed"] <= 0:
            return 1
    if args.paged:
        conserved = eng.pool.conserved()
        print(f"paged: hit rate {st['radix_hit_rate']:.1%} "
              f"({int(st['radix_hits'])} hits), pool "
              f"{int(st['pool_pages_in_use'])} used + "
              f"{int(st['pool_pages_free'])} free / "
              f"{int(st['pool_pages_total'])} pages, "
              f"{int(st['radix_nodes'])} radix nodes, "
              f"{int(st['radix_evictions'])} evictions, "
              f"conserved={conserved}")
        if not conserved:
            return 1
        if args.prefix_len and not st["radix_hit_rate"] > 0:
            return 1
    return 0 if len(done) == args.requests else 1


if __name__ == "__main__":
    sys.exit(main())
