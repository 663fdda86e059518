"""Offline summarizer/validator for obs trace + metrics files (port of
``repro.launch.obs_report``, DESIGN.md §11).

    PYTHONPATH=src python -m repro_torch.launch.obs_report trace.json \
        --metrics metrics.json --validate

Reads a Chrome/Perfetto trace written by the serve/train launchers'
``--trace-out`` and prints the per-span-name aggregates (count, total
wall ms, total attributed pJ), the recompile spans, and the metrics
snapshot. ``--validate`` re-runs `obs.export.validate_trace` — the same
structural + exact-energy-fold checks the emitting launcher ran — and
exits nonzero on any problem, which is how a smoke run checks the
artifact it produced (not just the run's exit code). A training trace
(``train.step`` spans and no ``engine.step``) is held to its own phase.
"""
import argparse
import json
import sys
from collections import defaultdict


def summarize(payload: dict, top: int = 15) -> list:
    """Per-name aggregate rows [(name, count, total_ms, total_pj)],
    descending total wall time, truncated to ``top``."""
    agg = defaultdict(lambda: [0, 0.0, 0.0])
    for ev in payload.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        row = agg[ev.get("name", "?")]
        row[0] += 1
        row[1] += ev.get("dur", 0.0) / 1e3          # µs -> ms
        pj = ev.get("args", {}).get("attributed_pj")
        if pj is not None:
            row[2] += pj
    rows = sorted(((n, c, ms, pj) for n, (c, ms, pj) in agg.items()),
                  key=lambda r: -r[2])
    return rows[:top]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="Chrome trace JSON from --trace-out")
    ap.add_argument("--metrics", default=None,
                    help="metrics snapshot from --metrics-out")
    ap.add_argument("--validate", action="store_true",
                    help="run the structural + energy-fold checks; "
                         "exit 1 on any problem")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    with open(args.trace) as f:
        payload = json.load(f)
    meta = payload.get("metadata", {})
    print(f"{args.trace}: {meta.get('events', '?')} events, "
          f"{meta.get('dropped', '?')} dropped")

    print(f"{'span':<28} {'count':>6} {'total ms':>10} {'total pJ':>14}")
    for name, count, ms, pj in summarize(payload, args.top):
        pj_s = f"{pj:.1f}" if pj else "-"
        print(f"{name:<28} {count:>6} {ms:>10.2f} {pj_s:>14}")

    compiles = [ev for ev in payload.get("traceEvents", [])
                if ev.get("ph") == "X"
                and ev.get("name", "").startswith("compile[")]
    if compiles:
        total = sum(ev.get("dur", 0.0) for ev in compiles) / 1e3
        print(f"recompiles: {len(compiles)} spans, {total:.1f} ms total")
        for ev in compiles:
            print(f"  {ev['name']:<30} {ev.get('dur', 0.0) / 1e3:>8.1f} ms")

    hw = meta.get("hw") or {}
    if hw:
        print("hw twin snapshot: " + ", ".join(
            f"{k}={v:.6g}" for k, v in sorted(hw.items())
            if isinstance(v, (int, float))))

    health = meta.get("health")
    if isinstance(health, dict):
        alerts = health.get("alerts", [])
        print(f"health: {len(alerts)} alerts over "
              f"{len(health.get('series', {}))} series")
        for a in alerts:
            print(f"  ALERT {a.get('series')} {a.get('direction')} at "
                  f"sample {a.get('sample')}: value {a.get('value'):.4g} "
                  f"vs baseline {a.get('baseline'):.4g}")
        for st in health.get("slos", []):
            print(f"  SLO {st.get('name')}: burn rate "
                  f"{st.get('burn_rate'):.2f}, "
                  f"{'OK' if st.get('ok') else 'VIOLATED'}")

    if args.metrics:
        print(f"-- metrics ({args.metrics}) --")
        if args.metrics.endswith(".json"):
            with open(args.metrics) as f:
                for k, v in sorted(json.load(f).items()):
                    print(f"  {k} = {v}")
        else:
            with open(args.metrics) as f:
                sys.stdout.write(f.read())

    if args.validate:
        from repro_torch.obs.export import validate_health, validate_trace

        names = {ev.get("name", "")
                 for ev in payload.get("traceEvents", [])}
        train = any(n.startswith("train.step") for n in names)
        if train and not any(n.startswith("engine.step") for n in names):
            require = ("train.step",)
        else:
            require = None
        problems = (validate_trace(payload, require) if require
                    else validate_trace(payload))
        if isinstance(health, dict):
            # Health artifact (§13): alerts must reference tracked series;
            # with a flat .json metrics snapshot the SLO budget math must
            # re-derive exactly from the exported gauges.
            mdict = None
            if args.metrics and args.metrics.endswith(".json"):
                with open(args.metrics) as f:
                    mdict = json.load(f)
            problems += validate_health(payload, metrics=mdict)
        for p in problems:
            print(f"INVALID: {p}", file=sys.stderr)
        if problems:
            return 1
        checked = " + health/slo re-derivation" if isinstance(health, dict) \
            else ""
        print(f"trace valid: structure + energy folds{checked} check out")
    return 0


if __name__ == "__main__":
    sys.exit(main())
