"""Exporters for the obs layer (port of ``repro.obs.export``, DESIGN.md
§11): Chrome/Perfetto trace JSON, JSONL event sink, Prometheus text
exposition — and the trace and health validators a smoke run checks the
emitted files with.

The Perfetto payload is the standard trace-event JSON object form
(https://ui.perfetto.dev loads it directly): ``traceEvents`` holds "X"
complete spans / "i" instants / "C" counter samples with microsecond
timestamps rebased to the first event, plus process/thread metadata.
A repo-specific top-level ``metadata`` object carries the producing
engine's hw-twin telemetry snapshot, which is what makes the file
self-validating: `validate_trace` re-folds the per-span attributed-pJ
annotations in event order and requires the decode and prefill folds to
equal the booked accumulators EXACTLY (float-exact — JSON round-trips
Python floats losslessly and fold order equals booking order).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer

# Span names any fused-engine serve drain must have produced (the CI
# trace-smoke contract). "prefill" matches by prefix: bucket waves are
# ``prefill.wave[<b>]``, chunk waves ``prefill.chunk_wave``; the decode
# phase matches ``decode_and_sample`` and the speculative engine's
# ``decode_and_verify`` (DESIGN.md §12) alike.
REQUIRED_SERVE_PHASES = ("engine.step", "sched.pick", "prefill",
                         "decode_and_", "host_transfer")


# ---------------------------------------------------------------------------
# Chrome / Perfetto trace JSON.
# ---------------------------------------------------------------------------


def chrome_payload(tracer: Tracer, pid: int = 1,
                   metadata: Optional[Dict] = None) -> Dict:
    """Serialize the tracer's ring to the Perfetto-loadable object form."""
    events = list(tracer.events)
    base = min((e.t0 for e in events), default=0.0)
    out: List[Dict] = [
        {"ph": "M", "name": "process_name", "pid": pid,
         "args": {"name": "timefloats"}},
    ]
    for tid, tname in sorted(getattr(tracer, "thread_names", {}).items()):
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": tname}})
    for e in events:
        ev = {"ph": e.phase, "name": e.name, "pid": pid, "tid": e.tid,
              "ts": (e.t0 - base) * 1e6}
        if e.cat:
            ev["cat"] = e.cat
        if e.phase == "X":
            ev["dur"] = max(e.t1 - e.t0, 0.0) * 1e6
        if e.phase == "i":
            ev["s"] = "t"  # thread-scoped instant
        if e.args:
            ev["args"] = dict(e.args)
        out.append(ev)
    meta = {"dropped": tracer.dropped, "events": len(events)}
    if metadata:
        meta.update(metadata)
    return {"traceEvents": out, "displayTimeUnit": "ms", "metadata": meta}


def write_chrome_trace(path: str, tracer: Tracer,
                       metadata: Optional[Dict] = None) -> Dict:
    payload = chrome_payload(tracer, metadata=metadata)
    with open(path, "w") as f:
        json.dump(payload, f)
    return payload


def write_jsonl(path: str, tracer: Tracer) -> int:
    """One JSON object per event, ring order — the streaming-friendly
    sink (tail -f / jq)."""
    n = 0
    with open(path, "w") as f:
        for e in tracer.events:
            f.write(json.dumps({
                "name": e.name, "cat": e.cat, "ph": e.phase, "tid": e.tid,
                "t0": e.t0, "t1": e.t1, "args": dict(e.args)}) + "\n")
            n += 1
    return n


# ---------------------------------------------------------------------------
# Trace validation (the CI smoke contract).
# ---------------------------------------------------------------------------


def _fold_pj(events: List[Dict], match, arg: str = "attributed_pj"
             ) -> float:
    """Left-fold of span ``arg`` args in event order — the same
    float-addition sequence the ServeEnergyModel accumulators performed,
    so exact equality is the contract, not approximation."""
    total = 0.0
    for ev in events:
        if ev.get("ph") == "X" and match(ev.get("name", "")):
            pj = ev.get("args", {}).get(arg)
            if pj is not None:
                total += pj
    return total


def validate_trace(payload: Dict,
                   require_phases=REQUIRED_SERVE_PHASES) -> List[str]:
    """Structural + energy-attribution checks on a Chrome trace payload;
    returns a list of problems (empty = valid).

    - every required phase name occurs (prefix match);
    - the ring did not overflow (``metadata.dropped == 0`` — a truncated
      timeline cannot certify energy sums);
    - when the producer embedded hw telemetry: the event-order fold of
      ``attributed_pj`` over decode spans equals ``decode_attributed_pj``
      and over prefill spans equals ``prefill_attributed_pj``, exactly.
    """
    problems: List[str] = []
    events = payload.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    names = {ev.get("name", "") for ev in events}
    for phase in require_phases:
        if not any(n == phase or n.startswith(phase) for n in names):
            problems.append(f"required phase {phase!r} absent from trace")
    meta = payload.get("metadata", {})
    dropped = meta.get("dropped", 0)
    if dropped:
        problems.append(f"ring buffer dropped {dropped} events — raise "
                        "tracer capacity to certify energy sums")
        return problems
    hw = meta.get("hw") or {}
    decode_match = lambda n: n.startswith("decode")  # noqa: E731
    prefill_match = lambda n: n.startswith("prefill")  # noqa: E731
    for key, match, arg in (
            ("decode_attributed_pj", decode_match, "attributed_pj"),
            ("prefill_attributed_pj", prefill_match, "attributed_pj"),
            # Speculative engines (DESIGN.md §12) additionally annotate
            # every verify span with the accepted/rejected pJ split; the
            # folds must reproduce the twin's spec accumulators exactly
            # (both are 0.0 for non-spec traces).
            ("spec_accepted_pj", decode_match, "accepted_pj"),
            ("spec_rejected_pj", decode_match, "rejected_pj")):
        if key not in hw:
            continue
        got = _fold_pj(events, match, arg)
        want = hw[key]
        if got != want:
            problems.append(
                f"span pJ fold mismatch for {key}: spans sum to {got!r}, "
                f"telemetry booked {want!r}")
    return problems


def validate_health(payload: Dict,
                    metrics: Optional[Dict] = None) -> List[str]:
    """Health-artifact checks (DESIGN.md §13); returns problems
    (empty = valid). Composable with `validate_trace` — the CI health
    smoke runs both on the same payload.

    - every ``health.alert`` instant event references a series that the
      embedded ``metadata.health.series`` map actually tracked;
    - every alert in the report names a tracked series too;
    - with the flat metrics dict (``--metrics *.json``): for each
      exported ``slo_burn_rate{slo=...}`` gauge, its companions
      ``slo_bad_fraction``/``slo_allowed_fraction`` exist under the same
      label and the budget math re-derives EXACTLY:
      ``burn == bad / allowed``.
    """
    problems: List[str] = []
    health = (payload.get("metadata") or {}).get("health")
    if not isinstance(health, dict):
        return ["metadata.health missing — not a health artifact"]
    series = set((health.get("series") or {}).keys())
    for ev in payload.get("traceEvents", []):
        if ev.get("ph") == "i" and ev.get("name") == "health.alert":
            s = ev.get("args", {}).get("series")
            if s not in series:
                problems.append(
                    f"health.alert instant references unknown series {s!r}")
    for a in health.get("alerts", []):
        if a.get("series") not in series:
            problems.append(
                f"report alert references unknown series "
                f"{a.get('series')!r}")
    if metrics is not None:
        prefix = "slo_burn_rate{"
        for key, burn in metrics.items():
            if not key.startswith(prefix):
                continue
            label = key[len("slo_burn_rate"):]
            bad = metrics.get(f"slo_bad_fraction{label}")
            allowed = metrics.get(f"slo_allowed_fraction{label}")
            if bad is None or allowed is None:
                problems.append(
                    f"slo gauges incomplete for {label}: need "
                    "slo_bad_fraction + slo_allowed_fraction")
                continue
            rederived = bad / allowed if allowed > 0 else 0.0
            if rederived != burn:
                problems.append(
                    f"slo budget math not re-derivable for {label}: "
                    f"bad/allowed = {rederived!r}, exported burn_rate = "
                    f"{burn!r}")
    return problems


# ---------------------------------------------------------------------------
# Prometheus text exposition.
# ---------------------------------------------------------------------------


def _fmt_labels(labels, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(registry: MetricsRegistry) -> str:
    """Prometheus/OpenMetrics text format. Histograms expose cumulative
    ``le`` buckets at the log-bucket upper bounds plus ``+Inf``."""
    lines: List[str] = []
    seen_type = set()
    for m in registry.collect():
        if m.name not in seen_type:
            seen_type.add(m.name)
            lines.append(f"# TYPE {m.name} {m.kind}")
        if m.kind == "histogram":
            cum = 0
            for ub, cnt in m.bounds():
                cum += cnt
                le = 'le="' + repr(ub) + '"'
                lines.append(f"{m.name}_bucket{_fmt_labels(m.labels, le)}"
                             f" {cum}")
            inf_le = 'le="+Inf"'
            lines.append(f"{m.name}_bucket{_fmt_labels(m.labels, inf_le)}"
                         f" {m.count}")
            lines.append(f"{m.name}_sum{_fmt_labels(m.labels)} {m.sum!r}")
            lines.append(f"{m.name}_count{_fmt_labels(m.labels)} {m.count}")
        else:
            lines.append(f"{m.name}{_fmt_labels(m.labels)} {m.value!r}")
    return "\n".join(lines) + "\n"


def write_metrics(path: str, registry: MetricsRegistry) -> None:
    """Write the registry snapshot: ``.json`` gets the flat scalar dict,
    anything else the Prometheus text exposition."""
    if path.endswith(".json"):
        with open(path, "w") as f:
            json.dump(registry.to_dict(), f, indent=1, sort_keys=True)
    else:
        with open(path, "w") as f:
            f.write(prometheus_text(registry))
