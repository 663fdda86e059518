"""Dependency-free observability layer (port of ``repro.obs``, DESIGN.md
§11), threaded through the port's serving engine, its step graphs, the
trainer and the hw twin:

- `obs.trace`   — low-overhead span tracer (bounded ring buffer,
  injectable clock, nested spans, a no-op singleton when disabled) with
  Chrome/Perfetto trace-event export. Spans carry the twin's attributed
  crossbar pJ, so the exported timeline is simultaneously a wall-clock
  flame view and an energy flame view. Spans are host wall-clock: on the
  card a span around a step times its launch, and the device work shows
  up in the step's ``host_transfer`` span.
- `obs.metrics` — labeled counters / gauges / log-bucketed histograms
  behind the engine's and trainer's telemetry.
- `obs.export`  — Perfetto JSON writer, JSONL event sink, Prometheus
  text exposition, and trace validation.
- `obs.health`  — streaming drift detectors and declarative SLOs
  (DESIGN.md §13).
"""
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NOOP, NoopTracer, Span, Tracer

__all__ = ["Tracer", "NoopTracer", "NOOP", "Span", "MetricsRegistry"]
