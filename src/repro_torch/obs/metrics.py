"""Labeled counters / gauges / log-bucketed histograms (port of
``repro.obs.metrics``, DESIGN.md §11).

The registry replaces the ad-hoc per-engine dicts and latency lists:
every serving/training scalar lands here once, and the exporters
(`obs.export.prometheus_text`, the launchers' reports) read one place.

Histograms are log-bucketed: bucket ``i`` holds values in
``(growth**(i-1), growth**i]`` (plus a dedicated bucket for values
``<= 0``), so memory is O(log(range)) regardless of sample count and
`percentile()` is exact to one bucket's relative width — with the
default ``growth = 2**(1/8)`` that is ≤ ~9.05% relative error, tight
enough for latency reporting. `percentile()` uses the same nearest-rank
rule as `serve.request.percentile` and returns the rank sample's bucket
UPPER bound, so for any sample ``v`` the estimate ``e`` satisfies
``v <= e < v * growth`` (the sorted-list-oracle property tests pin
exactly this envelope). The boundaries are special-cased so the
returned range brackets the data: ``percentile(0)`` is the lowest
nonempty bucket's LOWER bound (an under-estimate of the min) and
``percentile(100)`` the highest bucket's upper bound (an over-estimate
of the max) — ``[p0, p100]`` always contains every sample.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic float counter."""

    __slots__ = ("name", "labels", "value")
    kind = "counter"

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        assert v >= 0, "counters only go up; use a Gauge"
        self.value += v


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "labels", "value")
    kind = "gauge"

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Histogram:
    """Log-bucketed histogram (see module docstring for the bucket law
    and the percentile error envelope)."""

    __slots__ = ("name", "labels", "growth", "_log_g", "buckets",
                 "nonpos_count", "count", "sum", "min", "max")
    kind = "histogram"

    DEFAULT_GROWTH = 2.0 ** 0.125

    def __init__(self, name: str, labels: LabelKey = (),
                 growth: float = DEFAULT_GROWTH):
        assert growth > 1.0
        self.name = name
        self.labels = labels
        self.growth = growth
        self._log_g = math.log(growth)
        self.buckets: Dict[int, int] = {}   # index -> count
        self.nonpos_count = 0               # values <= 0 (their own bucket)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _index(self, v: float) -> int:
        """Smallest i with growth**i >= v (v > 0). The float log is only a
        seed; the fixup loop makes the boundary exact so the upper-bound
        contract never breaks on values sitting on a bucket edge."""
        i = math.ceil(math.log(v) / self._log_g)
        while self.growth ** i < v:
            i += 1
        while i > -1074 and self.growth ** (i - 1) >= v:
            i -= 1
        return i

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self.nonpos_count += 1
            return
        i = self._index(v)
        self.buckets[i] = self.buckets.get(i, 0) + 1

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile, returned as the rank sample's bucket
        upper bound (0.0 for the non-positive bucket; 0.0 on empty).

        Boundaries are bracketing, not rank-based: ``p <= 0`` returns the
        lowest nonempty bucket's LOWER bound (``<= min``) and ``p >= 100``
        the highest bucket's upper bound (``>= max``), so ``[p0, p100]``
        always contains every sample."""
        if self.count == 0:
            return 0.0
        if p <= 0:
            if self.nonpos_count or not self.buckets:
                return 0.0
            return self.growth ** (min(self.buckets) - 1)
        if p >= 100:
            if not self.buckets:
                return 0.0
            return self.growth ** max(self.buckets)
        rank = min(self.count - 1, int(round(p / 100 * (self.count - 1))))
        if rank < self.nonpos_count:
            return 0.0
        seen = self.nonpos_count
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if rank < seen:
                return self.growth ** i
        return self.growth ** max(self.buckets)  # unreachable; safety

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def bounds(self) -> List[Tuple[float, int]]:
        """(upper_bound, count) per occupied bucket, ascending — the
        exposition shape (`obs.export.prometheus_text` emits cumulative
        ``le`` buckets from this)."""
        out = [(0.0, self.nonpos_count)] if self.nonpos_count else []
        out.extend((self.growth ** i, self.buckets[i])
                   for i in sorted(self.buckets))
        return out


class MetricsRegistry:
    """One namespace of metrics, keyed by (name, labels). Re-requesting
    an existing (name, labels) returns the same object (so call sites can
    pre-bind in __init__ and hot paths pay a method call, not a lookup);
    a kind clash raises."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, LabelKey], object] = {}

    def _get(self, cls, name: str, labels: Dict[str, str], **kw):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, key[1], **kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, growth: Optional[float] = None,
                  **labels) -> Histogram:
        kw = {"growth": growth} if growth else {}
        return self._get(Histogram, name, labels, **kw)

    def get(self, name: str, **labels):
        """Existing metric or None (exporters/launchers probe without
        creating)."""
        return self._metrics.get((name, _label_key(labels)))

    def collect(self) -> Iterable[object]:
        """All metrics, sorted by (name, labels) for stable exposition."""
        return [self._metrics[k] for k in sorted(self._metrics)]

    def to_dict(self) -> Dict[str, float]:
        """Flat scalar snapshot: counters/gauges by name, histograms as
        ``<name>_{count,sum,p50,p95,p99}``. Labels render as
        ``name{k=v,...}``."""
        out: Dict[str, float] = {}
        for m in self.collect():
            base = m.name
            if m.labels:
                lbl = ",".join(f"{k}={v}" for k, v in m.labels)
                base = f"{base}{{{lbl}}}"
            if m.kind == "histogram":
                out[f"{base}_count"] = float(m.count)
                out[f"{base}_sum"] = m.sum
                for p in (50, 95, 99):
                    out[f"{base}_p{p}"] = m.percentile(p)
            else:
                out[base] = m.value
        return out
