"""Streaming health monitors + declarative SLOs (port of
``repro.obs.health``, DESIGN.md §13).

Three layers, all host-side and allocation-light so the serving hot path
pays little with health on (the reference's benchmark gates it at
≤ 1.05× wall; the port's benchmark has no such gate yet):

1. **Series + detectors** — every observed series keeps a bounded ring
   of recent samples, an EWMA baseline with an exponentially-weighted
   variance, and a one-sided CUSUM change-point detector over the
   *capped* z-score of each new sample against the baseline-so-far (the
   z is computed BEFORE the baseline absorbs the sample, and post-warmup
   absorption is winsorized to ``mean ± zcap·sigma``, so level steps
   stay visible instead of being adopted by the EWMA; the cap means a
   single outlier — a compile stall, a GC pause — can never fire alone:
   with the defaults it takes >= 3 consecutive anomalous samples to
   cross the threshold). Detection is
   directional: latency/queue/occupancy series alert on upward drift
   only (a queue draining to zero is healthy, not an anomaly); rate
   series like the speculative accept rate register ``direction="down"``.

2. **Alerts** — a firing detector appends a structured `Alert` and, when
   a tracer is attached, emits a ``health.alert`` instant event on the
   dedicated health thread track, so drift shows up in the §11 Perfetto
   timeline next to the span it degraded. `obs.export.validate_health`
   checks every traced alert references a series the report actually
   tracked.

3. **SLOs** — `SloSpec` declares an objective over any registered
   metric (histogram percentile, or a gauge/counter value) with a
   target; `evaluate()` returns burn-rate accounting in which
   ``burn_rate == bad_fraction / allowed_fraction`` holds EXACTLY — the
   relation `validate_health` re-derives from the exported
   ``slo_*{slo=...}`` gauges in the metrics file.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Alert:
    """One detector firing on one series."""

    series: str
    kind: str          # "cusum" | "zscore"
    value: float       # the sample that fired
    baseline: float    # EWMA mean at fire time
    z: float           # capped z-score of the firing sample
    score: float       # the detector statistic that crossed its threshold
    direction: str     # "up" | "down"
    sample: int        # per-series sample index at fire time

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class EwmaBaseline:
    """EWMA mean + exponentially-weighted variance (West's update).

    The first sample seeds the mean with zero variance; `sigma()` floors
    at a small fraction of |mean| (and an absolute epsilon) so a series
    that has been perfectly flat doesn't turn numerical dust into an
    infinite z-score."""

    __slots__ = ("alpha", "mean", "var", "n")

    def __init__(self, alpha: float = 0.25):
        assert 0.0 < alpha <= 1.0
        self.alpha = alpha
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def update(self, v: float) -> None:
        self.n += 1
        if self.n == 1:
            self.mean = v
            self.var = 0.0
            return
        d = v - self.mean
        self.mean += self.alpha * d
        self.var = (1.0 - self.alpha) * (self.var + self.alpha * d * d)

    def sigma(self, rel_floor: float = 0.05,
              abs_floor: float = 1e-12) -> float:
        return max(math.sqrt(self.var), rel_floor * abs(self.mean),
                   abs_floor)


class CusumDetector:
    """One-sided (directional) CUSUM over capped z-scores.

    ``s = max(0, s + (±z - k))`` accumulates only the anomalous part of
    each sample (drift below ``k`` sigmas decays the statistic); fires
    when ``s > h`` and resets. With the defaults (k=0.5, h=9, zcap=4) a
    single spike contributes at most ``zcap - k = 3.5``, so >= 3
    consecutive anomalous samples are needed — jitter-robust by
    construction."""

    __slots__ = ("k", "h", "zcap", "direction", "s_hi", "s_lo")

    def __init__(self, k: float = 0.5, h: float = 9.0, zcap: float = 4.0,
                 direction: str = "up"):
        assert direction in ("up", "down", "both")
        self.k = k
        self.h = h
        self.zcap = zcap
        self.direction = direction
        self.s_hi = 0.0
        self.s_lo = 0.0

    def update(self, z: float) -> Optional[Tuple[str, float]]:
        """Feed one z-score; returns ``(direction, score)`` on fire."""
        zc = max(-self.zcap, min(self.zcap, z))
        self.s_hi = max(0.0, self.s_hi + zc - self.k)
        self.s_lo = max(0.0, self.s_lo - zc - self.k)
        if self.direction in ("up", "both") and self.s_hi > self.h:
            score, self.s_hi, self.s_lo = self.s_hi, 0.0, 0.0
            return ("up", score)
        if self.direction in ("down", "both") and self.s_lo > self.h:
            score, self.s_hi, self.s_lo = self.s_lo, 0.0, 0.0
            return ("down", score)
        return None


class ZScoreDetector:
    """Single-sample threshold detector (|z| beyond ``threshold`` in the
    watched direction). Deliberately blunter than CUSUM — provided for
    series where one extreme sample IS the event (e.g. a pool-occupancy
    spike); the default `HealthMonitor` wiring fires via CUSUM only."""

    __slots__ = ("threshold", "direction")

    def __init__(self, threshold: float = 6.0, direction: str = "up"):
        assert direction in ("up", "down", "both")
        self.threshold = threshold
        self.direction = direction

    def update(self, z: float) -> Optional[Tuple[str, float]]:
        if self.direction in ("up", "both") and z > self.threshold:
            return ("up", z)
        if self.direction in ("down", "both") and -z > self.threshold:
            return ("down", -z)
        return None


class SeriesHealth:
    """Ring + baseline + detector bundle for one series."""

    __slots__ = ("name", "ring", "baseline", "cusum", "warmup", "n",
                 "alert_count")

    def __init__(self, name: str, *, capacity: int = 512, warmup: int = 12,
                 alpha: float = 0.25, cusum_k: float = 0.5,
                 cusum_h: float = 9.0, zcap: float = 4.0,
                 direction: str = "up"):
        self.name = name
        self.ring: deque = deque(maxlen=capacity)
        self.baseline = EwmaBaseline(alpha)
        self.cusum = CusumDetector(cusum_k, cusum_h, zcap, direction)
        self.warmup = warmup
        self.n = 0
        self.alert_count = 0

    def observe(self, v: float) -> Optional[Alert]:
        """Feed one sample; returns an `Alert` if a detector fired. The
        z-score is computed against the baseline BEFORE it absorbs the
        sample, and post-warmup the absorption is winsorized — the sample
        is clipped to ``mean ± zcap·sigma`` before the EWMA update — so a
        level step cannot pull the baseline onto itself faster than the
        CUSUM accumulates its evidence (an unclipped EWMA with alpha=0.25
        adapts to a shift in ~4 samples and the statistic never crosses
        ``h``). The first ``warmup`` samples train the baseline unclipped
        and never alert; when warmup completes the baseline is re-seeded
        from a median/MAD fit of the ring (see `_reseed_robust`) so a
        cold-start compile spike can't poison the variance either."""
        v = float(v)
        self.n += 1
        self.ring.append(v)
        alert = None
        if self.n > self.warmup:
            sig = self.baseline.sigma()
            z = (v - self.baseline.mean) / sig
            fired = self.cusum.update(z)
            if fired is not None:
                direction, score = fired
                self.alert_count += 1
                alert = Alert(series=self.name, kind="cusum", value=v,
                              baseline=self.baseline.mean, z=z, score=score,
                              direction=direction, sample=self.n)
            span = self.cusum.zcap * sig
            self.baseline.update(
                min(max(v, self.baseline.mean - span),
                    self.baseline.mean + span))
        else:
            self.baseline.update(v)
            if self.n == self.warmup:
                self._reseed_robust()
        return alert

    def _reseed_robust(self) -> None:
        """Warmup complete: replace the EWMA state with a median/MAD fit
        of the warmup ring. A single cold-start outlier (the first-step
        compile stall is ~70x a steady sample) would otherwise inflate
        the EW variance for dozens of samples, and a genuine level step
        arriving in that window scores z ~ 6 instead of z >> zcap — low
        enough for the winsorized baseline to adopt it without ever
        firing. The median/MAD seed is outlier-immune by construction
        (1.4826 scales MAD to sigma for normal noise)."""
        xs = sorted(self.ring)
        m = len(xs)
        med = xs[m // 2] if m % 2 else 0.5 * (xs[m // 2 - 1] + xs[m // 2])
        dev = sorted(abs(x - med) for x in xs)
        mad = dev[m // 2] if m % 2 else 0.5 * (dev[m // 2 - 1] + dev[m // 2])
        self.baseline.mean = med
        self.baseline.var = (1.4826 * mad) ** 2

    def summary(self) -> Dict[str, float]:
        return {
            "count": float(self.n),
            "last": self.ring[-1] if self.ring else 0.0,
            "mean": self.baseline.mean,
            "sigma": self.baseline.sigma(),
            "alerts": float(self.alert_count),
        }


# ---------------------------------------------------------------------------
# Declarative SLOs with exact burn-rate accounting.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One service-level objective over a registered metric.

    ``objective``:
      - ``"pQ"`` (e.g. "p95", 0 < Q < 100) on a histogram — at most
        ``1 - Q/100`` of samples may exceed ``target``. The bad fraction
        is derived from the bucket counts deterministically and
        conservatively: a bucket is bad iff its upper bound exceeds the
        target (a sample whose bucket straddles the target counts bad).
      - ``"mean"`` / ``"value"`` / ``"max"`` — observed statistic divided
        by ``target`` IS the burn rate (allowed fraction 1.0).

    Either way ``burn_rate == bad_fraction / allowed_fraction`` holds
    exactly, which is the relation `obs.export.validate_health`
    re-derives from the exported gauges. ``window`` is the series length
    the objective is judged over (0 = lifetime; informational — the
    registry's histograms are cumulative)."""

    name: str
    metric: str
    objective: str
    target: float
    window: int = 0

    def evaluate(self, registry) -> "SloStatus":
        m = registry.get(self.metric) if registry is not None else None
        if m is None or (hasattr(m, "count") and m.count == 0):
            # Unregistered or empty metric: no traffic, budget untouched.
            return SloStatus(self.name, self.metric, self.objective,
                             self.target, observed=0.0, bad_fraction=0.0,
                             allowed_fraction=self._allowed(), burn_rate=0.0,
                             budget_remaining=1.0, ok=True)
        if self.objective.startswith("p"):
            q = float(self.objective[1:])
            assert 0.0 < q < 100.0, self.objective
            observed = m.percentile(q)
            good = m.nonpos_count if self.target >= 0 else 0
            for i, n in m.buckets.items():
                if m.growth ** i <= self.target:
                    good += n
            bad_fraction = (m.count - good) / m.count
        else:
            if self.objective == "mean":
                observed = m.mean
            elif self.objective == "max":
                observed = m.max if m.count else 0.0
            elif self.objective == "value":
                observed = m.value
            else:
                raise ValueError(f"unknown objective {self.objective!r}")
            bad_fraction = observed / self.target if self.target else 0.0
        allowed = self._allowed()
        burn = bad_fraction / allowed if allowed > 0 else 0.0
        return SloStatus(self.name, self.metric, self.objective, self.target,
                         observed=float(observed),
                         bad_fraction=float(bad_fraction),
                         allowed_fraction=float(allowed),
                         burn_rate=float(burn),
                         budget_remaining=float(1.0 - burn),
                         ok=bool(burn <= 1.0))

    def _allowed(self) -> float:
        if self.objective.startswith("p") and self.objective not in (
                "p0", "p100"):
            try:
                return 1.0 - float(self.objective[1:]) / 100.0
            except ValueError:
                pass
        return 1.0


@dataclasses.dataclass(frozen=True)
class SloStatus:
    """Evaluated SLO: error-budget burn accounting at a point in time."""

    name: str
    metric: str
    objective: str
    target: float
    observed: float
    bad_fraction: float
    allowed_fraction: float
    burn_rate: float
    budget_remaining: float
    ok: bool

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def export_slo_gauges(registry, statuses: Sequence[SloStatus]) -> None:
    """Persist burn accounting as labeled gauges so the budget math is
    re-derivable from the metrics file alone (`validate_health` checks
    ``burn == bad / allowed`` for every exported slo label)."""
    for st in statuses:
        lbl = {"slo": st.name}
        registry.gauge("slo_burn_rate", **lbl).set(st.burn_rate)
        registry.gauge("slo_bad_fraction", **lbl).set(st.bad_fraction)
        registry.gauge("slo_allowed_fraction", **lbl).set(st.allowed_fraction)
        registry.gauge("slo_target", **lbl).set(st.target)
        registry.gauge("slo_ok", **lbl).set(1.0 if st.ok else 0.0)


def default_serve_slos(ttft_p95: float = 5.0,
                       itl_p95: float = 1.0) -> List[SloSpec]:
    """The two latency objectives every serve drain can judge: p95 TTFT
    and p95 ITL against the engine's registered histograms."""
    return [
        SloSpec("ttft_p95", "serve_ttft_s", "p95", ttft_p95),
        SloSpec("itl_p95", "serve_itl_s", "p95", itl_p95),
    ]


# ---------------------------------------------------------------------------
# The monitor.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HealthReport:
    """Structured snapshot: per-series summaries, the alert log, and the
    evaluated SLO statuses. `to_dict()` is what `launch/serve.py` embeds
    as the trace's ``metadata.health`` (validate_health keys off its
    ``series`` map)."""

    series: Dict[str, Dict[str, float]]
    alerts: List[Alert]
    slos: List[SloStatus]

    def to_dict(self) -> Dict[str, object]:
        return {
            "series": self.series,
            "alerts": [a.to_dict() for a in self.alerts],
            "slos": [s.to_dict() for s in self.slos],
        }


class HealthMonitor:
    """Streaming drift detection over named series.

    `observe(name, value)` auto-registers the series on first use (with
    the given detection ``direction``), runs the detector, and — on an
    alert — appends to ``alerts`` and emits a ``health.alert`` instant
    event on the health thread track of the attached tracer."""

    def __init__(self, tracer=None, *, capacity: int = 512, warmup: int = 12,
                 alpha: float = 0.25, cusum_k: float = 0.5,
                 cusum_h: float = 9.0, zcap: float = 4.0):
        self.tracer = tracer
        self.series: Dict[str, SeriesHealth] = {}
        self.alerts: List[Alert] = []
        self._kw = dict(capacity=capacity, warmup=warmup, alpha=alpha,
                        cusum_k=cusum_k, cusum_h=cusum_h, zcap=zcap)

    def observe(self, name: str, value: float, *,
                direction: str = "up") -> Optional[Alert]:
        s = self.series.get(name)
        if s is None:
            s = SeriesHealth(name, direction=direction, **self._kw)
            self.series[name] = s
        alert = s.observe(value)
        if alert is not None:
            self.alerts.append(alert)
            if self.tracer is not None and self.tracer.enabled:
                from repro_torch.obs.trace import TID_HEALTH

                self.tracer.instant(
                    "health.alert", "health", tid=TID_HEALTH,
                    series=alert.series, kind=alert.kind, value=alert.value,
                    baseline=alert.baseline, z=alert.z,
                    direction=alert.direction)
        return alert

    def report(self, slos: Sequence[SloSpec] = (),
               metrics=None) -> HealthReport:
        statuses = [spec.evaluate(metrics) for spec in slos] \
            if metrics is not None else []
        return HealthReport(
            series={n: s.summary() for n, s in self.series.items()},
            alerts=list(self.alerts),
            slos=statuses)
