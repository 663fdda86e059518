"""Port parity of the health layer (``repro_torch.obs.health``, DESIGN.md
§13) against the reference's own objects on the CPU: the detectors fire
the same alerts (series, sample, kind, direction and values) on the same
series (steady, a level step, a downward drift, a cold-start spike), the
monitor emits the same ``health.alert`` instants and report, SLO burn
accounting and its exported gauges equal the reference's, and
``validate_health`` accepts a real artifact and rejects a tampered one.
On the engine (reduced qwen3, 2 layers, ``quant="none"``): health on
leaves streams, the non-wall-clock stats and the compile cache as they
are, a steady drain fires no alert, and only an engine given SLOs grows
their ``stats()`` keys."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import export as jexport  # noqa: E402
from repro.obs import health as jhealth  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.obs import export, health, metrics, trace  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402


def _steady(i):
    return 1.0 + 0.02 * ((i % 5) - 2)


# name -> (series values, SeriesHealth keywords)
SERIES = {
    "steady": ([_steady(i) for i in range(200)], {}),
    "level-step": ([_steady(i) if i < 100 else 3.0 for i in range(120)], {}),
    "downward-drift": ([0.8 + 0.01 * ((i % 3) - 1) if i < 100 else 0.2
                        for i in range(120)], {"direction": "down"}),
    "downward-drift-watched-up": ([0.8 + 0.01 * ((i % 3) - 1) if i < 100
                                   else 0.2 for i in range(120)], {}),
    "cold-start-spike": ([0.004, 0.250] + [
        0.004 + 0.0001 * ((i % 4) - 1.5) if i < 60 else 0.055
        for i in range(2, 120)], {}),
    "noise-then-drift": ([float(v) for v in np.random.default_rng(3).normal(
        1.0, 0.05, 150) + np.r_[np.zeros(100), np.linspace(0.0, 1.0, 50)]],
        {"warmup": 20, "direction": "both"}),
}
FIRES = {"steady": False, "level-step": True, "downward-drift": True,
         "downward-drift-watched-up": False, "cold-start-spike": True,
         "noise-then-drift": True}


@pytest.mark.parametrize("name", list(SERIES))
def test_series_detectors_fire_as_reference(name):
    values, kw = SERIES[name]
    got, want = health.SeriesHealth(name, **kw), \
        jhealth.SeriesHealth(name, **kw)
    alerts = []
    for v in values:
        a, b = got.observe(v), want.observe(v)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.to_dict() == b.to_dict()
            alerts.append(a)
        assert (got.baseline.mean, got.baseline.var, got.cusum.s_hi,
                got.cusum.s_lo) == (want.baseline.mean, want.baseline.var,
                                    want.cusum.s_hi, want.cusum.s_lo)
    assert bool(alerts) == FIRES[name]
    assert got.summary() == want.summary()
    if name == "level-step":
        # CUSUM needs >= 3 anomalous samples, and the winsorized baseline
        # must not absorb the step before then.
        assert 103 <= alerts[0].sample <= 111


def test_zscore_and_cusum_units_equal_reference():
    rng = np.random.default_rng(1)
    zs = [float(z) for z in rng.normal(0.0, 3.0, 200)]
    for direction in ("up", "down", "both"):
        pairs = ((health.ZScoreDetector(4.0, direction),
                  jhealth.ZScoreDetector(4.0, direction)),
                 (health.CusumDetector(direction=direction),
                  jhealth.CusumDetector(direction=direction)))
        for a, b in pairs:
            assert [a.update(z) for z in zs] == [b.update(z) for z in zs]
    ew, jew = health.EwmaBaseline(0.25), jhealth.EwmaBaseline(0.25)
    for z in zs[:20]:
        ew.update(z)
        jew.update(z)
        assert (ew.mean, ew.var, ew.sigma()) == (jew.mean, jew.var,
                                                 jew.sigma())


def _monitor_script(hmod, tmod):
    tr = tmod.Tracer(clock=iter(float(i) for i in range(10**6)).__next__)
    hm = hmod.HealthMonitor(tracer=tr, warmup=5)
    for i in range(80):
        hm.observe("lat", 1.0 if i < 60 else 5.0)
        hm.observe("accept", 0.8 if i < 60 else 0.1, direction="down")
    return tr, hm


def test_monitor_instants_and_report_equal_reference():
    (tt, thm), (jt, jhm) = _monitor_script(health, trace), \
        _monitor_script(jhealth, jtrace)
    assert thm.alerts and [a.to_dict() for a in thm.alerts] == \
        [a.to_dict() for a in jhm.alerts]
    got = export.chrome_payload(tt)
    assert json.dumps(got) == json.dumps(jexport.chrome_payload(jt))
    inst = [e for e in got["traceEvents"] if e.get("name") == "health.alert"]
    assert inst and all(e["tid"] == trace.TID_HEALTH for e in inst)
    assert {e["args"]["series"] for e in inst} == {"lat", "accept"}
    assert json.dumps(thm.report().to_dict()) == \
        json.dumps(jhm.report().to_dict())


def _slo_registry(mmod):
    reg = mmod.MetricsRegistry()
    rng = np.random.default_rng(4)
    h = reg.histogram("serve_itl_s")
    for v in [0.01] * 90 + [2.0] * 10 + [float(x) for x in
                                         rng.lognormal(-2.0, 1.0, 50)]:
        h.observe(v)
    t = reg.histogram("serve_ttft_s")
    for v in rng.lognormal(0.0, 1.0, 40):
        t.observe(float(v))
    reg.gauge("queue").set(3.0)
    reg.counter("stalls").inc(2)
    return reg


def _slos(hmod):
    return hmod.default_serve_slos(ttft_p95=2.0, itl_p95=1.0) + [
        hmod.SloSpec("itl_p50", "serve_itl_s", "p50", 0.05),
        hmod.SloSpec("itl_mean", "serve_itl_s", "mean", 0.2),
        hmod.SloSpec("ttft_max", "serve_ttft_s", "max", 10.0),
        hmod.SloSpec("queue", "queue", "value", 4.0),
        hmod.SloSpec("stalls", "stalls", "value", 1.0),
        hmod.SloSpec("absent", "nope", "p95", 1.0)]


def test_slo_burn_and_gauges_equal_reference():
    treg, jreg = _slo_registry(metrics), _slo_registry(jmetrics)
    got = [s.evaluate(treg) for s in _slos(health)]
    want = [s.evaluate(jreg) for s in _slos(jhealth)]
    assert [s.to_dict() for s in got] == [s.to_dict() for s in want]
    for st in got:
        assert st.burn_rate == (st.bad_fraction / st.allowed_fraction
                                if st.allowed_fraction > 0 else 0.0)
    assert not got[1].ok and got[-1].ok and got[-1].burn_rate == 0.0
    health.export_slo_gauges(treg, got)
    jhealth.export_slo_gauges(jreg, want)
    assert export.prometheus_text(treg) == jexport.prometheus_text(jreg)
    assert treg.to_dict() == jreg.to_dict()


def _health_payload():
    tr = trace.Tracer()
    hm = health.HealthMonitor(tracer=tr, warmup=5)
    for i in range(60):
        hm.observe("serve.itl_s", 0.01 if i < 40 else 0.5)
    assert hm.alerts
    reg = metrics.MetricsRegistry()
    h = reg.histogram("serve_itl_s")
    for v in [0.01] * 95 + [3.0] * 5:
        h.observe(v)
    rep = hm.report(slos=health.default_serve_slos(itl_p95=1.0),
                    metrics=reg)
    health.export_slo_gauges(reg, rep.slos)
    payload = export.chrome_payload(tr, metadata={"health": rep.to_dict()})
    return json.loads(json.dumps(payload)), reg.to_dict()


def test_validate_health_accepts_real_artifact_and_rejects_tampered():
    payload, mdict = _health_payload()
    assert export.validate_health(payload, metrics=mdict) == []
    assert jexport.validate_health(payload, metrics=mdict) == []
    bad = json.loads(json.dumps(payload))
    bad["metadata"]["health"]["alerts"][0]["series"] = "ghost.series"
    probs = export.validate_health(bad)
    assert any("ghost.series" in p for p in probs)
    assert probs == jexport.validate_health(bad)
    ghost = json.loads(json.dumps(payload))
    for ev in ghost["traceEvents"]:
        if ev.get("name") == "health.alert":
            ev["args"]["series"] = "ghost.instant"
    assert any("ghost.instant" in p for p in export.validate_health(ghost))
    tampered = dict(mdict)
    for k in tampered:
        if k.startswith("slo_burn_rate{"):
            tampered[k] += 0.125
    probs = export.validate_health(payload, metrics=tampered)
    assert any("burn" in p for p in probs)
    assert probs == jexport.validate_health(payload, metrics=tampered)
    partial = {k: v for k, v in mdict.items()
               if not k.startswith("slo_allowed_fraction")}
    assert any("incomplete" in p
               for p in export.validate_health(payload, metrics=partial))
    assert export.validate_health({"metadata": {}}) == \
        ["metadata.health missing — not a health artifact"]


# ---------------------------------------------------------------------------
# The engine with health on.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    ct = dataclasses.replace(reduced_for_smoke(get_config("qwen3-0.6b")),
                             quant="none", n_layers=2, dtype="float32")
    return ct, TM.init(ct, 0, device="cpu")


def _drain(eng, ct, n=4, max_new=6):
    rng = np.random.default_rng(7)
    for i in range(n):
        eng.submit(Request(
            uid=i, prompt=rng.integers(0, ct.vocab_size, 5 + i)
            .astype(np.int32), max_new_tokens=max_new))
    done = eng.run_until_drained()
    return {f.uid: [int(t) for t in f.tokens] for f in done}


def test_engine_health_on_leaves_the_drain_as_it_is(model):
    ct, params = model
    kw = dict(slots=2, max_len=64, device="cpu", paged=True, page_size=8)
    plain = Engine(params, ct, **kw)
    want = _drain(plain, ct)
    hm = health.HealthMonitor()
    eng = Engine(params, ct, health=hm, slos=health.default_serve_slos(),
                 **kw)
    assert _drain(eng, ct) == want
    got_st, want_st = eng.stats(), plain.stats()
    for k in want_st:
        if not k.endswith("_s"):
            assert got_st[k] == want_st[k], k
    assert eng.compile_cache_stats() == plain.compile_cache_stats()
    # The monitor saw the drain: a sample per step of the step wall, the
    # queue and the pool, and TTFT and ITL on the steps that emitted them.
    for name in ("serve.step_wall_s", "serve.queue_depth",
                 "serve.pool_occupancy"):
        assert hm.series[name].n == eng.steps
    assert hm.series["serve.ttft_s"].n > 0 and hm.series["serve.itl_s"].n > 0


def test_engine_steady_drain_stays_quiet_and_stats_gain_slo_keys(model):
    ct, params = model
    hm = health.HealthMonitor()
    eng = Engine(params, ct, slots=2, max_len=64, device="cpu", health=hm,
                 slos=health.default_serve_slos(ttft_p95=60.0,
                                                 itl_p95=60.0))
    _drain(eng, ct)
    assert hm.alerts == [], \
        f"steady drain alerted: {[a.series for a in hm.alerts]}"
    st = eng.stats()
    assert st["slo_ttft_p95_burn_rate"] == 0.0
    assert st["slo_ttft_p95_ok"] == 1.0 and st["slo_itl_p95_ok"] == 1.0
    # SLO keys are opt-in: a plain engine's stats() has none.
    assert not any(k.startswith("slo_") for k in Engine(
        params, ct, slots=2, max_len=64, device="cpu").stats())
