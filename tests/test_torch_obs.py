"""Port parity of the observability layer (``repro_torch.obs``, DESIGN.md
§11) against the reference's own objects on the CPU.

- The tracer, the metrics registry and the exporters: the same calls under
  a fake clock give the reference's Chrome payload, Prometheus text,
  flat snapshot and files, byte for byte; histogram percentiles equal the
  reference's and keep the ``v <= e < v * growth`` envelope (a hypothesis
  property through ``tests/_hypothesis_stub.py`` when hypothesis is
  missing).
- The engine (reduced qwen3, 2 layers, ``quant="none"``, f32): a traced
  drain equals an untraced one in streams, non-wall-clock stats, compile
  cache and energy books; the finished events, as (name, category, track,
  phase, args), equal the reference engine's trace of the same drain,
  event for event, on a dense drain and on a paged, chunked, speculative
  drain that evicts; the ``compile[...]`` spans number the step programs
  built.
- The energy folds (``quant="timefloats"``, 1 layer): on a dense and a
  paged speculative drain the event-order folds of the written trace's pJ
  args equal ``hw_telemetry()`` exactly and ``validate_trace`` accepts it.
- The trainer's spans, registry and health series through the port's
  ``make_train_step``; ``HwMonitor.export_gauges`` against the
  reference's; the metrics file round trip; ``launch.obs_report`` and the
  serve launcher's health smoke (``--inject-lag``, ``--expect-alert``).

The reference engine's drains run once, in a module fixture."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # degraded env: property tests skip, rest runs
    from _hypothesis_stub import given, settings, st

from torch_parity import to_numpy  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.hw import mapper as jmapper  # noqa: E402
from repro.hw import schedule as jsched  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.request import Request as JRequest  # noqa: E402
from repro.serve.request import percentile  # noqa: E402
from repro.serve.spec import SpecConfig as JSpec  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.hw import mapper as tmapper  # noqa: E402
from repro_torch.hw import schedule as tsched  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.launch import obs_report  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.obs import export, metrics, trace  # noqa: E402
from repro_torch.obs.health import HealthMonitor  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402
from repro_torch.serve.spec import SpecConfig  # noqa: E402

SLOTS, MAX_LEN, PAGE, CHUNK, K = 2, 64, 8, 16, 3


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


# ---------------------------------------------------------------------------
# Tracer, metrics and exporters against the reference's objects.
# ---------------------------------------------------------------------------


def _tracer_script(mod):
    """Nested spans, a span closed by an exception, args set after close,
    a complete span, instants, counters and a ring overflow."""
    tr = mod.Tracer(capacity=9, clock=FakeClock())
    with tr.span("outer", "t") as outer:
        with tr.span("inner", "t", tid=1, k=3):
            pass
        tr.instant("mark", "t", tid=mod.TID_HEALTH, series="x")
    outer.set(attributed_pj=42.5)
    with pytest.raises(ValueError):
        with tr.span("boom", "t"):
            raise ValueError("x")
    t0 = tr.now()
    tr.complete("compile[x]", t0, cat="jit", tid=mod.TID_COMPILE,
                callable="x")
    for i in range(6):
        tr.counter("pj", 0.5 * i, tid=mod.TID_SERVE)
    assert tr.open_spans == 0
    return tr


def test_tracer_payload_and_sinks_equal_reference(tmp_path):
    tt, jt = _tracer_script(trace), _tracer_script(jtrace)
    assert tt.dropped == jt.dropped > 0
    meta = {"hw": {"decode_attributed_pj": 1.5}}
    got = export.chrome_payload(tt, metadata=meta)
    want = jexport.chrome_payload(jt, metadata=meta)
    assert json.dumps(got) == json.dumps(want)
    export.write_chrome_trace(str(tmp_path / "t.json"), tt, metadata=meta)
    jexport.write_chrome_trace(str(tmp_path / "j.json"), jt, metadata=meta)
    assert export.write_jsonl(str(tmp_path / "t.jsonl"), tt) == \
        jexport.write_jsonl(str(tmp_path / "j.jsonl"), jt)
    for a, b in (("t.json", "j.json"), ("t.jsonl", "j.jsonl")):
        assert (tmp_path / a).read_text() == (tmp_path / b).read_text()
    assert trace.THREADS == jtrace.THREADS


def test_noop_tracer_is_inert():
    assert trace.NOOP.enabled is False
    with trace.NOOP.span("x", "c", tid=3, a=1) as sp:
        sp.set(b=2)
    assert sp is trace.NOOP_SPAN and trace.NOOP_SPAN.args == {}
    for sp in (trace.NOOP.instant("i"), trace.NOOP.counter("c", 1.0),
               trace.NOOP.complete("x", 0.0)):
        assert sp is trace.NOOP_SPAN
    assert len(trace.NOOP.events) == 0 and trace.NOOP.dropped == 0


def _metrics_script(mod):
    """Counters, gauges and histograms, labeled and not, with values
    across many buckets, zero and negative ones."""
    reg = mod.MetricsRegistry()
    rng = np.random.default_rng(5)
    c = reg.counter("serve_steps")
    c.inc(4)
    assert reg.counter("serve_steps") is c
    reg.counter("x", engine="fused").inc(3)
    reg.counter("x").inc()
    reg.gauge("g").set(2.5)
    reg.gauge("slo_burn_rate", slo="ttft_p95").set(0.25)
    h = reg.histogram("serve_ttft_s")
    for v in list(rng.lognormal(-3.0, 2.0, size=300)) + [0.0, -1.0]:
        h.observe(float(v))
    reg.histogram("coarse", growth=2.0, leaf="a").observe(3.0)
    with pytest.raises(TypeError):
        reg.gauge("x", engine="fused")
    with pytest.raises(AssertionError):
        c.inc(-1)
    return reg


def test_metrics_exposition_equals_reference(tmp_path):
    got, want = _metrics_script(metrics), _metrics_script(jmetrics)
    assert export.prometheus_text(got) == jexport.prometheus_text(want)
    assert got.to_dict() == want.to_dict()
    for name in ("m.json", "m.prom"):
        export.write_metrics(str(tmp_path / ("t" + name)), got)
        jexport.write_metrics(str(tmp_path / ("j" + name)), want)
        assert (tmp_path / ("t" + name)).read_text() == \
            (tmp_path / ("j" + name)).read_text()
    assert got.get("missing") is None


def _hold_percentiles(values):
    """Equal to the reference's histogram at every percentile, and within
    the nearest-rank envelope: ``v <= e < v * growth`` for the rank
    sample ``v``, with ``[p0, p100]`` bracketing the samples."""
    th, jh = metrics.Histogram("h"), jmetrics.Histogram("h")
    for v in values:
        th.observe(v)
        jh.observe(v)
    g = th.growth
    for p in (0, 1, 25, 50, 75, 90, 95, 99, 100):
        est = th.percentile(p)
        assert est == jh.percentile(p), p
        v = percentile(list(values), p)
        if v <= 0:
            assert est == 0.0
        elif p == 0:
            assert est < v <= est * g * (1 + 1e-9)
        else:
            assert v <= est < v * g, (p, v, est)
    if values:
        assert th.percentile(100) >= max(values)
        if min(values) > 0:
            assert th.percentile(0) <= min(values)
    assert (th.count, th.sum, th.bounds()) == (jh.count, jh.sum, jh.bounds())


def test_histogram_percentiles_equal_reference():
    rng = np.random.default_rng(7)
    _hold_percentiles([])
    _hold_percentiles([float(v) for v in rng.lognormal(0.0, 2.0, 500)])
    _hold_percentiles([float(v) for v in rng.uniform(1e-6, 1e3, 257)])
    _hold_percentiles([5.0])
    _hold_percentiles([1.0] * 100)
    _hold_percentiles([2.0 ** (i / 8) for i in range(-50, 50)])  # on edges
    _hold_percentiles([-1.0, 0.0, -5.5])
    _hold_percentiles([-1.0, 0.0, 10.0, 0.5])


@settings(max_examples=150, deadline=None)
@given(st.lists(st.floats(min_value=1e-9, max_value=1e12,
                          allow_nan=False, allow_infinity=False),
                min_size=1, max_size=100))
def test_histogram_percentile_envelope_property(values):
    _hold_percentiles(values)


def test_validate_trace_problems_equal_reference():
    def payloads(mod, exp):
        out = []
        tr = mod.Tracer()
        with tr.span("engine.step"):
            pass
        out.append(exp.chrome_payload(tr, metadata={"hw": {}}))
        tr = mod.Tracer(capacity=1)
        for name in ("a", "b"):
            with tr.span(name):
                pass
        out.append(exp.chrome_payload(tr))
        tr = mod.Tracer()
        with tr.span("decode_and_verify") as sp:
            pass
        sp.set(attributed_pj=1.0, accepted_pj=0.5, rejected_pj=0.5)
        out.append(exp.chrome_payload(tr, metadata={"hw": {
            "decode_attributed_pj": 2.0, "spec_accepted_pj": 0.5,
            "spec_rejected_pj": 0.25}}))
        return out

    got = [export.validate_trace(p) for p in payloads(trace, export)]
    want = [jexport.validate_trace(p) for p in payloads(jtrace, jexport)]
    assert got == want
    assert any("sched.pick" in p for p in got[0])
    assert any("dropped" in p for p in got[1])
    assert any("fold mismatch for decode_attributed_pj" in p for p in got[2])
    assert any("spec_rejected_pj" in p for p in got[2])
    assert export.validate_trace({"traceEvents": []}) == \
        ["traceEvents missing or empty"]


# ---------------------------------------------------------------------------
# The engine against the reference engine.
# ---------------------------------------------------------------------------


def _vehicle(**over):
    over = dict(dict(n_layers=2, dtype="float32", quant="none"), **over)
    cj = dataclasses.replace(jreduced(jget_config("qwen3-0.6b")), **over)
    ct = dataclasses.replace(reduced_for_smoke(get_config("qwen3-0.6b")),
                             **over)
    pj = jax.jit(lambda k: JM.init(cj, k))(jax.random.PRNGKey(0))
    return cj, ct, pj, from_jax_params(to_numpy(pj), ct, "cpu")


def _mixed_stream(vocab, n=5, seed=3, max_new=5):
    """tests/test_obs.py's mixed requests: prompts of 4 to 19 tokens."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(4, 20)))
             .astype(np.int32), max_new) for _ in range(n)]


def _shared_stream(vocab, n=5, seed=3, max_new=6):
    """Prompts of 2 to 4 tiles of an 8-token motif (pages the radix tree
    shares, chains the ngram draft extends; uids 0-1 one motif, the rest
    another, whose admissions evict the first's pages from a small pool)
    and 2 + uid random tokens; the longer ones take chunk waves."""
    rng = np.random.default_rng(seed)
    motifs = [rng.integers(0, vocab, 8).astype(np.int32) for _ in range(2)]
    return [(np.concatenate([np.tile(motifs[u >= 2], 2 + u % 3),
                             rng.integers(0, vocab, 2 + u).astype(np.int32)]),
             max_new) for u in range(n)]


# name -> (engine keywords (the port's spec in the reference's form is
# made by _spec), stream maker)
DRAINS = {
    "dense": (dict(), _mixed_stream),
    "paged-chunked-spec-evicting": (
        dict(paged=True, page_size=PAGE, chunk_tokens=CHUNK, num_pages=9,
             spec=K), _shared_stream),
}


def _kw(run, spec_cls):
    kw = dict(DRAINS[run][0], slots=SLOTS, max_len=MAX_LEN)
    if "spec" in kw:
        kw["spec"] = spec_cls(k=kw["spec"])
    return kw


def _drain(eng, req_cls, stream, finished=None):
    for uid, (prompt, max_new) in enumerate(stream):
        eng.submit(req_cls(uid=uid, prompt=prompt.copy(),
                           max_new_tokens=max_new))
    done = eng.run_until_drained()
    if finished is not None:
        finished.extend(done)
    return {f.uid: [int(t) for t in f.tokens] for f in done}


def _events(tr):
    """The finished events without their clock fields: (name, category,
    track, phase, args)."""
    return [(e.name, e.cat, e.tid, e.phase, tuple(sorted(e.args.items())))
            for e in tr.events]


def _pin_splits(cj):
    """Give the port the reference's split counts for the paged decode
    and the chain verify."""
    h, d = cj.n_heads, cj.resolved_head_dim
    for rows in (SLOTS, SLOTS * (K + 1)):
        autotune.record(PAGE, h, d, jautotune.best_n_splits(
            PAGE, h, d, rows=rows), rows=rows)


@pytest.fixture(scope="module")
def vehicle():
    return _vehicle()


@pytest.fixture(scope="module")
def reference_traces(vehicle):
    cj, _, pj, _ = vehicle
    out = {}
    for run, (_, make) in DRAINS.items():
        stream = make(cj.vocab_size)
        tr = jtrace.Tracer()
        eng = JEngine(pj, cj, tracer=tr, track_energy=False,
                      **_kw(run, JSpec))
        out[run] = (stream, _drain(eng, JRequest, stream), _events(tr),
                    eng.stats())
    return out


def _non_clock(stats):
    return {k: v for k, v in stats.items() if not k.endswith("_s")}


@pytest.mark.parametrize("run", list(DRAINS))
def test_traced_drain_equals_untraced_and_reference_trace(vehicle,
                                                          reference_traces,
                                                          run):
    cj, ct, _, pt = vehicle
    stream, want, want_events, want_stats = reference_traces[run]
    _pin_splits(cj)
    tr = trace.Tracer()
    eng = Engine(pt, ct, device="cpu", tracer=tr, **_kw(run, SpecConfig))
    plain = Engine(pt, ct, device="cpu", **_kw(run, SpecConfig))
    got = _drain(eng, Request, stream)
    assert got == want == _drain(plain, Request, stream)
    assert _non_clock(eng.stats()) == _non_clock(plain.stats())
    assert eng.compile_cache_stats() == plain.compile_cache_stats()
    assert tr.open_spans == 0 and tr.dropped == 0
    events = _events(tr)
    names = {e[0] for e in events}
    if run != "dense":
        for name in ("radix.match", "radix.insert", "pool.evict",
                     "prefill.chunk_wave", "decode_and_verify"):
            assert name in names, name
        assert eng.stats()["radix_evictions"] == sum(
            dict(e[4])["evicted"] for e in events if e[0] == "pool.evict")
    assert events == want_events
    # One compile span per step program built; the reference's stats keys.
    built = sum(v for k, v in eng.compile_cache_stats().items()
                if k not in ("prefill_total", "decode_total"))
    assert sum(e[0].startswith("compile[") for e in events) == built > 0
    assert set(eng.stats()) == set(want_stats)
    assert _non_clock(eng.stats()) == \
        {k: float(v) for k, v in _non_clock(want_stats).items()}
    reg = eng.metrics
    assert reg.get("serve_steps").value == eng.steps
    assert reg.get("serve_finished").value == len(stream)
    assert reg.get("serve_ttft_s").count == len(stream)
    assert reg.get("serve_itl_s").count == sum(len(t) - 1
                                                for t in got.values())


@pytest.mark.parametrize("run", ["dense", "paged-spec"])
def test_trace_pj_folds_equal_telemetry_exactly(tmp_path, run):
    """The energy-attribution contract at ``quant="timefloats"``: the
    event-order folds of the written file's pJ args reproduce the twin's
    accumulators exactly (the same float additions in the same order)."""
    _, ct, _, pt = _vehicle(quant="timefloats", n_layers=1)
    tr = trace.Tracer()
    if run == "dense":
        eng = Engine(pt, ct, slots=SLOTS, max_len=MAX_LEN, device="cpu",
                     tracer=tr)
        stream = _mixed_stream(ct.vocab_size, n=4, max_new=4)
    else:
        eng = Engine(pt, ct, slots=SLOTS, max_len=MAX_LEN, device="cpu",
                     tracer=tr, paged=True, page_size=PAGE,
                     spec=SpecConfig(k=K))
        stream = _shared_stream(ct.vocab_size, n=3)
    _drain(eng, Request, stream)
    hw = eng.hw_telemetry()
    assert hw["decode_attributed_pj"] > 0 and hw["prefill_attributed_pj"] > 0
    path = tmp_path / "trace.json"
    export.write_chrome_trace(str(path), tr, metadata={"hw": hw})
    payload = json.loads(path.read_text())

    def fold(prefix, arg="attributed_pj"):
        total = 0.0
        for ev in payload["traceEvents"]:
            if ev.get("ph") == "X" and ev["name"].startswith(prefix):
                pj = ev.get("args", {}).get(arg)
                if pj is not None:
                    total += pj
        return total

    assert fold("decode") == hw["decode_attributed_pj"]
    assert fold("prefill") == hw["prefill_attributed_pj"]
    assert fold("decode", "accepted_pj") == hw["spec_accepted_pj"]
    assert fold("decode", "rejected_pj") == hw["spec_rejected_pj"]
    if run != "dense":
        assert hw["spec_rejected_pj"] > 0
    assert export.validate_trace(payload) == []
    counters = [ev for ev in payload["traceEvents"]
                if ev.get("name") == "hw.attributed_pj"]
    assert counters[-1]["args"]["value"] == hw["attributed_pj"]


# ---------------------------------------------------------------------------
# The trainer, the wear gauges and the launchers.
# ---------------------------------------------------------------------------


def test_trainer_emits_spans_metrics_and_health(tmp_path):
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.train.step import (TrainConfig, init_state,
                                        make_train_step)
    from repro_torch.train.trainer import LoopConfig, run_loop

    ct = dataclasses.replace(reduced_for_smoke(get_config("qwen3-0.6b")),
                             quant="none", n_layers=1, dtype="float32")
    tcfg = TrainConfig(accum=1)
    pipe = DataPipeline(ct, batch=2, seq=16, kind="lm", device="cpu")
    state = init_state(ct, tcfg, 0, "cpu")
    mon = tsched.HwMonitor(tmapper.map_params(state.params, ct), events=[])
    tr, reg, hm = trace.Tracer(), metrics.MetricsRegistry(), HealthMonitor()
    loop = LoopConfig(total_steps=3, log_every=100, ckpt_every=2,
                      ckpt_dir=str(tmp_path))
    _, report = run_loop(state, make_train_step(ct, tcfg), pipe.batch_at,
                         loop, hw_monitor=mon, tracer=tr,
                         metrics_registry=reg, health=hm)
    assert tr.open_spans == 0
    steps = [e for e in tr.events if e.name == "train.step"]
    assert [e.args["step"] for e in steps] == [0, 1, 2]
    assert [e.args["loss"] for e in steps] == report.losses
    assert all(e.args["step_energy_uj"] ==
               mon.step_schedule.energy_pj * 1e-6 > 0 for e in steps)
    assert sum(e.name == "train.batch" for e in tr.events) == 3
    assert [(e.args["step"], e.args["reason"]) for e in tr.events
            if e.name == "train.checkpoint"] == [(2, "periodic"),
                                                 (3, "final")]
    assert [e.args["value"] for e in tr.events
            if e.name == "hw.endurance_frac"] == [
        i / tsched.hw_energy.ENDURANCE_WRITES for i in (1, 2, 3)]
    assert reg.get("train_steps").value == 3.0
    assert reg.get("train_step_s").count == 3
    assert reg.get("train_loss").value == report.losses[-1]
    assert reg.get("train_straggler_events").value == 0.0
    assert reg.get("hw_tile_writes_max").value == 3.0
    assert reg.get("hw_endurance_frac").value == \
        3 / tsched.hw_energy.ENDURANCE_WRITES
    assert hm.series["train.step_s"].n == 3
    assert list(hm.series["hw.tile_write_rate"].ring) == [1.0, 1.0, 1.0]
    # A resumed run restores under its span.
    tr2 = trace.Tracer()
    run_loop(init_state(ct, tcfg, 0, "cpu"), make_train_step(ct, tcfg),
             pipe.batch_at, dataclasses.replace(loop, total_steps=3),
             tracer=tr2)
    assert [(e.name, e.args) for e in tr2.events][0] == (
        "train.restore", {"step": 3})


def test_trainer_straggler_instant_and_emergency_checkpoint(tmp_path):
    """A step over ``straggler_factor`` times the running median: one
    ``train.straggler`` instant, its counter, and the emergency
    checkpoint's span (a stub step with an injected stall)."""
    import time

    from repro_torch.train.step import TrainState
    from repro_torch.train.trainer import LoopConfig, run_loop

    def step(state, batch):
        time.sleep(0.5 if state.step == 6 else 0.05)
        return state._replace(step=state.step + 1), {"loss": torch.ones(())}

    state = TrainState(step=0, params={"w": torch.zeros(2)}, opt={},
                       generator=torch.Generator())
    tr, reg = trace.Tracer(), metrics.MetricsRegistry()
    _, report = run_loop(state, step, lambda i: {}, LoopConfig(
        total_steps=8, log_every=100, ckpt_every=100,
        ckpt_dir=str(tmp_path), straggler_factor=3.0), tracer=tr,
        metrics_registry=reg)
    assert report.straggler_events == 1
    (inst,) = [e for e in tr.events if e.name == "train.straggler"]
    assert inst.phase == "i" and inst.args["step"] == 6
    assert reg.get("train_straggler_events").value == 1.0
    assert [(e.args["step"], e.args["reason"]) for e in tr.events
            if e.name == "train.checkpoint"] == [(7, "straggler"),
                                                 (8, "final")]


def test_hw_monitor_gauges_equal_reference(vehicle):
    """``TileWearBook``/``HwMonitor.export_gauges``: the reference's gauges
    and values, per leaf (the port's leaf keys name its own parameter
    tree, matched to the reference's by tile span order)."""
    cj, ct, pj, pt = vehicle
    tpl = tmapper.map_params(pt, ct)
    jpl = jmapper.map_params(to_numpy(pj), cj)
    names = {t[0]: j[0] for t, j in zip(tpl.tile_spans(), jpl.tile_spans())}
    assert [t[1:] for t in tpl.tile_spans()] == \
        [j[1:] for j in jpl.tile_spans()]
    tm, jm = tsched.HwMonitor(tpl, events=[]), jsched.HwMonitor(jpl, [])
    for m in (tm, jm):
        m.resume_at(7)
        m.on_step()
        m.wear.add_token_reads(5)
    treg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    tm.export_gauges(treg)
    jm.export_gauges(jreg)
    got = {(g.name, tuple((k, names.get(v, v)) for k, v in g.labels)):
           g.value for g in treg.collect()}
    want = {(g.name, g.labels): g.value for g in jreg.collect()}
    assert got == want
    assert treg.get("hw_tile_writes_max").value == 8.0
    assert any(g.labels for g in treg.collect())


def test_metrics_file_roundtrip(tmp_path):
    reg = metrics.MetricsRegistry()
    reg.counter("serve_steps").inc(4)
    reg.histogram("serve_ttft_s").observe(0.5)
    reg.gauge("hw_tile_read_chunks", leaf="embed").set(2.0)
    jpath = str(tmp_path / "m.json")
    export.write_metrics(jpath, reg)
    with open(jpath) as f:
        d = json.load(f)
    assert d == reg.to_dict()
    assert d["serve_steps"] == 4.0 and d["serve_ttft_s_count"] == 1.0
    assert d["hw_tile_read_chunks{leaf=embed}"] == 2.0
    ppath = str(tmp_path / "m.prom")
    export.write_metrics(ppath, reg)
    with open(ppath) as f:
        text = f.read()
    assert "# TYPE serve_steps counter" in text
    assert 'hw_tile_read_chunks{leaf="embed"} 2.0' in text
    assert 'serve_ttft_s_bucket{le="+Inf"} 1' in text


def test_obs_report_validates_a_port_trace(tmp_path, capsys, vehicle):
    cj, ct, _, pt = vehicle
    tr = trace.Tracer()
    eng = Engine(pt, ct, slots=SLOTS, max_len=MAX_LEN, device="cpu",
                 tracer=tr)
    _drain(eng, Request, _mixed_stream(ct.vocab_size, n=3, max_new=3))
    path = str(tmp_path / "t.json")
    export.write_chrome_trace(path, tr, metadata={"hw": eng.hw_telemetry()})
    mpath = str(tmp_path / "m.json")
    export.write_metrics(mpath, eng.metrics)
    assert obs_report.main([path, "--metrics", mpath, "--validate"]) == 0
    out = capsys.readouterr().out
    assert "trace valid" in out and "engine.step" in out
    assert "recompiles:" in out
    # A tampered file fails validation.
    payload = json.loads(open(path).read())
    payload["traceEvents"] = [ev for ev in payload["traceEvents"]
                              if ev.get("name") != "host_transfer"]
    with open(path, "w") as f:
        json.dump(payload, f)
    assert obs_report.main([path, "--validate"]) == 1


def test_serve_launcher_health_smoke(tmp_path, capsys):
    """The serve launcher's health smoke: a latency step injected from
    step 20 fires an alert (``--expect-alert`` exits 1 otherwise), the
    trace and metrics files validate in the launcher and again in
    ``obs_report``. The lag, 0.25 s, stands well above a CPU step of this
    model (~15 ms alone, a few times that beside other test processes)."""
    trace_out, metrics_out = str(tmp_path / "t.json"), str(
        tmp_path / "m.json")
    rc = serve_launcher.main([
        "--reduced", "--device", "cpu", "--quant", "none", "--slots", "2",
        "--requests", "2", "--max-new", "30", "--max-len", "64",
        "--health", "--inject-lag", "20:0.25", "--expect-alert",
        "--trace-out", trace_out, "--metrics-out", metrics_out])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "ALERT serve.itl_s up" in out
    assert obs_report.main([trace_out, "--metrics", metrics_out,
                            "--validate"]) == 0
    assert "health/slo re-derivation" in capsys.readouterr().out
    payload = json.loads(open(trace_out).read())
    alerts = [ev for ev in payload["traceEvents"]
              if ev.get("name") == "health.alert"]
    assert alerts and all(ev["tid"] == trace.TID_HEALTH for ev in alerts)
    assert export.validate_health(payload, json.loads(
        open(metrics_out).read())) == []


def test_train_launcher_writes_trace_and_metrics(tmp_path, capsys):
    """``launch.train --trace-out --metrics-out``: a training trace that
    ``obs_report --validate`` accepts (``train.step`` required) and a
    Prometheus metrics file with the loop's series."""
    from repro_torch.launch import train as train_launcher

    trace_out, metrics_out = str(tmp_path / "t.json"), str(
        tmp_path / "m.prom")
    assert train_launcher.main([
        "--device", "cpu", "--reduced", "--quant", "none", "--steps", "2",
        "--batch", "2", "--seq", "16", "--trace-out", trace_out,
        "--metrics-out", metrics_out]) == 0
    payload = json.loads(open(trace_out).read())
    steps = [ev for ev in payload["traceEvents"]
             if ev.get("name") == "train.step"]
    assert [ev["args"]["step"] for ev in steps] == [0, 1]
    text = open(metrics_out).read()
    assert "train_steps 2.0" in text and "# TYPE train_step_s histogram" \
        in text
    assert obs_report.main([trace_out, "--metrics", metrics_out,
                            "--validate"]) == 0
    assert "trace valid" in capsys.readouterr().out
