"""Port parity: the hardware twin (``repro_torch.hw``: Table I energy, tile
placement, the op census, the step schedule, per-tile wear books, the
trainer's ``HwMonitor`` and the scheduler's ``policy="cost"``) against the
JAX reference on the CPU.

The twin is host arithmetic over integer censuses, so everything here is
held equal, not within a tolerance: placements at full width (shape-only
on both sides), census costs per tag (chunks, MACs, pJ), schedules, wear
vectors, monitor summaries and admission picks. The port runs its layer,
microbatch and dispatch-chunk loops in Python, so its census holds one
record per execution where the reference holds one per trace with a
multiplier; the records expanded by their multipliers and their costs are
what must agree. The serving drain's books are held in
tests/test_torch_paged.py, against the reference engine's.
"""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import to_numpy  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.configs.timefloats_mlp import CONFIG as JMLP  # noqa: E402
from repro.core import timefloats as jtf  # noqa: E402
from repro.hw import energy as jenergy  # noqa: E402
from repro.hw import mapper as jmapper  # noqa: E402
from repro.hw import schedule as jsched  # noqa: E402
from repro.launch.hw_report import mlp_report  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import sched as jserve_sched  # noqa: E402
from repro.serve.request import Request as JRequest  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.configs.timefloats_mlp import CONFIG as TMLP  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import energy as tcore_energy  # noqa: E402
from repro_torch.core import timefloats as ttf  # noqa: E402
from repro_torch.hw import energy as tenergy  # noqa: E402
from repro_torch.hw import mapper as tmapper  # noqa: E402
from repro_torch.hw import schedule as tsched  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import sched as tserve_sched  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.trainer import LoopConfig, run_loop  # noqa: E402

ARCHS = ("qwen3-0.6b", "deepseek-v3-671b", "kimi-k2-1t-a32b")


def _cost(events, sched_mod):
    c = sched_mod.census_cost(events)
    return c.chunks_by_tag, c.macs_by_tag, c.energy_pj_by_tag


def _expanded(events):
    """The census as a multiset of (tag, m, k, n), each record counted
    ``mult`` times."""
    out = collections.Counter()
    for e in events:
        out[(e.tag, e.m, e.k, e.n)] += e.mult
    return out


def _placement_totals(pl):
    return (pl.tiles, pl.macros, pl.cells_used, pl.cells_written_per_update,
            pl.utilization, pl.by_rule(),
            [(lp.rule, lp.rows, lp.cols, lp.copies) for lp in pl.leaves],
            [stop - start for _, start, stop in pl.tile_spans()],
            sorted(r for _, r in pl.unmapped))


def test_table1_energy_equals_reference():
    assert tenergy.TABLE1_PJ == jenergy.TABLE1_PJ
    assert tcore_energy.chunk_energy_pj is tenergy.chunk_energy_pj
    for adc in (True, False):
        assert tenergy.chunk_energy_pj(adc=adc) == \
            jenergy.chunk_energy_pj(adc=adc)
    assert tenergy.tops_per_watt() == jenergy.tops_per_watt()
    for mkn in ((1, 64, 128), (128, 100, 10), (7, 1000, 3)):
        assert tenergy.matmul_energy_pj(*mkn) == jenergy.matmul_energy_pj(*mkn)
        assert tenergy.effective_tops_per_watt(*mkn) == \
            jenergy.effective_tops_per_watt(*mkn)
    shapes = [(1024, 64, 128), (1024, 128, 10)]
    a, b = tenergy.model_energy(shapes), jenergy.model_energy(shapes)
    assert (a.total_pj, a.breakdown_pj, a.macs, a.tops_per_watt) == \
        (b.total_pj, b.breakdown_pj, b.macs, b.tops_per_watt)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_placement_equals_reference(arch):
    """Shape-only on both sides: the ParamSpec trees at every published
    width, nothing allocated. Per-token forward pJ equal too."""
    cj, ct = jget_config(arch), get_config(arch)
    got, want = tmapper.map_model(ct), jmapper.map_model(cj)
    assert _placement_totals(got) == _placement_totals(want)
    assert 0.0 < got.utilization <= 1.0
    a = tsched.per_token_forward_cost(got, ct)
    b = jsched.per_token_forward_cost(want, cj)
    assert (a.chunks_by_tag, a.macs_by_tag, a.energy_pj_by_tag) == \
        (b.chunks_by_tag, b.macs_by_tag, b.energy_pj_by_tag)


def test_edge_mlp_placement_schedule_and_tops_per_watt():
    """The paper-scale MLP: its placement, and the training step's census
    projection read off the reference's ``launch/hw_report.mlp_report``:
    22.1 TOPS/W within 1 %, energy, writes and the latency bound equal."""
    pl, step = tsched.edge_mlp_schedule(TMLP)
    assert _placement_totals(pl) == _placement_totals(
        jmapper.map_edge_mlp(JMLP))
    want = mlp_report()
    tops = step.read.hardware_tops_per_watt
    assert abs(tops - 22.1) / 22.1 < 0.01
    assert tops == want["hardware_tops_per_watt"]
    assert step.read.effective_tops_per_watt == \
        want["effective_tops_per_watt"]
    assert step.energy_pj * 1e-6 == want["step_energy_uj"]
    assert step.write_energy_pj * 1e-6 == want["step_write_uj"]
    assert step.cells_written == want["cells_written_per_update"]
    assert step.latency_ns * 1e-3 == want["step_latency_us_lower_bound"]
    tok = tsched.per_token_forward_cost(pl)
    assert tok.energy_pj == want["token_fwd_pj"]


# -- the op census ------------------------------------------------------------

def _configs(arch, **kw):
    cj = dataclasses.replace(jreduced(jget_config(arch)),
                             tf=jtf.TFConfig(mode="separable"), **kw)
    ct = dataclasses.replace(reduced_for_smoke(get_config(arch)),
                             tf=ttf.TFConfig(mode="separable"), **kw)
    return cj, ct


@pytest.fixture(scope="module")
def qwen3():
    """Reduced qwen3-0.6b: the reference's params (and the port's copy),
    a 4 x 16 batch, and the reference's census of its loss."""
    cj, ct = _configs("qwen3-0.6b", dtype="float32")
    pj = to_numpy(jax.jit(lambda k: JM.init(cj, k))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cj.vocab_size, (4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": np.ones((4, 16), np.float32)}
    jp = jax.tree.map(jnp.asarray, pj)
    events = jsched.capture_census(lambda p, b: JM.loss_fn(p, b, cj), jp,
                                   batch)
    return {"cj": cj, "ct": ct, "pj": pj, "jp": jp, "batch": batch,
            "events": events,
            "params": from_jax_params(pj, ct, "cpu"),
            "tbatch": {k: torch.from_numpy(v) for k, v in batch.items()}}


def test_census_of_the_loss_on_meta_equals_reference(qwen3):
    events = tsched.capture_census(
        lambda p, b: TM.loss_fn(p, b, qwen3["ct"]), qwen3["params"],
        qwen3["tbatch"])
    assert _expanded(events) == _expanded(qwen3["events"])
    assert _cost(events, tsched) == _cost(qwen3["events"], jsched)
    full = ttf.backward_census(events)
    assert _cost(full, tsched) == _cost(
        jtf.backward_census(qwen3["events"]), jsched)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_census_of_a_real_step_counts_each_read_once(qwen3, remat):
    """The census recorded while a loss and its backward really run:
    the checkpointed blocks' forward runs again inside the backward
    (remat full/dots), and must not record there."""
    ct = dataclasses.replace(qwen3["ct"], remat=remat)
    with ttf.op_census() as events:
        tstep.loss_and_grads(ct, qwen3["params"], qwen3["tbatch"])
    assert _cost(events, tsched) == _cost(qwen3["events"], jsched)


def test_census_of_an_accumulated_step_costs_the_same(qwen3):
    """accum=2: two microbatches of half the rows, each recorded; their
    cost is the reference's census of the whole batch (the twin prices a
    step by its tokens)."""
    ct = qwen3["ct"]
    tcfg = tstep.TrainConfig(accum=2)
    with ttf.op_census() as events:
        tstep.accumulated_grads(ct, tcfg, qwen3["params"], qwen3["tbatch"])
    assert {e.m for e in events} == {2 * 16}    # each microbatch's rows
    assert _cost(events, tsched) == _cost(qwen3["events"], jsched)


def test_census_of_an_moe_forward_equals_reference():
    """Reduced deepseek-v3 (MLA, a dense layer and MoE layers): the experts'
    reads count every expert (the port records a group of experts once
    with the group's count), the dispatch chunks each."""
    cj, ct = _configs("deepseek-v3-671b")
    pj = to_numpy(jax.jit(lambda k: JM.init(cj, k))(jax.random.PRNGKey(1)))
    batch = {"tokens": np.zeros((2, 16), np.int32),
             "labels": np.zeros((2, 16), np.int32),
             "mask": np.ones((2, 16), np.float32)}
    want = jsched.capture_census(lambda p, b: JM.loss_fn(p, b, cj),
                                 jax.tree.map(jnp.asarray, pj), batch)
    params = from_jax_params(pj, ct, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tsched.capture_census(lambda p, b: TM.loss_fn(p, b, ct), params, tb)
    assert _expanded(got) == _expanded(want)
    assert _cost(got, tsched) == _cost(want, jsched)
    with ttf.op_census() as real:          # eager, the expert groups' path
        with torch.no_grad():
            TM.loss_fn(params, tb, ct)
    assert _expanded(real) == _expanded(want)


def test_census_of_a_decode_step_equals_reference(qwen3):
    cj, ct = qwen3["cj"], qwen3["ct"]
    jc = JM.init_cache(cj, 4, 64)
    want = jsched.capture_census(lambda p, c, t: JM.decode_step(p, c, t, cj),
                                 qwen3["jp"], jc,
                                 jnp.zeros((4, 1), jnp.int32))
    tc = TM.init_cache(ct, 4, 64, "cpu")
    got = tsched.capture_census(lambda p, c, t: TM.decode_step(p, c, t, ct),
                                qwen3["params"], tc,
                                torch.zeros((4, 1), dtype=torch.int32))
    assert _expanded(got) == _expanded(want)
    assert tsched.census_cost(got).energy_pj == \
        jsched.census_cost(want).energy_pj


# -- schedule, wear books, monitor ------------------------------------------

def test_schedule_wear_and_monitor_equal_reference(qwen3):
    """``schedule_step`` of the training census on the reduced model's
    placement; ``TileWearBook`` after training steps and token reads (per
    tile, in the reference's tile order, and sorted); ``HwMonitor``'s
    per-step metrics and summaries after 3 steps and after ``resume_at``;
    the conservation invariant ``writes.sum() * cells_written_per_update
    == cum_cell_writes * n_tiles``."""
    cj, ct = qwen3["cj"], qwen3["ct"]
    tpl = tmapper.map_params(qwen3["params"], ct)
    jpl = jmapper.map_params(qwen3["jp"], cj)
    assert _placement_totals(tpl) == _placement_totals(jpl)
    events = ttf.backward_census(tsched.capture_census(
        lambda p, b: TM.loss_fn(p, b, ct), qwen3["params"], qwen3["tbatch"]))
    jevents = jtf.backward_census(qwen3["events"])
    a = tsched.schedule_step(tpl, events)
    b = jsched.schedule_step(jpl, jevents)
    assert (a.energy_pj, a.latency_ns, a.cells_written, a.tiles,
            a.read.hardware_tops_per_watt) == (
        b.energy_pj, b.latency_ns, b.cells_written, b.tiles,
        b.read.hardware_tops_per_watt)
    assert tsched.schedule_step(tpl, events, train=False).energy_pj == \
        jsched.schedule_step(jpl, jevents, train=False).energy_pj

    tw, jw = tsched.TileWearBook(tpl, ct), jsched.TileWearBook(jpl, cj)
    for book in (tw, jw):
        book.add_token_reads(7)
        book.on_train_step(3)
        book.add_read_chunks(12345.0)
        book.resume_at(5)
    assert np.array_equal(tw.writes, jw.writes)
    assert np.array_equal(tw.reads, jw.reads)
    assert np.array_equal(np.sort(tw.reads), np.sort(jw.reads))
    assert tw.summary() == jw.summary()

    tm, jm = tsched.HwMonitor(tpl, events), jsched.HwMonitor(jpl, jevents)
    for _ in range(3):
        assert tm.on_step() == jm.on_step()
    assert tm.summary() == jm.summary()
    tm.resume_at(10)
    jm.resume_at(10)
    assert tm.on_step() == jm.on_step()
    assert tm.summary() == jm.summary()
    s = tm.summary()
    assert tm.wear.writes_sum * tpl.cells_written_per_update == \
        s["total_cell_writes"] * tm.wear.n_tiles


def test_run_loop_books_the_monitor_and_resumes_it(tmp_path, qwen3):
    """``run_loop(hw_monitor=)``: the per-step metrics carry the books, the
    report and the final checkpoint's metadata the summary, and a run
    resumed from step 3 ends with the books of an uninterrupted one (the
    read chunks to float rounding: resume_at books the skipped steps'
    reads in one addition)."""
    import json

    ct = qwen3["ct"]

    def step(state, batch):
        return state._replace(step=state.step + 1), {"loss": torch.ones(())}

    def run(total, ckpt):
        mon = tsched.HwMonitor.for_training(qwen3["params"],
                                            qwen3["tbatch"], ct)
        seen = []
        st = tstep.TrainState(step=0, params={"w": torch.zeros(2)}, opt={},
                              generator=torch.Generator())
        _, rep = run_loop(st, step, lambda i: {}, LoopConfig(
            total_steps=total, log_every=1, ckpt_every=100, ckpt_dir=ckpt),
            on_metrics=lambda i, m: seen.append(m), hw_monitor=mon)
        return rep, seen

    full, seen = run(5, None)
    assert seen[-1]["hw_writes_per_tile"] == 5.0
    assert seen[0]["hw_step_energy_uj"] > 0
    run(3, str(tmp_path))
    resumed, _ = run(5, str(tmp_path))
    assert resumed.resumed_from == 3 and full.hw["steps"] == 5
    for k, v in full.hw.items():
        assert resumed.hw[k] == pytest.approx(v, rel=1e-12), k
    with open(tmp_path / "step_5.json") as f:
        assert json.load(f)["hw"] == resumed.hw


# -- admission ----------------------------------------------------------------

def _admission_script(sched_mod, req_cls, cost, budget_cls):
    """Four steps of cost-policy picks over eight requests of mixed prompt
    lengths and budgets under a token and pJ budget, with reservation
    failing once for uid 2: the picks and the queue's skipped counters."""
    s = sched_mod.Scheduler("cost", cost=cost, window=6, starve_after=2,
                            budget=budget_cls(prefill_tokens=80,
                                              prefill_pj=60 * cost.token_pj))
    rng = np.random.default_rng(6)
    queue = collections.deque()
    for u in range(8):
        r = req_cls(uid=u, prompt=np.zeros(int(rng.integers(4, 50)),
                                           np.int32),
                    max_new_tokens=int(rng.integers(1, 40)))
        r.queued_step = u // 3
        queue.append(r)
    fails = {2: 1}
    log = []

    def reserve(req):
        if fails.get(req.uid, 0):
            fails[req.uid] -= 1
            return None
        return (0, [req.uid])

    for n_free in (2, 3, 1, 4):
        picks = s.pick(queue, n_free, s.begin_step(), reserve)
        log.append(([r.uid for r, _ in picks],
                    [(r.uid, r.skipped) for r in queue]))
    return log


@pytest.mark.parametrize("wear", [0.0, 2.0])
def test_cost_policy_picks_equal_reference(qwen3, wear):
    """``AdmissionCost.for_model`` on the same weights (its per-token pJ
    from the placement), with and without the wear surcharge from a
    pre-aged monitor: the same picks, in the same order."""
    cj, ct = qwen3["cj"], qwen3["ct"]
    tmon = tsched.HwMonitor(tmapper.map_params(qwen3["params"], ct), [])
    jmon = jsched.HwMonitor(jmapper.map_params(qwen3["jp"], cj), [])
    for m in (tmon, jmon):
        m.resume_at(int(3e8))
    tcost = tsched.AdmissionCost.for_model(
        qwen3["params"], ct, wear_weight=wear,
        endurance=lambda: tmon.summary()["endurance_frac"])
    jcost = jsched.AdmissionCost.for_model(
        qwen3["jp"], cj, wear_weight=wear,
        endurance=lambda: jmon.summary()["endurance_frac"])
    assert tcost.token_pj == jcost.token_pj > 1.0
    assert tcost.request_score(30, 9) == jcost.request_score(30, 9)
    got = _admission_script(tserve_sched, Request, tcost, tsched.StepBudget)
    want = _admission_script(jserve_sched, JRequest, jcost,
                             jsched.StepBudget)
    assert got == want
    assert any(skipped for _, queued in got for _, skipped in queued)


def test_capture_census_runs_nothing_and_writes_nothing(qwen3):
    """The meta-device census of an engine's step (here a prefill bucket
    the drain never ran, as the prefix credit traces one) leaves the
    engine's state and cache, ``compile_cache_stats()``, the kernels'
    launch counters and the quantizer's call counts as they were."""
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.request import launch_counters

    ct = dataclasses.replace(qwen3["ct"], tf=ttf.TFConfig(mode="pallas"))
    eng = Engine(qwen3["params"], ct, slots=2, max_len=64, device="cpu")
    rng = np.random.default_rng(1)
    for u in range(2):
        eng.submit(Request(uid=u, prompt=rng.integers(0, 500, 5 + u)
                           .astype(np.int32), max_new_tokens=3))
    done = eng.run_until_drained()
    assert all(f.energy_pj > 0 for f in done)
    before = (eng.compile_cache_stats(),
              [f.launches for f in launch_counters()],
              ttf.quant_trace_counts(),
              [t.clone() for t in tree_lib.leaves(eng.state)])
    pj = eng._hw.prefill_bucket_pj(
        ("probe", 32), eng._census_prefill, eng.params, eng.state.cache,
        np.zeros((2, 32), np.int32), np.zeros(2, np.int32), None,
        np.full(2, 2, np.int32))
    assert pj > 0
    after = (eng.compile_cache_stats(),
             [f.launches for f in launch_counters()],
             ttf.quant_trace_counts(), tree_lib.leaves(eng.state))
    assert after[:3] == before[:3]
    assert all(torch.equal(a, b) for a, b in zip(after[3], before[3]))
    assert "prefill[32]" not in after[0]
