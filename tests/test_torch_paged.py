"""Port parity of paged serving (DESIGN.md §8): the host-side page pool,
radix cache and scheduler, the page gather K6, the paged model steps and
the paged engine, each against the reference on reduced qwen3-0.6b (f32
activations, ``mode="pallas"``, parameters carried over by convert.py).

- Host modules: one scripted sequence of pool/radix calls and one
  scheduler sequence with a failing reservation return the same values
  and end in the same state on both sides (exact).
- K6: the port's ``gather_pages`` (its plain version on the CPU) equals the
  reference's jnp gather and its Pallas kernel in interpret mode, bitwise,
  for f32 and bf16 pools.
- Model: a suffix prefill into pages after a radix-style hit, then two
  capped decode steps, within the logit tolerance of
  tests/test_torch_model.py (2e-3 of the logit scale; the reasons are
  stated there); the page tables and lengths exactly. The decode also
  runs from the reference's own cache state, carried over by
  ``from_jax_paged_cache``. Trash page 0 and the idle row are left out:
  colliding writes into the trash page land in an order neither side
  promises, and only the idle row reads it.
- Engine: greedy streams, step and transfer counts and the paged stats
  equal the reference engine's on a prefix-sharing stream, with eviction
  (``num_pages=7``) and with ``fused_decode=False``; the drain ends with
  all-trash tables and a conserved pool; an oversized request raises the
  same error. Each reference drain runs once, in a module fixture, with
  the hw twin's energy books on (the reference engine's default): the
  port's books of the evicting drain (per-request pJ and pJ per token,
  ``hw_telemetry()`` with the prefix credit and the wear book's per-tile
  reads) equal them exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import (hold_stats, tolerance_report,  # noqa: E402
                          to_numpy)

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.core.timefloats import TFConfig as JTF  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels.paged import (gather_pages_pallas,  # noqa: E402
                                 gather_pages_ref)
from repro.models import model as JM  # noqa: E402
from repro.serve import kvpool as jkvpool  # noqa: E402
from repro.serve import radix as jradix  # noqa: E402
from repro.serve import sched as jsched  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.request import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.convert import (from_jax_paged_cache,  # noqa: E402
                                 from_jax_params)
from repro_torch.core.timefloats import TFConfig  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.paged import gather_pages  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import kvpool, radix, sched  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402

LOGIT_TOL = 2e-3
PAGE, SLOTS, MAX_LEN = 8, 2, 64


@pytest.fixture(scope="module")
def models():
    cj = dataclasses.replace(jreduced(jget_config("qwen3-0.6b")),
                             tf=JTF(mode="pallas"), dtype="float32")
    ct = dataclasses.replace(reduced_for_smoke(get_config("qwen3-0.6b")),
                             tf=TFConfig(mode="pallas"), dtype="float32")
    pj = JM.init(cj, jax.random.PRNGKey(0))
    return cj, ct, pj, from_jax_params(to_numpy(pj), ct, "cpu")


def _pin_splits(cj, rows):
    """Give the port the reference's split count for this shape."""
    ns = jautotune.best_n_splits(PAGE, cj.n_heads, cj.resolved_head_dim,
                                 rows=rows)
    autotune.record(PAGE, cj.n_heads, cj.resolved_head_dim, ns, rows=rows)


def _close(got, want, label):
    rep = tolerance_report(got, want)
    scale = float(np.abs(np.asarray(want)).max())
    assert rep["max_abs"] <= LOGIT_TOL * scale, f"{label}: {rep}"


# ---------------------------------------------------------------------------
# Host modules.
# ---------------------------------------------------------------------------


def _pool_radix_script(pool_mod, radix_mod):
    """Alloc, insert, match, release and evict on one pool; returns every
    call's result and the final state."""
    pool = pool_mod.PagePool(num_pages=9, page_size=4)
    tree = radix_mod.RadixCache(pool)
    evict = lambda k: tree.evict(k, all_or_nothing=True)  # noqa: E731
    log = []
    a = pool.alloc(3)
    log += [a, tree.insert(list(range(12)), a)]
    log.append(tree.match(list(range(12)) + [99]))       # 3 pages pinned
    log.append(tree.match(list(range(5))))               # 1 page
    log.append(tree.match([7] * 9))                      # miss
    tree.release(log[2][0] + log[3][0])
    for p in a:
        log.append(pool.release(p))                      # tree holds them
    b = pool.alloc(4)
    log += [b, tree.insert([1] * 4 + [2] * 4, b[:2])]
    log.append(pool.alloc(5, evict=evict))               # short: refused
    log.append((tree.evictable_pages(), tree.nodes, tree.evictions))
    for p in b:
        pool.release(p)
    log.append(pool.alloc(6, evict=evict))               # evicts 2 LRU
    log.append(tree.evict(10))
    state = (list(pool._free), list(pool._ref), tree.nodes, tree.evictions,
             pool.pages_in_use, pool.free_pages, pool.conserved())
    return log, state


def test_pool_and_radix_follow_the_reference():
    got = _pool_radix_script(kvpool, radix)
    want = _pool_radix_script(jkvpool, jradix)
    assert got == want
    assert got[1][-1]  # conserved, with the last allocation still held
    assert kvpool.TRASH_PAGE == jkvpool.TRASH_PAGE == 0


def _sched_script(sched_mod, req_cls):
    """Five steps of FCFS picks over six requests whose reservation fails
    on its first tries for uids 1 and 3: skip-ahead, skipped counters and
    the starvation guard."""
    s = sched_mod.Scheduler("fcfs", max_skip=2, starve_after=2)
    queue = __import__("collections").deque(
        req_cls(uid=u, prompt=np.zeros(3 + u, np.int32)) for u in range(6))
    fails = {1: 4, 3: 1}
    log = []

    def reserve(req):
        if fails.get(req.uid, 0):
            fails[req.uid] -= 1
            return None
        return (req.uid, [req.uid])

    for n_free in (2, 1, 2, 2, 3):
        picks = s.pick(queue, n_free, s.begin_step(), reserve)
        log.append(([(r.uid, g) for r, g in picks],
                    [(r.uid, r.skipped) for r in queue]))
    return log


def test_scheduler_picks_follow_the_reference():
    got = _sched_script(sched, Request)
    assert got == _sched_script(jsched, JRequest)
    assert any(skipped for _, queued in got for _, skipped in queued)
    # policy="cost" is ported (its picks: tests/test_torch_hw.py); an
    # unknown policy raises as the reference's does.
    assert sched.Scheduler("cost").policy == "cost"
    with pytest.raises(ValueError):
        sched.Scheduler("lifo")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_pages_bitwise_against_reference(dtype):
    rng = np.random.default_rng(0)
    pool = jnp.asarray(rng.normal(size=(7, 4, 3, 2)), dtype)
    pt = rng.integers(0, 7, size=(3, 5)).astype(np.int32)
    pt[0, 0], pt[1, 2] = 0, pt[2, 3]  # trash and a duplicate id
    bits = np.asarray(pool).view(np.uint16) if dtype == "bfloat16" \
        else np.asarray(pool)
    tpool = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16) \
        if dtype == "bfloat16" else torch.from_numpy(bits.copy())
    got = gather_pages(tpool, torch.from_numpy(pt))
    got = got.view(torch.int16).numpy().view(np.uint16) \
        if dtype == "bfloat16" else got.numpy()
    for want in (gather_pages_ref(pool, jnp.asarray(pt)),
                 gather_pages_pallas(pool, jnp.asarray(pt), interpret=True)):
        want = np.asarray(want)
        want = want.view(np.uint16) if dtype == "bfloat16" else want
        assert np.array_equal(got, want)
    assert gather_pages.launches == 0  # CPU: plain version


# ---------------------------------------------------------------------------
# The paged model steps.
# ---------------------------------------------------------------------------


def test_suffix_prefill_and_capped_decode_match_reference(models):
    """One prefill wave into pages: slot 0 borrows pages 1-2, whose K/V a
    shared 16-token prefix left there (random here, the same on both
    sides), and prefills its 5-token suffix at offset 16 into page 3;
    slot 1 prefills 7 fresh tokens into page 4; row 2 is a dummy row.
    Then two decode steps capped at 3 pages (slot 2 stays idle)."""
    cj, ct, pj, pt = models
    b, max_len = 3, 32
    _pin_splits(cj, rows=b)
    rng = np.random.default_rng(3)
    rows = np.array([[1, 2, 3, 0], [4, 0, 0, 0]], np.int32)
    shape = (ct.n_layers, 2, PAGE, ct.n_kv_heads, ct.resolved_head_dim)
    prefix = {n: rng.standard_normal(shape).astype(np.float32)
              for n in ("k", "v")}
    tok = np.zeros((b, 8), np.int32)
    tok[0, :5] = rng.integers(0, cj.vocab_size, 5)
    tok[1, :7] = rng.integers(0, cj.vocab_size, 7)
    lens, offs, ids = ([21, 7, 0], [16, 0, 0], [0, 1, 3])
    steps = [rng.integers(0, cj.vocab_size, (b, 1)).astype(np.int32)
             for _ in range(2)]

    cache_j = JM.set_page_rows(
        JM.init_paged_cache(cj, b, max_len, page_size=PAGE, num_pages=13),
        np.array([0, 1]), rows)
    g = cache_j.groups[0]
    cache_j = cache_j._replace(groups=(g._replace(
        k=g.k.at[:, 1:3].set(prefix["k"]),
        v=g.v.at[:, 1:3].set(prefix["v"])),))
    cache_t = TM.set_page_rows(
        TM.init_paged_cache(ct, b, max_len, page_size=PAGE, num_pages=13,
                            device="cpu"), np.array([0, 1]), rows)
    for layer, lc in enumerate(cache_t.layers):
        lc.k[1:3] = torch.from_numpy(prefix["k"][layer])
        lc.v[1:3] = torch.from_numpy(prefix["v"][layer])

    lj, cache_j = jax.jit(lambda p, c: JM.prefill_into_pages(
        p, {"tokens": jnp.asarray(tok)}, cj, c, jnp.asarray(lens, jnp.int32),
        jnp.asarray(offs, jnp.int32), jnp.asarray(ids, jnp.int32)))(
            pj, cache_j)
    lt, cache_t = TM.prefill_into_pages(
        pt, torch.from_numpy(tok), ct, cache_t,
        torch.tensor(lens, dtype=torch.int32),
        torch.tensor(offs, dtype=torch.int32), np.array(ids))
    _close(lt[:2].numpy(), np.asarray(lj)[:2], "prefill logits")
    from_ref = from_jax_paged_cache(jax.tree.map(np.asarray, cache_j), "cpu")
    assert np.array_equal(from_ref.layers[0].pt.numpy(),
                          rows.tolist() + [[0, 0, 0, 0]])
    decode = jax.jit(lambda p, c, x: JM.decode_step(p, c, x, cj, kv_cap=24))
    for i, x in enumerate(steps):
        dj, cache_j = decode(pj, cache_j, jnp.asarray(x))
        dt, cache_t = TM.decode_step(pt, cache_t, torch.from_numpy(x), ct,
                                     kv_cap=24)
        _close(dt[:2].numpy(), np.asarray(dj)[:2], f"decode {i} logits")
        if i == 0:  # the same step from the reference's own state
            dr, _ = TM.decode_step(pt, from_ref, torch.from_numpy(x), ct,
                                   kv_cap=24)
            _close(dr[:2].numpy(), np.asarray(dj)[:2],
                   "decode from the reference cache")
    assert np.array_equal(cache_t.lengths.numpy(), [23, 9, 2])
    assert np.array_equal(cache_t.lengths.numpy(), np.asarray(cache_j.lengths))
    assert np.array_equal(cache_t.layers[1].pt.numpy(),
                          np.asarray(cache_j.groups[0].pt[1]))
    for name in ("k", "v"):
        for layer in range(ct.n_layers):
            _close(getattr(cache_t.layers[layer], name)[1:].numpy(),
                   np.asarray(getattr(cache_j.groups[0], name)[layer])[1:],
                   f"layer {layer} {name} pages")


# ---------------------------------------------------------------------------
# The paged engine.
# ---------------------------------------------------------------------------


def _stream(vocab, n=5, seed=1, max_new=4):
    """A prefix-sharing stream like tests/test_paged.py's: uids 0-1 share
    one 16-token prefix (two pages), uids 2-4 another, each plus 2 + uid
    fresh tokens. The second prefix is what makes a 6-page pool evict the
    first."""
    rng = np.random.default_rng(seed)
    shared = [rng.integers(0, vocab, 16).astype(np.int32) for _ in range(2)]
    return [(np.concatenate([shared[u >= 2], rng.integers(0, vocab, 2 + u)
                             .astype(np.int32)]), max_new) for u in range(n)]


def _drain(eng, req_cls, stream, finished=None):
    """The drain's streams by uid; its Finished records are appended to
    ``finished`` when given."""
    for uid, (prompt, max_new) in enumerate(stream):
        eng.submit(req_cls(uid=uid, prompt=prompt.copy(),
                           max_new_tokens=max_new))
    done = eng.run_until_drained()
    if finished is not None:
        finished.extend(done)
    return {f.uid: [int(t) for t in f.tokens] for f in done}


def _books(eng, finished) -> dict:
    """An engine's energy books after a drain: per request (energy_pj,
    pj_per_token), and the twin's telemetry."""
    return {"requests": {f.uid: (f.energy_pj, f.pj_per_token)
                         for f in finished},
            "telemetry": eng.hw_telemetry()}


ENGINE_RUNS = {"evicting": {"num_pages": 7},
               "unfused": {"fused_decode": False}}
STAT_KEYS = ("steps", "host_transfers", "radix_hits", "radix_hit_rate",
             "radix_nodes", "radix_evictions", "pool_pages_total",
             "pool_pages_in_use", "pool_pages_free")


@pytest.fixture(scope="module")
def reference_drains(models):
    cj, _, pj, _ = models
    stream = _stream(cj.vocab_size)
    out = {}
    for name, kw in ENGINE_RUNS.items():
        eng = JEngine(pj, cj, slots=SLOTS, max_len=MAX_LEN, paged=True,
                      page_size=PAGE, **kw)
        done = []
        streams = _drain(eng, JRequest, stream, done)
        out[name] = (streams, dict(eng.stats(), books=_books(eng, done)))
    return stream, out


@pytest.mark.parametrize("run", list(ENGINE_RUNS))
def test_paged_engine_matches_reference_engine(models, reference_drains,
                                               run):
    cj, ct, _, pt = models
    stream, ref = reference_drains
    want, want_stats = ref[run]
    _pin_splits(cj, rows=SLOTS)
    eng = Engine(pt, ct, slots=SLOTS, max_len=MAX_LEN, paged=True,
                 page_size=PAGE, device="cpu", **ENGINE_RUNS[run])
    got = _drain(eng, Request, stream)
    assert got == want
    st = eng.stats()
    assert {k: st[k] for k in STAT_KEYS} == \
        {k: float(want_stats[k]) for k in STAT_KEYS}
    assert st["radix_hits"] > 0 and eng.host_transfers == eng.steps
    if run == "evicting":
        assert st["radix_evictions"] > 0
    assert not eng.state.cache.layers[0].pt.any()  # all-trash tables
    assert eng.pool.conserved()


def test_stats_match_reference_engine(models, reference_drains):
    """The evicting drain's ``stats()``: the reference engine's keys (the
    port adds the twin's books as ``hw_*``) and every value that is not a
    wall-clock time, the compile and stall counters included."""
    cj, ct, _, pt = models
    stream, ref = reference_drains
    _pin_splits(cj, rows=SLOTS)
    eng = Engine(pt, ct, slots=SLOTS, max_len=MAX_LEN, paged=True,
                 page_size=PAGE, device="cpu", **ENGINE_RUNS["evicting"])
    assert _drain(eng, Request, stream) == ref["evicting"][0]
    want = {k: v for k, v in ref["evicting"][1].items() if k != "books"}
    hold_stats(eng.stats(), want)
    assert eng.stats()["radix_evictions"] > 0


def test_paged_drain_energy_books_equal_reference_engine(models,
                                                       reference_drains):
    """The evicting drain with the energy books on (both engines'
    default): every request's attributed pJ and pJ per token, and every
    telemetry figure (attributed, idle and total pJ, the prefix credit of
    its radix hits, slot utilization, the per-tile read chunks), equal
    the reference engine's exactly. The books are host arithmetic over
    the same censuses, booked in the same order."""
    cj, ct, _, pt = models
    stream, ref = reference_drains
    want = ref["evicting"][1]["books"]
    _pin_splits(cj, rows=SLOTS)
    eng = Engine(pt, ct, slots=SLOTS, max_len=MAX_LEN, paged=True,
                 page_size=PAGE, device="cpu", **ENGINE_RUNS["evicting"])
    done = []
    assert _drain(eng, Request, stream, done) == ref["evicting"][0]
    got = _books(eng, done)
    assert got["requests"] == want["requests"]
    assert got["telemetry"] == want["telemetry"]
    tel = got["telemetry"]
    assert tel["prefix_hits"] > 0 and tel["prefix_saved_pj"] > 0
    assert tel["total_pj"] == pytest.approx(
        tel["attributed_pj"] + tel["idle_pj"], rel=1e-15)
    st = eng.stats()
    assert st["hw_total_pj"] == tel["total_pj"]


def test_oversized_request_raises_as_reference(models):
    cj, ct, pj, pt = models
    prompt = np.arange(40, dtype=np.int32)
    errors = []
    for eng, req_cls in (
            (JEngine(pj, cj, slots=SLOTS, max_len=MAX_LEN, paged=True,
                     page_size=PAGE, num_pages=5, track_energy=False),
             JRequest),
            (Engine(pt, ct, slots=SLOTS, max_len=MAX_LEN, paged=True,
                    page_size=PAGE, num_pages=5, device="cpu"), Request)):
        eng.submit(req_cls(uid=0, prompt=prompt, max_new_tokens=8))
        with pytest.raises(ValueError) as e:
            eng.step()
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "more pages than the pool holds" in errors[1]


def test_bf16_paged_drain_agrees_with_dense_as_the_reference_does(models):
    """The port's fused paged drain with bf16 activations, as the card runs
    it, against the reference engine on the same weights and requests. The
    two frameworks round bf16 differently (XLA keeps excess precision
    inside its fusions; ROADMAP, Queue 3), so their streams part after a
    few tokens; what must hold is the reference's own promise, that the
    paged engine agrees with the dense one: each framework's paged drain
    agrees with its dense drain on the same count of streams (here all of
    them)."""
    cj, ct, pj, pt = models
    cj, ct = (dataclasses.replace(c, dtype="bfloat16") for c in (cj, ct))
    stream = _stream(cj.vocab_size)
    ref = {paged: _drain(JEngine(pj, cj, slots=SLOTS, max_len=MAX_LEN,
                                 paged=paged, page_size=PAGE,
                                 track_energy=False), JRequest, stream)
           for paged in (True, False)}
    _pin_splits(cj, rows=SLOTS)
    engines = {paged: Engine(pt, ct, slots=SLOTS, max_len=MAX_LEN,
                             paged=paged, page_size=PAGE, device="cpu")
               for paged in (True, False)}
    got = {paged: _drain(eng, Request, stream)
           for paged, eng in engines.items()}
    agree = lambda d: sum(d[True][u] == d[False][u] for u in d[True])  # noqa: E731
    assert sorted(got[True]) == sorted(ref[True]) == list(range(5))
    assert agree(got) == agree(ref) == 5
    assert engines[True].stats()["radix_hits"] > 0
    assert engines[True].pool.conserved()
