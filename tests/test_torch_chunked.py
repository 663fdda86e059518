"""Port parity of chunked prefill (DESIGN.md §10): the port's chunked engine
against the JAX engine's, on reduced qwen3-0.6b (dense and paged) and the
reference tests' ``mla_cfg()`` (paged), parameters carried over by
convert.py.

- Vehicles: ``n_layers=2``, f32 activations, ``quant="none"`` as the
  reference's own chunked tests run (tests/test_chunked.py), and one
  TimeFloats drain (``mode="separable"``, paged, chunked and speculative
  together).
- Tolerance: token streams bitwise equal; the step, host-transfer and
  chunk-wave counts and the paged stats exactly; the resumed wave's
  logits within 2e-3 of the logit scale (tests/test_torch_model.py's
  tolerance and reasons) and its cache rows within the same.
- The port's chunked streams also equal its own unchunked streams; the
  chunk log tiles each long prompt in order; the pool is conserved at
  every step of a chunked paged drain, and no radix match borrows a page
  before the final chunk that writes it has run.
Each reference drain runs once, in a module fixture.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import (hold_stats, tolerance_report,  # noqa: E402
                          to_numpy)

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.core.timefloats import TFConfig as JTF  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.request import Request as JRequest  # noqa: E402
from repro.serve.spec import SpecConfig as JSpec  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.convert import from_jax_cache, from_jax_params  # noqa: E402
from repro_torch.core.timefloats import TFConfig  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402
from repro_torch.serve.spec import SpecConfig  # noqa: E402

LOGIT_TOL = 2e-3
SLOTS, MAX_LEN, PAGE, CHUNK = 3, 128, 8, 16
STAT_KEYS = ("steps", "host_transfers", "chunk_waves", "finished",
             "new_tokens")
PAGED_KEYS = ("radix_hits", "radix_hit_rate", "radix_nodes",
              "pool_pages_in_use", "pool_pages_free")


def _vehicle(name, tf=None):
    """(jax cfg, port cfg, jax params, port params)."""
    def cut(cfg, base, mla_cls, tf_cls):
        over = dict(n_layers=2, dtype="float32", quant="none")
        if tf is not None:
            over.update(quant="timefloats", tf=tf_cls(mode=tf))
        if name == "mla":
            over["mla"] = mla_cls(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_head_dim=16, qk_rope_head_dim=8,
                                  v_head_dim=16)
        return dataclasses.replace(base(cfg), **over)
    cj = cut(jget_config("qwen3-0.6b"), jreduced, jbase.MLAConfig, JTF)
    ct = cut(get_config("qwen3-0.6b"), reduced_for_smoke, tbase.MLAConfig,
             TFConfig)
    pj = jax.jit(lambda k: JM.init(cj, k))(jax.random.PRNGKey(0))
    return cj, ct, pj, from_jax_params(to_numpy(pj), ct, "cpu")


def mixed_stream(vocab, lens=(5, 90, 23, 70, 9, 33), seed=3, max_new=6):
    """tests/test_chunked.py's mixed_stream: prompts spanning 0-6 chunks."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, n).astype(np.int32), max_new)
            for n in lens]


def staggered_stream(vocab):
    """mixed_stream's prompts with budgets of 2 to 8 new tokens: a request
    finishes while others decode, and the next long prompt is admitted
    beside them."""
    return [(p, n) for (p, _), n in zip(mixed_stream(vocab),
                                        (3, 8, 4, 6, 2, 7))]


def drain(eng, req_cls, stream):
    for uid, (prompt, max_new) in enumerate(stream):
        eng.submit(req_cls(uid=uid, prompt=prompt.copy(),
                           max_new_tokens=max_new))
    return {f.uid: [int(t) for t in f.tokens]
            for f in eng.run_until_drained()}


def _pin_splits(cj, rows):
    """Give the port the reference's split count for the paged decode."""
    if cj.mla is not None:
        d, h = cj.mla.kv_lora_rank + cj.mla.qk_rope_head_dim, cj.n_heads
    else:
        d, h = cj.resolved_head_dim, cj.n_heads
    autotune.record(PAGE, h, d, jautotune.best_n_splits(PAGE, h, d,
                                                        rows=rows), rows=rows)


# (vehicle, paged) of the chunked drains held against the reference.
RUNS = {"qwen3-dense": ("qwen3", False), "qwen3-paged": ("qwen3", True),
        "mla-paged": ("mla", True)}


@pytest.fixture(scope="module")
def vehicles():
    return {name: _vehicle(name) for name in ("qwen3", "mla")}


@pytest.fixture(scope="module")
def reference_drains(vehicles):
    """The reference engine's chunked drains, and an unchunked dense drain
    of the mixed prompts with staggered budgets (``qwen3-dense-unchunked``),
    so that long prompts are admitted beside decoding slots."""
    out = {}
    for run, (name, paged) in RUNS.items():
        cj, _, pj, _ = vehicles[name]
        stream = mixed_stream(cj.vocab_size)
        eng = JEngine(pj, cj, slots=SLOTS, max_len=MAX_LEN, paged=paged,
                      page_size=PAGE, chunk_tokens=CHUNK, track_energy=False)
        out[run] = (stream, drain(eng, JRequest, stream), eng.stats())
    cj, _, pj, _ = vehicles["qwen3"]
    eng = JEngine(pj, cj, slots=SLOTS, max_len=MAX_LEN, track_energy=False)
    stream = staggered_stream(cj.vocab_size)
    out["qwen3-dense-unchunked"] = (stream, drain(eng, JRequest, stream),
                                    eng.stats())
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_chunked_engine_matches_reference_engine(vehicles, reference_drains,
                                                 run):
    name, paged = RUNS[run]
    cj, ct, _, pt = vehicles[name]
    stream, want, want_stats = reference_drains[run]
    _pin_splits(cj, rows=SLOTS)
    kw = dict(slots=SLOTS, max_len=MAX_LEN, paged=paged, page_size=PAGE,
              device="cpu")
    eng = Engine(pt, ct, chunk_tokens=CHUNK, **kw)
    got = drain(eng, Request, stream)
    assert got == want
    st = eng.stats()
    keys = STAT_KEYS + (PAGED_KEYS if paged else ())
    assert {k: st[k] for k in keys} == {k: float(want_stats[k]) for k in keys}
    assert st["chunk_waves"] > 0
    assert drain(Engine(pt, ct, **kw), Request, stream) == got  # unchunked
    # The chunk log tiles every long prompt in order; short ones ride the
    # classic wave.
    tiles = {}
    for uid, off, n in eng.chunk_log:
        tiles.setdefault(uid, []).append((off, n))
    for uid, (prompt, _) in enumerate(stream):
        if len(prompt) <= CHUNK:
            assert uid not in tiles
            continue
        pos = 0
        for off, n in tiles[uid]:
            assert off == pos and 0 < n <= CHUNK
            pos += n
        assert pos == len(prompt)
    if paged:
        assert eng.pool.conserved()
        assert not eng.state.cache.layers[0].pt.any()  # all-trash tables


@pytest.mark.parametrize("chunked", [True, False])
def test_stats_match_reference_engine(vehicles, reference_drains, chunked):
    """The dense chunked drain's ``stats()``, and an unchunked drain's of
    the same prompts with staggered budgets: the reference engine's keys
    and every value that is not a wall-clock time. The unchunked engine
    stalls its decoding slots behind the long prompts' prefill waves
    (``decode_stall_steps`` > 0); a chunked engine runs at most a chunk
    beside them and never stalls."""
    cj, ct, _, pt = vehicles["qwen3"]
    run = "qwen3-dense" if chunked else "qwen3-dense-unchunked"
    stream, want, want_stats = reference_drains[run]
    eng = Engine(pt, ct, slots=SLOTS, max_len=MAX_LEN, device="cpu",
                 chunk_tokens=CHUNK if chunked else None)
    assert drain(eng, Request, stream) == want
    st = eng.stats()
    hold_stats(st, want_stats)
    if chunked:
        assert st["decode_stall_steps"] == 0 and st["chunk_waves"] > 0
    else:
        assert st["decode_stall_steps"] > 0 and st["chunk_waves"] == 0


def _tree_pages(tree) -> set:
    out, todo = set(), list(tree.root.children.values())
    while todo:
        node = todo.pop()
        out.add(node.page)
        todo.extend(node.children.values())
    return out


def test_pool_conserved_and_no_early_radix_hit_mid_chunk(vehicles):
    """A paged chunked drain step by step. Three prompts share a 40-token
    prefix (5 pages); the second is submitted while the first is still
    mid-prefill, the third waits for a slot. At every step the pool is
    conserved and every tree page of a mid-prefill prompt is already
    written; the second request finds no prefix to borrow, the third
    borrows the 5 shared pages."""
    _, ct, _, pt = vehicles["qwen3"]
    rng = np.random.default_rng(9)
    shared = rng.integers(0, ct.vocab_size, 40).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, ct.vocab_size, n)
                               .astype(np.int32)]) for n in (30, 11, 5)]
    eng = Engine(pt, ct, slots=2, max_len=MAX_LEN, paged=True,
                 page_size=PAGE, chunk_tokens=CHUNK, device="cpu")
    reqs = [Request(uid=u, prompt=p, max_new_tokens=3)
            for u, p in enumerate(prompts)]
    eng.submit(reqs[0])
    done = []
    for n_step in range(100):
        done.extend(eng.step())
        assert eng.pool.conserved()
        in_tree = _tree_pages(eng.radix)
        for slot, req in eng._chunking.items():
            for i, page in enumerate(eng._slot_pages[slot]):
                assert page not in in_tree or (i + 1) * PAGE <= \
                    req.prefilled, "an unwritten page is borrowable"
        if n_step == 0:
            assert eng._chunking, "the first prompt is mid-prefill"
            eng.submit(reqs[1])
            eng.submit(reqs[2])
        if n_step == 1:
            assert eng._prefix_hits == 0  # uid 1: nothing to borrow yet
        if not (eng.active or eng._chunking or eng.queue):
            break
    assert sorted(f.uid for f in done) == [0, 1, 2]
    st = eng.stats()
    assert st["radix_hits"] == 1 and st["radix_hit_rate"] == pytest.approx(
        40 / sum(len(p) for p in prompts))
    assert eng.chunk_waves > 0 and eng.pool.conserved()


def test_resumed_prefill_into_slots_matches_reference(vehicles):
    """One resumed wave: slot 2 holds 12 prefilled tokens and continues with
    9 more at offset 12, slot 0 starts 7 fresh tokens at offset 0, row 2 is
    a dummy; the logits and the slots' rows against the reference's."""
    cj, ct, pj, pt = vehicles["qwen3"]
    rng = np.random.default_rng(5)
    first = rng.integers(0, cj.vocab_size, (1, 12)).astype(np.int32)
    tok = np.zeros((3, 16), np.int32)
    tok[0, :9] = rng.integers(0, cj.vocab_size, 9)
    tok[1, :7] = rng.integers(0, cj.vocab_size, 7)
    lens, offs, ids = [21, 7, 0], [12, 0, 0], [2, 0, 3]
    cache_j = JM.init_cache(cj, 3, 32)
    cache_t = TM.init_cache(ct, 3, 32, "cpu")
    _, cache_j = JM.prefill_into_slots(pj, {"tokens": jnp.asarray(first)}, cj,
                                       cache_j, jnp.asarray([12]),
                                       jnp.asarray([2]), max_len=32)
    _, cache_t = TM.prefill_into_slots(pt, torch.from_numpy(first), ct,
                                       cache_t, torch.tensor([12]),
                                       np.array([2]), max_len=32)
    lj, cache_j = jax.jit(lambda p, c: JM.prefill_into_slots(
        p, {"tokens": jnp.asarray(tok)}, cj, c, jnp.asarray(lens, jnp.int32),
        jnp.asarray(ids, jnp.int32), max_len=32,
        offsets=jnp.asarray(offs, jnp.int32)))(pj, cache_j)
    lt, cache_t = TM.prefill_into_slots(
        pt, torch.from_numpy(tok), ct, cache_t,
        torch.tensor(lens, dtype=torch.int32), np.array(ids), max_len=32,
        offsets=torch.tensor(offs, dtype=torch.int32))
    scale = float(np.abs(np.asarray(lj)[:2]).max())
    rep = tolerance_report(lt[:2].numpy(), np.asarray(lj)[:2])
    assert rep["max_abs"] <= LOGIT_TOL * scale, rep
    assert np.array_equal(cache_t.lengths.numpy(), [7, 0, 21])
    assert np.array_equal(cache_t.lengths.numpy(), np.asarray(cache_j.lengths))
    ref = from_jax_cache(jax.tree.map(np.asarray, cache_j), "cpu")
    for mine, theirs in zip(cache_t.layers, ref.layers):
        for f in mine._fields:
            a, b = getattr(mine, f).numpy(), getattr(theirs, f).numpy()
            rep = tolerance_report(a, b)
            assert rep["max_abs"] <= LOGIT_TOL * max(np.abs(b).max(), 1e-30)


def test_timefloats_paged_chunked_spec_drain_matches_reference():
    """One drain with TimeFloats arithmetic (``mode="separable"``), paged,
    chunked and speculative together: the port's streams equal the
    reference engine's, and so do the step and draft counts."""
    cj, ct, pj, pt = _vehicle("qwen3", tf="separable")
    rng = np.random.default_rng(11)
    motif = rng.integers(0, cj.vocab_size, 8).astype(np.int32)
    stream = [(np.concatenate([np.tile(motif, 3 + u),
                               rng.integers(0, cj.vocab_size, 2)
                               .astype(np.int32)]), 8) for u in range(3)]
    kw = dict(slots=2, max_len=64, paged=True, page_size=PAGE,
              chunk_tokens=CHUNK)
    jeng = JEngine(pj, cj, spec=JSpec(k=4), track_energy=False, **kw)
    want = drain(jeng, JRequest, stream)
    _pin_splits(cj, rows=2 * 5)
    eng = Engine(pt, ct, spec=SpecConfig(k=4), device="cpu", **kw)
    assert drain(eng, Request, stream) == want
    st, jst = eng.stats(), jeng.stats()
    keys = ("steps", "chunk_waves", "spec_proposed", "spec_accepted")
    assert {k: st[k] for k in keys} == {k: float(jst[k]) for k in keys}
    assert st["chunk_waves"] > 0 and st["spec_accepted"] > 0
    assert eng.pool.conserved()
