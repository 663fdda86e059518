"""The serving engine's compile discipline in the port: ``StepGraphs`` (the
counterpart of the reference's ``counting_jit``), ``Engine.compile_cache_
stats()`` and the fixed-shape cache writes a captured step needs.

- ``compile_cache_stats()`` equals the JAX engine's, key for key, after the
  reference tests' drains: tests/test_serve.py's two buckets and a second
  drain that compiles nothing, tests/test_paged_attn.py's paged prefix
  stream drained three times (the third adds nothing), a chunked paged
  drain, and speculative drains with the ngram draft (paged) and the draft
  model (dense). Token streams equal the reference's, one host transfer
  and one decode launch a step.
- The device-side ``scatter_cache_rows`` / ``gather_cache_rows`` /
  ``prefill_into_pages`` are bitwise the host-filtered forms they replace,
  with dummy and out-of-range ids.
- A replay adds exactly the launches its capture set aside; a CPU engine
  asked for graphs raises; MLA's absorption products of 20 rows equal the
  same rows computed 4 at a time, bitwise; the split-count lookup keyed on
  the table extent.

Vehicle: reduced qwen3-0.6b, ``quant="none"``, 2 layers, f32 activations,
as the reference's own tests run. Each reference drain runs once, in a
module fixture. On the CPU no graph is captured: an entry is its eager
callable, counted the same way.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from torch_parity import to_numpy  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.request import Request as JRequest  # noqa: E402
from repro.serve.spec import SpecConfig as JSpec  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import paged_attn as kpa  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import request as treq  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402
from repro_torch.serve.spec import SpecConfig  # noqa: E402

PAGE = 8


def _stream(vocab, lens, max_new, seed=0, shared=0):
    """(prompt, budget) pairs; ``shared`` tokens of a common prefix first."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, shared).astype(np.int32)
    return [(np.concatenate([head, rng.integers(0, vocab, n)
                             .astype(np.int32)]), max_new) for n in lens]


def _drain(eng, req_cls, stream, uid0=0):
    for i, (prompt, max_new) in enumerate(stream):
        eng.submit(req_cls(uid=uid0 + i, prompt=prompt.copy(),
                           max_new_tokens=max_new))
    return {f.uid: [int(t) for t in f.tokens]
            for f in eng.run_until_drained()}


# name -> (engine keywords, drains: [(lens, max_new, shared)]).
# "dense": tests/test_serve.py:195-221 (6 lengths in two buckets, then 2
# new lengths in the same buckets); "paged": tests/test_paged_attn.py:
# 364-383 (tests/test_paged.py's prefix_stream(n=4): a 21-token shared
# prefix and 2-5-token tails, three times); then one chunked and two
# speculative drains.
RUNS = {
    "dense": (dict(), [((3, 5, 7, 9, 12, 15), 3, 0), ((4, 11), 2, 0)]),
    "paged": (dict(paged=True), [((2, 3, 4, 5), 4, 21)] * 3),
    "chunked": (dict(paged=True, chunk_tokens=16),
                [((5, 40, 23, 9), 4, 0)]),
    "spec-ngram": (dict(paged=True, spec="ngram"), [((12, 20, 9), 6, 0)]),
    "spec-model": (dict(spec="model"), [((12, 20, 9), 6, 0)]),
}


def _engine_kw(kw, spec_cls, cfg, params):
    kw = dict(kw)
    draft = kw.pop("spec", None)
    if draft == "ngram":
        kw["spec"] = spec_cls(k=3)
    elif draft == "model":
        kw["spec"] = spec_cls(k=3, draft="model", draft_params=params,
                              draft_cfg=cfg)
    return dict(slots=2, max_len=64, page_size=PAGE, **kw)


@pytest.fixture(scope="module")
def vehicle():
    over = dict(quant="none", n_layers=2, dtype="float32")
    cj = dataclasses.replace(jreduced(jget_config("qwen3-0.6b")), **over)
    ct = dataclasses.replace(reduced_for_smoke(get_config("qwen3-0.6b")),
                             **over)
    pj = jax.jit(lambda k: JM.init(cj, k))(jax.random.PRNGKey(0))
    return cj, ct, pj, from_jax_params(to_numpy(pj), ct, "cpu")


@pytest.fixture(scope="module")
def reference(vehicle):
    """Per run: the reference's streams and compile_cache_stats() after
    each drain, and its steps / host transfers / decode launches."""
    cj, _, pj, _ = vehicle
    out = {}
    for run, (kw, drains) in RUNS.items():
        eng = JEngine(pj, cj, track_energy=False,
                      **_engine_kw(kw, JSpec, cj, pj))
        got = []
        for d, (lens, max_new, shared) in enumerate(drains):
            stream = _stream(cj.vocab_size, lens, max_new, shared=shared)
            got.append((_drain(eng, JRequest, stream, 10 * d),
                        eng.compile_cache_stats()))
        out[run] = (got, (eng.steps, eng.host_transfers,
                          eng.decode_launches))
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_compile_cache_stats_match_reference(vehicle, reference, run):
    cj, ct, _, pt = vehicle
    rows = 2 * (3 + 1) if "spec" in run else 2
    for r in {2, rows}:
        autotune.record(PAGE, cj.n_heads, cj.resolved_head_dim,
                        jautotune.best_n_splits(
                            PAGE, cj.n_heads, cj.resolved_head_dim, rows=r),
                        rows=r)
    kw, drains = RUNS[run]
    eng = Engine(pt, ct, device="cpu", **_engine_kw(kw, SpecConfig, ct, pt))
    want, (steps, transfers, launches) = reference[run]
    after = []
    for d, ((lens, max_new, shared), (want_streams, want_stats)) in \
            enumerate(zip(drains, want)):
        stream = _stream(ct.vocab_size, lens, max_new, shared=shared)
        assert _drain(eng, Request, stream, 10 * d) == want_streams, d
        after.append(eng.compile_cache_stats())
        assert after[-1] == want_stats, d
        assert eng.host_transfers == eng.steps == eng.decode_launches
    assert (eng.steps, eng.host_transfers, eng.decode_launches) == (
        steps, transfers, launches)
    stats = after[-1]
    if run == "dense":  # two buckets; the second drain compiles nothing
        assert stats["prefill[8]"] == stats["prefill[16]"] == 1
        assert stats["prefill_total"] == 2 and stats["decode_total"] == 1
        assert after[1] == after[0]
    if run == "paged":  # the third drain adds nothing; caps, not steps
        assert after[2] == after[1]
        assert 1 <= stats["decode_total"] < eng.decode_launches
        assert any(k.startswith("decode_and_sample[c") for k in stats)
    if run == "chunked":
        assert eng.chunk_waves > 0 and stats["prefill[c16]"] == 1
    if run == "spec-model":
        assert any(k.startswith("draft_prefill[") for k in stats)


def test_cpu_engine_asked_for_graphs_raises(vehicle):
    _, ct, _, pt = vehicle
    with pytest.raises(ValueError, match="CUDA graphs"):
        Engine(pt, ct, slots=2, max_len=64, device="cpu", graphs=True)
    assert not Engine(pt, ct, slots=2, max_len=64,
                      device="cpu").graphs.capture


# ---------------------------------------------------------------------------
# Fixed-shape cache writes against the host filters they replace.
# ---------------------------------------------------------------------------

# Wave-row ids: a real slot, the drop sentinel (== slots), negative and
# past-the-end padding, and a full set.
IDS = ([2, 3, -1], [0, 3, 3], [1, 0, 2], [5, -2, 1], [3, 3, 3])


def _host_scatter(full, rows, ids):
    """The host-filtered scatter: keep ids in [0, slots), indexed write."""
    slots = full.lengths.shape[0]
    ids = np.asarray(ids)
    keep = np.nonzero((ids >= 0) & (ids < slots))[0]
    if keep.size == 0:
        return full
    src, dst = torch.as_tensor(keep), torch.as_tensor(ids[keep])
    for f, r in zip(full.layers, rows.layers):
        for buf, new in zip(f, r):
            buf[dst] = new[src]
    full.lengths[dst] = rows.lengths[src].to(full.lengths.dtype)
    return full


def _filled(cfg, b, t, seed, paged=False):
    gen = torch.Generator().manual_seed(seed)
    if paged:
        cache = TM.init_paged_cache(cfg, b, t, page_size=PAGE,
                                    num_pages=2 * b * t // PAGE + 1,
                                    device="cpu")
    else:
        cache = TM.init_cache(cfg, b, t, "cpu")
    for lc in cache.layers:
        for buf in lc:
            if buf.dtype.is_floating_point:
                buf.copy_(torch.randn(buf.shape, generator=gen))
    cache.lengths.copy_(torch.randint(0, t, (b,), generator=gen,
                                      dtype=torch.int32))
    return cache


def _equal(a, b):
    return all(torch.equal(x, y) for la, lb in zip(a.layers, b.layers)
               for x, y in zip(la, lb)) and torch.equal(a.lengths, b.lengths)


@pytest.mark.parametrize("ids", IDS)
def test_fixed_shape_scatter_and_gather_equal_host_filter(vehicle, ids):
    _, ct, _, _ = vehicle
    rows = _filled(ct, 3, 16, seed=1)
    want = _host_scatter(_filled(ct, 3, 16, seed=2), rows, ids)
    for form in (np.asarray(ids), torch.tensor(ids, dtype=torch.int32)):
        got = TM.scatter_cache_rows(_filled(ct, 3, 16, seed=2), rows, form)
        assert _equal(got, want)
        gathered = TM.gather_cache_rows(rows, form)
        clip = torch.as_tensor(np.clip(np.asarray(ids), 0, 2))
        assert _equal(gathered, TM.ModelCache(
            tuple(type(lc)(*(t[clip] for t in lc)) for lc in rows.layers),
            rows.lengths[clip]))


@pytest.mark.parametrize("ids", IDS)
def test_fixed_shape_prefill_into_pages_equals_host_filter(vehicle, ids):
    _, ct, _, pt = vehicle
    cache = _filled(ct, 3, 16, seed=3, paged=True)
    TM.set_page_rows(cache, np.arange(3), np.arange(1, 7, dtype=np.int32)
                     .reshape(3, 2))
    before = TM.ModelCache(tuple(type(lc)(*(t.clone() for t in lc))
                                 for lc in cache.layers),
                           cache.lengths.clone())
    tok = torch.randint(0, ct.vocab_size, (3, 8),
                        generator=torch.Generator().manual_seed(4),
                        dtype=torch.int64).to(torch.int32)
    lens = torch.tensor([8, 5, 3], dtype=torch.int32)
    offs = torch.zeros(3, dtype=torch.int32)
    logits, got = TM.prefill_into_pages(pt, tok, ct, cache, lens, offs,
                                        torch.tensor(ids, dtype=torch.int32))
    # The host filter: dummy rows read an all-trash table, only real rows'
    # lengths land.
    host = np.asarray(ids)
    real = (host >= 0) & (host < 3)
    view = before.layers[0].pt[torch.as_tensor(np.clip(host, 0, 2))]
    view = torch.where(torch.as_tensor(real)[:, None], view, 0)
    rows = TM.ModelCache(tuple(lc._replace(pt=view) for lc in before.layers),
                         lens)
    want_logits, _ = TM.prefill(pt, tok, ct, rows, lengths=lens,
                                offsets=offs)
    keep = np.nonzero(real)[0]
    if keep.size:
        before.lengths[torch.as_tensor(host[keep])] = lens[
            torch.as_tensor(keep)]
    assert torch.equal(logits, want_logits)
    assert _equal(got, before)


# ---------------------------------------------------------------------------
# Launch accounting, MLA absorption, split lookup.
# ---------------------------------------------------------------------------


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_adds_exactly_the_launches_its_capture_set_aside():
    counters = treq.launch_counters()
    start = [f.launches for f in counters]
    deltas: list = []
    try:
        with treq.launches_set_aside(deltas):
            for i, f in enumerate(counters):
                f.launches += i + 1          # what a capture would count
        assert deltas == list(range(1, len(counters) + 1))
        assert [f.launches for f in counters] == start   # set aside
        out = torch.arange(3)
        entry = treq._Entry([], outputs=[out], graph=_Graph(),
                            deltas=deltas)
        for n in (1, 2):
            assert entry.replay()[0] is out
            assert [f.launches - s for f, s in zip(counters, start)] == [
                n * d for d in deltas]
        assert entry.graph.replays == 2
    finally:
        for f, s in zip(counters, start):
            f.launches = s


def test_cpu_entries_count_once_and_rerun_on_new_inputs():
    graphs = treq.StepGraphs("cpu", capture=False)
    calls = []

    def fn(x):
        calls.append(1)
        return (x * 2,)

    a = graphs.call("k", fn, np.arange(3, dtype=np.int32))[0]
    b = graphs.call("k", fn, np.arange(3, 6, dtype=np.int32))[0]
    assert a.tolist() == [0, 2, 4] and b.tolist() == [6, 8, 10]
    assert graphs.counts == {"k": 1} and len(calls) == 2


def test_mla_absorption_rows_equal_in_any_batch():
    """20 rows (a chain verify's 4 slots x 5 positions) against the same
    rows 4 at a time (a decode's), bitwise: q_lat, the up-projection and
    the latent attention's products."""
    gen = torch.Generator().manual_seed(7)
    h, n, c, v = 8, 16, 32, 16
    q = torch.randn(4, 5, h, n, generator=gen).bfloat16()
    wk = torch.randn(c, h, n, generator=gen)
    wv = torch.randn(c, h, v, generator=gen)
    o = torch.randn(4, 5, h, c, generator=gen)
    whole = tmla.absorb_query(q, wk)
    up = tmla._exact_einsum("bshc,chv->bshv", o, wv)
    for j in range(5):
        assert torch.equal(whole[:, j:j + 1], tmla.absorb_query(
            q[:, j:j + 1], wk))
        assert torch.equal(up[:, j:j + 1], tmla._exact_einsum(
            "bshc,chv->bshv", o[:, j:j + 1], wv))
    ckf = torch.randn(4, 24, c, generator=gen).bfloat16().float()
    krf = torch.randn(4, 24, 8, generator=gen).bfloat16().float()
    q_rope = torch.randn(4, 5, h, 8, generator=gen).bfloat16()
    pos = 10 + torch.arange(5)[None, :].expand(4, 5)
    lens = torch.tensor([15, 12, 11, 24])
    mask = tmla.MaskSpec()
    att = tmla._latent_attention(whole, q_rope, ckf, krf, pos, lens, mask,
                                 0.25)
    for j in range(5):
        assert torch.equal(att[:, j:j + 1], tmla._latent_attention(
            whole[:, j:j + 1], q_rope[:, j:j + 1], ckf, krf,
            pos[:, j:j + 1], lens, mask, 0.25))


def test_split_lookup_by_rows_and_table_extent():
    """Lookup order: rows- and extent-qualified key, the nearest extent of
    the same rows (the smaller on a tie), rows key, rows-agnostic key,
    nearest, 1; a pinned value before a recorded one; the paged kernels'
    lookups pass the table extent."""
    saved = autotune._persisted
    try:
        autotune.clear_memo()
        autotune._persisted = {"p16_h128_d576": 4, "p16_h128_d576_r20": 2,
                               "p16_h128_d576_r20_t8": 1,
                               "p16_h128_d576_r20_t32": 2}
        assert [autotune.best_n_splits(16, 128, 576, rows=20, pages=t)
                for t in (1, 2, 4, 8, 16, 32, 64)] == [1, 1, 1, 1, 1, 2, 2]
        assert autotune.best_n_splits(16, 128, 576, rows=20) == 2
        assert autotune.best_n_splits(16, 128, 576, rows=4, pages=8) == 4
        assert autotune.best_n_splits(16, 128, 576) == 4
        assert autotune._parse_key("p16_h128_d576_r20_t8") == (
            16, 128, 576, 20, 8)
        autotune.record(16, 128, 576, 8, rows=20)
        assert autotune.best_n_splits(16, 128, 576, rows=20, pages=8) == 8
        autotune._persisted = {"p16_h16_d128_r4_t8": 2}
        assert autotune.best_n_splits(16, 16, 128, rows=4, pages=16) == 2
    finally:
        autotune.clear_memo()
        autotune._persisted = saved
    record = autotune._load_persisted()
    assert all(v >= 1 and autotune._parse_key(k) for k, v in record.items())
    # K5 at the chain verify's 20 rows: recorded at every pow2 cap of a
    # 512-token engine, one split at each; a decode's 4 rows keep their
    # rows-keyed count.
    mla = dict(page_size=16, heads=128, head_dim=576)
    caps = (1, 2, 4, 8, 16, 32)
    assert all(f"p16_h128_d576_r20_t{t}" in record for t in caps)
    assert [kpa._norm_splits(None, t, rows=20, **mla)
            for t in caps] == [1] * len(caps)
    assert kpa._norm_splits(None, 8, rows=4, **mla) == record[
        "p16_h128_d576_r4"]
