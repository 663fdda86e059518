"""Port parity of speculative decoding (DESIGN.md §12): ``serve/spec.py``'s
pure functions, ``model.verify_step`` and the speculative engine, against
the JAX package on reduced qwen3-0.6b and the reference tests' MLA config
(``mla_cfg()``), parameters carried over by convert.py.

- Pure functions: ``propose_ngram``, ``chain_accept``,
  ``sequential_oracle``, ``accept_tree``, ``TokenTree`` and
  ``greedy_continuation`` return exactly the reference's values on seeded
  numpy cases (tiny vocabularies, so matches, stops and ties are common).
- ``verify_step`` (dense and paged, GQA and MLA; the paged chain runs the
  K4/K5 plain versions over B·(K+1) rows): column j equals the logits of
  j+1 sequential ``decode_step`` calls in its argmax and within 1e-5 of
  the logit scale (the verify's products have B·(K+1) rows where the
  decode's have B, and the CPU BLAS sums a row in an order that depends
  on the row count: 3e-7 apart measured, never bitwise promised), and the
  reference's ``verify_step`` on the same inputs within 2e-3 of the
  logit scale (the tolerance and reasons of tests/test_torch_model.py).
- Engine (``n_layers=2``, f32 activations, ``quant="none"``, as the
  reference's own tests; ngram draft, K = 4): spec-on streams equal the JAX
  engine's spec-on streams and the port's spec-off streams bitwise, with
  the reference's step and draft counts, dense and paged. A self-draft
  (``draft="model"``, the target as its own draft) accepts every chain; a
  paged drain whose verify overhangs every reservation conserves the pool
  at every step; temperature > 0 is rejected.
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
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import spec as jspec  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.request import Request as JRequest  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.convert import from_jax_cache, from_jax_params  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import spec  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402

LOGIT_TOL = 2e-3
SEQ_TOL = 1e-5   # verify column against sequential decode, of the scale
K, SLOTS, MAX_LEN, PAGE = 4, 2, 64, 8


# ---------------------------------------------------------------------------
# The pure functions.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_propose_ngram_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        n = int(rng.integers(0, 30))
        hist = rng.integers(0, 1 + seed * 2 + 2, n).astype(np.int32)
        k, max_n = int(rng.integers(1, 6)), int(rng.integers(1, 5))
        got = spec.propose_ngram(hist, k, max_n=max_n)
        want = jspec.propose_ngram(hist, k, max_n=max_n)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("eos", [None, 0, 3])
def test_chain_accept_matches_reference_and_oracle(eos):
    rng = np.random.default_rng(7 if eos is None else eos + 8)
    b, max_len = 24, 32
    ref = jax.jit(lambda *a: jspec.chain_accept(*a, max_len=max_len,
                                                eos=eos))
    for k in range(1, 6):
        greedy = rng.integers(0, 4, (b, k + 1)).astype(np.int32)
        draft = np.where(rng.random((b, k)) < 0.7, greedy[:, :-1],
                         rng.integers(0, 4, (b, k))).astype(np.int32)
        remaining = rng.integers(1, 2 * k + 3, b).astype(np.int32)
        lengths0 = rng.integers(1, max_len - 1, b).astype(np.int32)
        got = spec.chain_accept(*(torch.from_numpy(a) for a in (
            greedy, draft, remaining, lengths0)), max_len=max_len, eos=eos)
        want = ref(greedy, draft, remaining, lengths0)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        for r in range(b):
            args = (draft[r], greedy[r], int(remaining[r]),
                    int(lengths0[r]), max_len, eos)
            toks, done = spec.sequential_oracle(*args)
            assert (toks, done) == jspec.sequential_oracle(*args)
            assert int(got[1][r]) == len(toks) and bool(got[2][r]) == done


def _greedy_fn(seed, vocab=5):
    """A deterministic next-token function of the last three tokens."""
    def fn(prefix):
        r = np.random.default_rng([seed, len(prefix) % 5,
                                   *[t % vocab for t in prefix[-3:]]])
        return int(np.argmax(r.standard_normal(vocab).round(1)))
    return fn


@pytest.mark.parametrize("seed", range(3))
def test_token_tree_and_accept_tree_match_reference(seed):
    rng = np.random.default_rng(seed + 20)
    fn = _greedy_fn(seed)
    for _ in range(30):
        n = int(rng.integers(1, 8))
        parents = tuple(int(rng.integers(-1, i)) for i in range(n))
        context = rng.integers(0, 5, int(rng.integers(1, 6))).tolist()
        tree = spec.TokenTree(tuple(int(t) for t in rng.integers(0, 5, n)),
                              parents)
        jtree = jspec.TokenTree(tree.tokens, tree.parents)
        assert [tree.depth(i) for i in range(n)] == \
            [jtree.depth(i) for i in range(n)]
        assert [tree.path(i) for i in range(n)] == \
            [jtree.path(i) for i in range(n)]
        root = fn(tuple(context))
        nodes = [fn(tuple(context + [tree.tokens[j] for j in tree.path(i)]))
                 for i in range(n)]
        got = spec.accept_tree(tree, root, nodes)
        assert got == jspec.accept_tree(jtree, root, nodes)
        assert got == spec.greedy_continuation(fn, context, len(got)) == \
            jspec.greedy_continuation(fn, context, len(got))
    chain = spec.TokenTree.chain([3, 1, 4])
    assert chain == spec.TokenTree(*dataclasses.astuple(
        jspec.TokenTree.chain([3, 1, 4])))
    with pytest.raises(ValueError):
        spec.TokenTree((1, 2), (-1, 1))   # a node its own parent
    with pytest.raises(ValueError):
        spec.SpecConfig(k=0)


# ---------------------------------------------------------------------------
# verify_step.
# ---------------------------------------------------------------------------


def _vehicle(name):
    def cut(cfg, base, mla_cls):
        over = dict(n_layers=2, dtype="float32", quant="none")
        if name == "mla":
            over["mla"] = mla_cls(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_head_dim=16, qk_rope_head_dim=8,
                                  v_head_dim=16)
        return dataclasses.replace(base(cfg), **over)
    cj = cut(jget_config("qwen3-0.6b"), jreduced, jbase.MLAConfig)
    ct = cut(get_config("qwen3-0.6b"), reduced_for_smoke, tbase.MLAConfig)
    pj = jax.jit(lambda k: JM.init(cj, k))(jax.random.PRNGKey(0))
    return cj, ct, pj, from_jax_params(to_numpy(pj), ct, "cpu")


@pytest.fixture(scope="module")
def vehicles():
    return {name: _vehicle(name) for name in ("qwen3", "mla")}


def _pin_splits(cj, rows):
    """Give the port the reference's split count for the paged decode."""
    if cj.mla is not None:
        d, h = cj.mla.kv_lora_rank + cj.mla.qk_rope_head_dim, cj.n_heads
    else:
        d, h = cj.resolved_head_dim, cj.n_heads
    autotune.record(PAGE, h, d, jautotune.best_n_splits(PAGE, h, d,
                                                        rows=rows), rows=rows)


def _clone(cache):
    return TM.ModelCache(tuple(type(lc)(*(t.clone() for t in lc))
                               for lc in cache.layers), cache.lengths.clone())


@pytest.mark.parametrize("name", ["qwen3", "mla"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_verify_step_columns_equal_sequential_decode(vehicles, name, paged):
    """Two rows prefilled with 13 and 5 tokens, then a chain of 5 tokens.
    The first row's chain overhangs a 16-token cache (dense: writes past
    the row drop; paged: they land on the trash page), so only its
    in-range columns are compared; the dense cache after the verify
    equals the reference's, whose writes drop likewise."""
    cj, ct, pj, pt = vehicles[name]
    rng = np.random.default_rng(12)
    tok = np.zeros((2, 16), np.int32)
    tok[0, :13] = rng.integers(0, cj.vocab_size, 13)
    tok[1, :5] = rng.integers(0, cj.vocab_size, 5)
    lens = np.array([13, 5], np.int32)
    chain = rng.integers(0, cj.vocab_size, (2, K + 1)).astype(np.int32)
    max_len = 16
    for rows in (2, 2 * (K + 1)):
        _pin_splits(cj, rows)
    if paged:
        pages = np.array([[1, 2], [3, 4]], np.int32)
        cache_j = JM.set_page_rows(JM.init_paged_cache(
            cj, 2, max_len, page_size=PAGE, num_pages=5), np.arange(2), pages)
        cache_t = TM.set_page_rows(TM.init_paged_cache(
            ct, 2, max_len, page_size=PAGE, num_pages=5, device="cpu"),
            np.arange(2), pages)
        _, cache_j = JM.prefill_into_pages(
            pj, {"tokens": jnp.asarray(tok)}, cj, cache_j, jnp.asarray(lens),
            jnp.zeros(2, jnp.int32), jnp.arange(2))
        _, cache_t = TM.prefill_into_pages(
            pt, torch.from_numpy(tok), ct, cache_t, torch.from_numpy(lens),
            torch.zeros(2, dtype=torch.int32), np.arange(2))
    else:
        cache_j = JM.init_cache(cj, 2, max_len)
        cache_t = TM.init_cache(ct, 2, max_len, "cpu")
        _, cache_j = JM.prefill_into_slots(
            pj, {"tokens": jnp.asarray(tok)}, cj, cache_j, jnp.asarray(lens),
            jnp.arange(2), max_len=max_len)
        _, cache_t = TM.prefill_into_slots(
            pt, torch.from_numpy(tok), ct, cache_t, torch.from_numpy(lens),
            np.arange(2), max_len=max_len)
    cap = max_len if paged else None
    seq, seq_cache = [], _clone(cache_t)
    for j in range(K + 1):
        lg, seq_cache = TM.decode_step(pt, seq_cache,
                                       torch.from_numpy(chain[:, j:j + 1]),
                                       ct, kv_cap=cap)
        seq.append(lg[:, 0])
    got, after = TM.verify_step(pt, cache_t, torch.from_numpy(chain), ct,
                                kv_cap=cap)
    want, after_j = jax.jit(lambda p, c, x: JM.verify_step(p, c, x, cj,
                                                           kv_cap=cap))(
        pj, cache_j, jnp.asarray(chain))
    assert got.shape == (2, K + 1, cj.vocab_size)
    assert np.array_equal(after.lengths.numpy(), lens + K + 1)
    live = [(b, j) for b in range(2) for j in range(K + 1)
            if lens[b] + j < max_len]
    for b, j in live:
        scale = float(seq[j][b].abs().max())
        assert int(got[b, j].argmax()) == int(seq[j][b].argmax())
        assert float((got[b, j] - seq[j][b]).abs().max()) <= \
            SEQ_TOL * scale, (b, j)
        rep = tolerance_report(got[b, j].numpy(), np.asarray(want)[b, j])
        assert rep["max_abs"] <= LOGIT_TOL * scale, (b, j, rep)
    if not paged:
        ref = from_jax_cache(jax.tree.map(np.asarray, after_j), "cpu")
        for lc, lr in zip(after.layers, ref.layers):
            for a, w in zip(lc, lr):
                rep = tolerance_report(a.numpy(), w.numpy())
                assert rep["max_abs"] <= LOGIT_TOL * float(w.abs().max())


# ---------------------------------------------------------------------------
# The speculative engine.
# ---------------------------------------------------------------------------


def _motif_stream(vocab, n=3, seed=3, max_new=10, tail=2):
    """tests/test_spec.py's motif-tiled prompts (3 or 4 tiles of an 8-token
    motif and a ``tail`` of random tokens): repetition the ngram draft can
    extend."""
    rng = np.random.default_rng(seed)
    motif = rng.integers(0, vocab, 8).astype(np.int32)
    return [(np.concatenate([np.tile(motif, 3 + u % 2),
                             rng.integers(0, vocab, tail).astype(np.int32)]),
             max_new) for u in range(n)]


def drain(eng, req_cls, stream):
    for uid, (prompt, max_new) in enumerate(stream):
        eng.submit(req_cls(uid=uid, prompt=prompt.copy(),
                           max_new_tokens=max_new))
    return {f.uid: [int(t) for t in f.tokens]
            for f in eng.run_until_drained()}


RUNS = {f"{name}-{'paged' if paged else 'dense'}": (name, paged)
        for name in ("qwen3", "mla") for paged in (False, True)}
STAT_KEYS = ("steps", "host_transfers", "new_tokens", "spec_proposed",
             "spec_accepted")


@pytest.fixture(scope="module")
def reference_drains(vehicles):
    out = {}
    for run, (name, paged) in RUNS.items():
        cj, _, pj, _ = vehicles[name]
        stream = _motif_stream(cj.vocab_size)
        eng = JEngine(pj, cj, slots=SLOTS, max_len=MAX_LEN, paged=paged,
                      page_size=PAGE, spec=jspec.SpecConfig(k=K),
                      track_energy=False)
        out[run] = (stream, drain(eng, JRequest, stream), eng.stats())
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_spec_engine_matches_reference_and_spec_off(vehicles,
                                                    reference_drains, run):
    name, paged = RUNS[run]
    cj, ct, _, pt = vehicles[name]
    stream, want, want_stats = reference_drains[run]
    for rows in (SLOTS, SLOTS * (K + 1)):
        _pin_splits(cj, rows)
    kw = dict(slots=SLOTS, max_len=MAX_LEN, paged=paged, page_size=PAGE,
              device="cpu")
    eng = Engine(pt, ct, spec=spec.SpecConfig(k=K), **kw)
    got = drain(eng, Request, stream)
    assert got == want
    assert drain(Engine(pt, ct, **kw), Request, stream) == got  # spec off
    st = eng.stats()
    assert {k: st[k] for k in STAT_KEYS} == \
        {k: float(want_stats[k]) for k in STAT_KEYS}
    assert st["spec_accepted"] > 0 and st["spec_tokens_per_step"] > 1.0
    if paged:
        assert eng.pool.conserved()
        assert not eng.state.cache.layers[0].pt.any()  # all-trash tables


def test_stats_match_reference_engine(vehicles, reference_drains):
    """The paged spec drain's ``stats()``: the reference engine's keys and
    every value that is not a wall-clock time, the draft and compile
    counters included."""
    cj, ct, _, pt = vehicles["qwen3"]
    stream, want, want_stats = reference_drains["qwen3-paged"]
    for rows in (SLOTS, SLOTS * (K + 1)):
        _pin_splits(cj, rows)
    eng = Engine(pt, ct, spec=spec.SpecConfig(k=K), slots=SLOTS,
                 max_len=MAX_LEN, paged=True, page_size=PAGE, device="cpu")
    assert drain(eng, Request, stream) == want
    hold_stats(eng.stats(), want_stats)
    assert eng.stats()["spec_accepted"] > 0


def test_self_draft_accepts_every_chain(vehicles):
    """The target as its own draft proposes exactly what the verify
    accepts (max_new 13: 12 decoded tokens, 3 whole chains of 4)."""
    _, ct, _, pt = vehicles["mla"]
    stream = _motif_stream(ct.vocab_size, max_new=13)
    kw = dict(slots=SLOTS, max_len=MAX_LEN, device="cpu")
    base = drain(Engine(pt, ct, **kw), Request, stream)
    eng = Engine(pt, ct, spec=spec.SpecConfig(
        k=3, draft="model", draft_params=pt, draft_cfg=ct), **kw)
    assert drain(eng, Request, stream) == base
    assert eng.stats()["spec_accept_rate"] == 1.0


def test_scratch_page_churn_conserves_pool(vehicles):
    """max_new 2 with K = 4 and prompts of 8n + 6 tokens: every verify
    overhangs the admission's reservation into the next page, so scratch
    pages are attached and released every step; the pool is conserved at
    every step and after."""
    _, ct, _, pt = vehicles["qwen3"]
    eng = Engine(pt, ct, slots=SLOTS, max_len=MAX_LEN, paged=True,
                 page_size=PAGE, spec=spec.SpecConfig(k=K), device="cpu")
    attach = eng._attach_scratch_pages
    attached = []
    eng._attach_scratch_pages = lambda: attached.append(attach()) or \
        attached[-1]
    for uid, (p, _) in enumerate(_motif_stream(ct.vocab_size, n=5, tail=6)):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=2))
    while eng.active or eng.queue:
        eng.step()
        assert eng.pool.conserved()
    assert all(attached) and eng.stats()["spec_proposed"] > 0
    assert eng.pool.pages_in_use == eng.radix.evictable_pages()
    assert not eng.state.cache.layers[0].pt.any()


def test_spec_rejects_tempered_requests(vehicles):
    _, ct, _, pt = vehicles["qwen3"]
    eng = Engine(pt, ct, slots=SLOTS, max_len=MAX_LEN,
                 spec=spec.SpecConfig(k=2), device="cpu")
    with pytest.raises(ValueError, match="greedy-only"):
        eng.submit(Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                           max_new_tokens=2, temperature=0.7))
