"""Port parity of MLA serving (deepseek-v3's dense layers): the K5 plain
version, ``models/mla.py`` through the model's steps, and the engine.

- K5 (``kernels/paged_attn.paged_decode_mla``): on the CPU the wrapper runs
  its plain version, held against the reference's ``use_pallas=False``
  path (``_mla_ref``) at seven shapes and against its Pallas kernel in
  interpret mode at two: length-0 rows, trash entries past each row's
  extent, a one-page table, H = 1 (the gemv trap of DESIGN.md §9), bf16
  and f32 pools, 1 to 8 splits; and a covering table prefix. Tolerance
  1e-6 of max(1, |ref|): the reference sums in float32, the port in
  float64 rounded once (so its kernel matches it bitwise on the card).
- Vehicles: reduced deepseek-v3 with both layers dense
  (``first_k_dense=2``, ``dense_d_ff=256``; TimeFloats ``mode="pallas"``)
  and the reference tests' ``mla_cfg()`` (the dense family with MLA,
  ``quant="none"``), both at f32 activations, parameters carried over by
  convert.py. Logits within 2e-3 of the logit scale, the tolerance and
  reasons of tests/test_torch_model.py: the expanded forward, and an
  absorbed prefill + decode step on the dense slot cache and on the paged
  pool (K5), each also from the reference's own cache carried over by
  ``from_jax_cache`` / ``from_jax_paged_cache``; the caches' latents within
  the same tolerance, tables and lengths exactly.
- Engine: greedy drains of a prefix-sharing stream on reduced deepseek-v3,
  dense and paged, whose streams, steps and paged stats equal the JAX
  engine's. The drains run the vehicle's parameters at ``quant="none"``:
  they test the engine's MLA caches, tables and radix reuse, the steps
  above hold the TimeFloats arithmetic, and the reference engine compiles
  a TimeFloats step about five times slower.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import tolerance_report, to_numpy  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.core.timefloats import TFConfig as JTF  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels.paged_attn import \
    paged_decode_mla as jpaged_decode_mla  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.request import Request as JRequest  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.convert import (from_jax_cache,  # noqa: E402
                                 from_jax_paged_cache, from_jax_params)
from repro_torch.core.timefloats import TFConfig  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import paged_attn as kpa  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402

K5_TOL = 1e-6
LOGIT_TOL = 2e-3
PAGE = 8

# ---------------------------------------------------------------------------
# K5 plain version.
# ---------------------------------------------------------------------------

MLA_CASES = [
    # (b, t, page, h, c, r, pool dtype, n_splits, also interpret Pallas)
    (2, 4, 8, 4, 32, 16, "float32", 2, True),
    (3, 2, 16, 1, 64, 16, "bfloat16", 1, True),   # H = 1
    (2, 8, 4, 8, 16, 8, "bfloat16", 8, False),    # max splits
    (1, 1, 4, 2, 8, 8, "float32", 1, False),      # single-page table
    (4, 4, 8, 16, 32, 16, "bfloat16", 4, False),  # the reduced deepseek heads
    (3, 4, 8, 1, 32, 8, "float32", 2, False),     # H = 1, f32 pools
    (2, 2, 16, 4, 16, 16, "bfloat16", 2, False),  # mla_cfg's latent width
]


def _torch(a) -> "torch.Tensor":
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _mla_case(rng, b, t, page, h, c, r, dtype):
    """tests/test_paged_attn.py's construction: contiguous page runs,
    trash entries past each row's extent, a length-0 row and a single-page
    row; q_rope in bf16 as ``rope`` returns it. Returns JAX operands."""
    n_pages = b * t + 2
    q_lat = jnp.asarray(rng.standard_normal((b, h, c)), jnp.float32)
    q_rope = jnp.asarray(rng.standard_normal((b, h, r)), jnp.bfloat16)
    cp = jnp.asarray(rng.standard_normal((n_pages, page, c)), dtype)
    rp = jnp.asarray(rng.standard_normal((n_pages, page, r)), dtype)
    lens = rng.integers(0, t * page + 1, b)
    lens[0] = 0
    if b > 1:
        lens[1] = min(page, t * page)
    pt = np.zeros((b, t), np.int32)
    ids = rng.permutation(np.arange(1, n_pages))[: b * t]
    pt.flat[: len(ids)] = ids
    for i in range(b):
        pt[i, (lens[i] + page - 1) // page:] = 0
    return q_lat, q_rope, cp, rp, jnp.asarray(pt), jnp.asarray(lens,
                                                              jnp.int32)


@pytest.mark.parametrize("seed,case", list(enumerate(MLA_CASES)))
def test_plain_k5_matches_reference_and_interpret_kernel(seed, case):
    b, t, page, h, c, r, dtype, ns, interp = case
    ops = _mla_case(np.random.default_rng(seed), b, t, page, h, c, r, dtype)
    scale = 1.0 / np.sqrt(c // 2 + r)
    got = kpa.paged_decode_mla(*(_torch(a) for a in ops), scale=scale,
                               n_splits=ns).numpy()
    refs = [("reference", jpaged_decode_mla(*ops, scale=scale, n_splits=ns,
                                            use_pallas=False))]
    if interp:
        refs.append(("interpret kernel", jpaged_decode_mla(
            *ops, scale=scale, n_splits=ns, use_pallas=True,
            interpret=True)))
    for label, ref in refs:
        ref = np.asarray(ref)
        rep = tolerance_report(got, ref)
        assert rep["max_abs"] <= K5_TOL * max(1.0, np.abs(ref).max()), \
            f"{case} vs {label}: {rep}"
    assert np.all(got[np.asarray(ops[-1]) == 0] == 0.0)
    assert kpa.paged_decode_mla.launches == 0  # CPU: plain version


def test_k5_covering_prefix_is_neutral_and_scale_is_required():
    ops = [_torch(a) for a in _mla_case(np.random.default_rng(9), 2, 8, 4,
                                        4, 16, 8, "float32")]
    ops[-1] = ops[-1].clamp_max(4 * 4)  # every row fits 4 of 8 pages
    full = kpa.paged_decode_mla(*ops, scale=0.25, n_splits=1)
    ops[4] = ops[4][:, :4]
    capped = kpa.paged_decode_mla(*ops, scale=0.25, n_splits=1)
    assert torch.equal(full, capped)
    with pytest.raises(TypeError):
        kpa.paged_decode_mla(*ops)  # scale has no default


# ---------------------------------------------------------------------------
# Configurations.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", ["MoEConfig", "MLAConfig", "ModelConfig"])
def test_config_schema_matches_reference(cls):
    fields = [(f.name, f.default) for f in
              dataclasses.fields(getattr(jbase, cls))]
    port = [(f.name, f.default) for f in
            dataclasses.fields(getattr(tbase, cls))]
    assert [n for n, _ in port] == [n for n, _ in fields]
    if cls != "ModelConfig":  # its tf default is a port-side TFConfig
        assert port == fields


def test_deepseek_config_and_dense_cut_match_reference():
    cj, ct = jget_config("deepseek-v3-671b"), get_config("deepseek-v3-671b")
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                 "d_ff", "vocab_size", "tie_embeddings", "family"):
        assert getattr(ct, name) == getattr(cj, name), name
    assert dataclasses.asdict(ct.mla) == dataclasses.asdict(cj.mla)
    assert dataclasses.asdict(ct.moe) == dataclasses.asdict(cj.moe)
    cut = get_config("deepseek-v3-671b", n_layers=3)
    assert cut.layer_kinds() == ("dense",) * 3 == \
        jget_config("deepseek-v3-671b", n_layers=3).layer_kinds()
    assert TM.paged_supported(cut) and TM.paged_supported(ct)
    moe_cut = get_config("deepseek-v3-671b", n_layers=4)
    assert moe_cut.layer_kinds() == ("dense",) * 3 + ("moe",) == \
        jget_config("deepseek-v3-671b", n_layers=4).layer_kinds()
    assert "router" in TM.model_param_specs(moe_cut)["layers"][3]["ffn"]


# ---------------------------------------------------------------------------
# The model's steps on the two vehicles.
# ---------------------------------------------------------------------------


def _vehicle(name):
    if name == "deepseek":
        def cut(cfg, base, tf):
            return dataclasses.replace(
                base(cfg), n_layers=2, tf=tf, dtype="float32",
                moe=dataclasses.replace(base(cfg).moe, first_k_dense=2,
                                        dense_d_ff=256))
        cj = cut(jget_config("deepseek-v3-671b"), jreduced, JTF(mode="pallas"))
        ct = cut(get_config("deepseek-v3-671b"), reduced_for_smoke,
                 TFConfig(mode="pallas"))
    else:  # tests/test_paged.py's mla_cfg(): dense family with MLA
        def cut(cfg, base, mla_cls):
            return dataclasses.replace(
                base(cfg), quant="none", n_layers=2, dtype="float32",
                mla=mla_cls(q_lora_rank=32, kv_lora_rank=16,
                            qk_nope_head_dim=16, qk_rope_head_dim=8,
                            v_head_dim=16))
        cj = cut(jget_config("qwen3-0.6b"), jreduced, jbase.MLAConfig)
        ct = cut(get_config("qwen3-0.6b"), reduced_for_smoke,
                 tbase.MLAConfig)
    pj = jax.jit(lambda k: JM.init(cj, k))(jax.random.PRNGKey(1))
    return cj, ct, pj, from_jax_params(to_numpy(pj), ct, "cpu")


VEHICLES = ("deepseek", "mla_cfg")


@pytest.fixture(scope="module")
def vehicles():
    return {name: _vehicle(name) for name in VEHICLES}


def _close(got, want, label):
    got, want = np.asarray(got), np.asarray(want)
    rep = tolerance_report(got, want)
    scale = float(np.abs(want).max())
    assert rep["max_abs"] <= LOGIT_TOL * max(scale, 1e-30), f"{label}: {rep}"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", VEHICLES)
def test_forward_logits_within_tolerance(vehicles, name):
    cj, ct, pj, pt = vehicles[name]
    tok = np.random.default_rng(2).integers(0, cj.vocab_size, (2, 24))
    want, _ = jax.jit(lambda p, x: JM.forward(p, {"tokens": x}, cj,
                                              train=False))(
        pj, jnp.asarray(tok, jnp.int32))
    got, _ = TM.forward(pt, {"tokens": torch.from_numpy(tok)}, ct,
                        train=False)
    _close(got.numpy(), want, f"{name} forward logits")


def _pin_splits(cj, rows):
    m = cj.mla
    d = m.kv_lora_rank + m.qk_rope_head_dim
    ns = jautotune.best_n_splits(PAGE, cj.n_heads, d, rows=rows)
    autotune.record(PAGE, cj.n_heads, d, ns, rows=rows)


@pytest.mark.parametrize("name", VEHICLES)
def test_absorbed_prefill_and_decode_dense_and_paged(vehicles, name):
    """A ragged prefill of two prompts (and a dummy row), then one decode
    step, on the dense slot cache and on the paged pool (K5 plain)."""
    cj, ct, pj, pt = vehicles[name]
    b, max_len = 3, 32
    rng = np.random.default_rng(4)
    tok = rng.integers(0, cj.vocab_size, (b, 16)).astype(np.int32)
    lens = np.array([16, 11, 0], np.int32)
    step = rng.integers(0, cj.vocab_size, (b, 1)).astype(np.int32)
    _pin_splits(cj, rows=b)

    # Dense slot cache.
    cj0 = JM.init_cache(cj, b, max_len)
    lj, cj1 = jax.jit(lambda p, c: JM.prefill(
        p, {"tokens": jnp.asarray(tok)}, cj, c,
        lengths=jnp.asarray(lens)))(pj, cj0)
    lt, ct1 = TM.prefill(pt, torch.from_numpy(tok), ct,
                         TM.init_cache(ct, b, max_len, "cpu"),
                         lengths=torch.from_numpy(lens))
    _close(lt[:2].numpy(), np.asarray(lj)[:2], f"{name} prefill logits")
    from_ref = from_jax_cache(_np_tree(cj1), "cpu")
    for mine, ref in zip(ct1.layers, from_ref.layers):
        for f in mine._fields:
            _close(getattr(mine, f)[:2].numpy(), getattr(ref, f)[:2].numpy(),
                   f"{name} dense {f}")
    dj, _ = jax.jit(lambda p, c, x: JM.decode_step(p, c, x, cj))(
        pj, cj1, jnp.asarray(step))
    for label, cache in (("port", ct1), ("reference cache", from_ref)):
        dt, _ = TM.decode_step(pt, cache, torch.from_numpy(step), ct)
        _close(dt[:2].numpy(), np.asarray(dj)[:2], f"{name} decode {label}")

    # Paged pool: rows 0 and 1 own pages 1-2 and 3-4; row 2 is idle.
    rows = np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    pj0 = JM.set_page_rows(JM.init_paged_cache(cj, b, max_len,
                                               page_size=PAGE, num_pages=9),
                           np.array([0, 1]), rows)
    pt0 = TM.set_page_rows(TM.init_paged_cache(ct, b, max_len,
                                               page_size=PAGE, num_pages=9,
                                               device="cpu"),
                           np.array([0, 1]), rows)
    ids, offs = np.array([0, 1, 3], np.int32), np.zeros(b, np.int32)
    lj, pj1 = jax.jit(lambda p, c: JM.prefill_into_pages(
        p, {"tokens": jnp.asarray(tok)}, cj, c, jnp.asarray(lens),
        jnp.asarray(offs), jnp.asarray(ids)))(pj, pj0)
    lt, pt1 = TM.prefill_into_pages(pt, torch.from_numpy(tok), ct, pt0,
                                    torch.from_numpy(lens),
                                    torch.from_numpy(offs), ids)
    _close(lt[:2].numpy(), np.asarray(lj)[:2], f"{name} paged prefill")
    from_ref = from_jax_paged_cache(_np_tree(pj1), "cpu")
    assert np.array_equal(from_ref.layers[0].pt.numpy(), pt1.layers[0].pt)
    assert np.array_equal(from_ref.lengths.numpy(), pt1.lengths.numpy())
    for mine, ref in zip(pt1.layers, from_ref.layers):
        for f in ("c_kv", "k_rope"):
            _close(getattr(mine, f)[1:5].numpy(),
                   getattr(ref, f)[1:5].numpy(), f"{name} paged {f}")
    dj, _ = jax.jit(lambda p, c, x: JM.decode_step(p, c, x, cj, kv_cap=16))(
        pj, pj1, jnp.asarray(step))
    for label, cache in (("port", pt1), ("reference cache", from_ref)):
        before = kpa.paged_decode_mla.launches
        dt, _ = TM.decode_step(pt, cache, torch.from_numpy(step), ct,
                               kv_cap=16)
        assert kpa.paged_decode_mla.launches == before  # plain on the CPU
        _close(dt[:2].numpy(), np.asarray(dj)[:2],
               f"{name} paged decode {label}")


# ---------------------------------------------------------------------------
# The engine on reduced deepseek-v3.
# ---------------------------------------------------------------------------

SLOTS, MAX_LEN = 2, 48
STAT_KEYS = ("steps", "host_transfers", "radix_hits", "radix_hit_rate",
             "radix_nodes", "radix_evictions", "pool_pages_total",
             "pool_pages_in_use", "pool_pages_free")


def _stream(vocab):
    """Four greedy requests sharing a 16-token prefix (two pages), each
    plus 2 + uid fresh tokens."""
    rng = np.random.default_rng(6)
    shared = rng.integers(0, vocab, 16).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, vocab, 2 + u)
                            .astype(np.int32)]) for u in range(4)]


def _drain(eng, req_cls, prompts):
    for uid, p in enumerate(prompts):
        eng.submit(req_cls(uid=uid, prompt=p.copy(), max_new_tokens=4))
    return {f.uid: [int(t) for t in f.tokens]
            for f in eng.run_until_drained()}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_deepseek_engine_matches_reference_engine(vehicles, paged):
    cj, ct, pj, pt = vehicles["deepseek"]
    cj = dataclasses.replace(cj, quant="none")
    ct = dataclasses.replace(ct, quant="none")
    prompts = _stream(cj.vocab_size)
    kw = dict(slots=SLOTS, max_len=MAX_LEN, paged=paged, page_size=PAGE)
    _pin_splits(cj, rows=SLOTS)
    jeng = JEngine(pj, cj, track_energy=False, **kw)
    want = _drain(jeng, JRequest, prompts)
    eng = Engine(pt, ct, device="cpu", **kw)
    assert _drain(eng, Request, prompts) == want
    st, jst = eng.stats(), jeng.stats()
    keys = STAT_KEYS if paged else STAT_KEYS[:2]
    assert {k: st[k] for k in keys} == {k: float(jst[k]) for k in keys}
    if paged:
        assert st["radix_hits"] > 0 and eng.pool.conserved()
        assert not eng.state.cache.layers[0].pt.any()  # all-trash tables
