"""Port parity of the MoE layers (``models/moe.py``) against the JAX
reference on the CPU, at ``reduced_for_smoke`` shapes (8 experts, top-2,
expert width 64).

- Routing and dispatch: ``capacity``, ``capacity_dynamic`` (against the
  jitted reference, which multiplies by the f32 reciprocal of E) and
  ``dispatch_indices`` bitwise, with the sentinel expert, ``cap_eff`` and
  drops forced by a small ``capacity_factor``; ``route``'s expert indices
  bitwise on logits with exact ties (the lower index first), its weights
  and losses within 1e-6 relative (f32 softmax and means summed in another
  order).
- The experts' TimeFloats operands: ``prepare_input_experts`` /
  ``prepare_weight_experts`` / the weight cache's ``expert`` rule bitwise
  against per-expert ``prepare_*`` calls and the reference's vmapped
  ``prepare_weight``, also when the stack is quantized in groups and
  slabs; K1's expert plain version and CPU wrapper bitwise against the
  2-D plain version per expert.
- Router logits: the port sums them in float64 and rounds once, so they
  are bitwise the same in any batch of rows, and within 1e-6 of the
  reference's f32 product.
- ``moe_apply`` against the reference's, both from the reference's router
  logits (an ulp of a logit moves a routing weight by an ulp, and a
  combine product by a bf16 ulp): bitwise at bf16 activations, within
  1e-5 of the output scale at f32 (XLA's and torch's f32 products sum in
  other orders); at quant "none" and TimeFloats, with ``token_mask``,
  ``drop_free`` and ``dispatch_chunk``; ``moe_apply_reference`` likewise.
  The reference is compiled without XLA's excess precision
  (``xla_allow_excess_precision=False``), so that each of its bf16 ops
  rounds as it does run op by op, as the port's do; the combine adds in
  the reference's sorted-assignment order on both sides.
- Models: reduced deepseek-v3 (MLA + MoE, TimeFloats ``separable``) and
  kimi-k2 (GQA + MoE, quant "none"), one dense and one MoE layer, f32:
  loss within 1e-3 relative, the MoE losses and dropped share within 1e-5,
  gradients at cosine >= 0.99999 per leaf, against the jitted reference;
  the train step's metric vector carries the MoE terms; ``remat="dots"``
  bitwise against ``"full"`` and ``"none"`` with fewer quantizer calls
  than ``"full"``.
- Engines (``quant="none"``): greedy streams equal to the JAX engine's,
  on the dense slot cache, and paged with chunked prefill and speculative
  decoding together (radix hits, chunk waves, drop-free verifies).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import assert_bitwise, tolerance_report, to_numpy  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.core import timefloats as jtf  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.request import Request as JRequest  # noqa: E402
from repro.serve.spec import SpecConfig as JSpec  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.convert import _tensor, from_jax_params  # noqa: E402
from repro_torch.core import timefloats as ttf  # noqa: E402
from repro_torch.kernels import timefloats_matmul as km  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402
from repro_torch.serve.spec import SpecConfig  # noqa: E402

ARCHS = ("deepseek-v3-671b", "kimi-k2-1t-a32b")
F32_TOL = 1e-5          # of the output scale, f32 activations
ROUTE_RTOL = 1e-6
LOSS_RTOL = 1e-3
AUX_RTOL = 1e-5
GRAD_COSINE = 0.99999


def _cfgs(arch="deepseek-v3-671b", *, mode="separable", **kw):
    """(reference, port) reduced configs: one dense and one MoE layer."""
    moe_kw = kw.pop("moe", {})
    out = []
    for get, red, tf in ((jget_config, jreduced, jtf.TFConfig),
                         (get_config, reduced_for_smoke, ttf.TFConfig)):
        cfg = red(get(arch))
        out.append(dataclasses.replace(
            cfg, n_layers=2, tf=tf(mode=mode), **kw,
            moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return tuple(out)


def _moe_params(cj, seed=1):
    """One MoE layer's parameters from the reference's init, and the
    port's copy."""
    pj = jcommon.init_params(jmoe.moe_specs(cj), jax.random.PRNGKey(seed))
    return pj, {k: _tensor(v, "cpu") for k, v in to_numpy(pj).items()}


def _compiled(fn, *args):
    """``fn(*args)`` jitted without XLA's excess precision: every bf16 op
    rounds, as the reference's ops do one by one."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(got, want, tol, label):
    got, want = _f32(got), _f32(want)
    rep = tolerance_report(got, want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert rep["max_abs"] <= tol * scale, f"{label}: {rep}"


# ---------------------------------------------------------------------------
# Configuration, capacity, routing and dispatch.
# ---------------------------------------------------------------------------


def test_kimi_config_matches_reference():
    cj, ct = jget_config("kimi-k2-1t-a32b"), get_config("kimi-k2-1t-a32b")
    for f in dataclasses.fields(ct):
        if f.name not in ("tf", "moe"):
            assert getattr(ct, f.name) == getattr(cj, f.name), f.name
    assert dataclasses.asdict(ct.moe) == dataclasses.asdict(cj.moe)
    assert ct.layer_kinds() == cj.layer_kinds()
    assert TM.paged_supported(ct)
    specs = TM.model_param_specs(dataclasses.replace(ct, n_layers=2))
    assert [sorted(lp["ffn"]) for lp in specs["layers"]] == [
        ["w_down", "w_gate", "w_up"],
        ["router", "shared_wd", "shared_wg", "shared_wu", "wd", "wg", "wu"]]


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_reference(arch):
    cj, ct = _cfgs(arch)
    full_j, full_t = jget_config(arch), get_config(arch)
    counts = np.array([0, 1, 4, 7, 20, 32, 96, 192, 256, 1000, 4096],
                      np.int32)
    dyn = jax.jit(lambda n, c=cj: jmoe.capacity_dynamic(n, c))
    dyn_full = jax.jit(lambda n: jmoe.capacity_dynamic(n, full_j))
    for n in counts:
        assert tmoe.capacity(int(n), ct) == jmoe.capacity(int(n), cj)
        assert tmoe.capacity(int(n), full_t) == jmoe.capacity(int(n), full_j)
        for c_t, f in ((ct, dyn), (full_t, dyn_full)):
            got = tmoe.capacity_dynamic(torch.tensor(int(n)), c_t)
            assert got.dtype == torch.int32
            assert int(got) == int(f(jnp.int32(n))), (arch, n)


DISPATCH_CASES = {
    # (tokens, E, k, cap, sentinel share, cap_eff)
    "drops": (24, 8, 2, 8, 0.0, None),
    "sentinel_cap_eff": (32, 8, 2, 16, 0.3, 8),
    "drop_free": (20, 8, 4, 20, 0.0, None),
    "wide": (40, 16, 4, 8, 0.2, 16),
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatch_indices_bitwise(case):
    t, e, k, cap, pad, cap_eff = DISPATCH_CASES[case]
    rng = np.random.default_rng(len(case))
    idx = np.stack([rng.choice(e, k, replace=False) for _ in range(t)]
                   ).astype(np.int32)
    idx[:, 0] = rng.integers(0, 2, t)          # crowd two experts
    idx[:, 0] = np.where(idx[:, 0] == idx[:, 1], (idx[:, 1] + 1) % e,
                         idx[:, 0])
    idx[rng.random(t) < pad] = e                # pad tokens: the sentinel
    ce = None if cap_eff is None else np.int32(cap_eff)
    want = jax.jit(lambda i, c: jmoe.dispatch_indices(
        i, t, cap, e, cap_eff=c))(jnp.asarray(idx),
                                  None if ce is None else jnp.asarray(ce))
    got = tmoe.dispatch_indices(
        torch.from_numpy(idx), t, cap, e,
        cap_eff=None if ce is None else torch.tensor(cap_eff,
                                                     dtype=torch.int32))
    for name, g, w in zip(("slot", "order", "keep"), got, want):
        assert_bitwise(g.numpy().astype(np.asarray(w).dtype), np.asarray(w),
                       f"{case} {name}")
    assert case == "drop_free" or not bool(got[2].all())


def test_route_matches_reference():
    """Indices bitwise, ties to the lower expert index; weights and losses
    within 1e-6 relative."""
    cj, ct = _cfgs(moe=dict(num_experts=16, top_k=4))
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((24, 16)).astype(np.float32)
    logits[0, [3, 9, 12]] = 5.0                 # a three-way tie at the top
    logits[1, :] = 0.25                         # every expert tied
    logits[2, [1, 2, 14, 15]] = -1.0            # a tie at the k-th place
    logits[2, [0, 3, 4]] = 2.0
    wj, ij, aj = jax.jit(lambda x: jmoe.route(x, cj))(jnp.asarray(logits))
    wt, it, at = tmoe.route(torch.from_numpy(logits), ct)
    assert_bitwise(it.numpy().astype(np.int32), np.asarray(ij), "idx")
    assert it[0, :3].tolist() == [3, 9, 12] and it[1].tolist() == [0, 1, 2, 3]
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=ROUTE_RTOL)
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(at[key]), float(aj[key]),
                                   rtol=ROUTE_RTOL, err_msg=key)


# ---------------------------------------------------------------------------
# The experts' TimeFloats operands and K1 over experts.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_operands_bitwise_per_expert(dtype, monkeypatch):
    """Stacked prepare calls equal per-expert ones and the reference's
    vmapped prepare_weight, whole and in groups of 2 experts / column slabs
    (``QUANT_SLAB_ELEMS`` made small)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((5, 8, 200)) * 3.0).astype(np.float32)
    x[1] = 0.0                                  # an expert with no tokens
    x[2, 3:] = 0.0
    w = (rng.standard_normal((5, 200, 96)) * 0.05).astype(np.float32)
    w[3] *= 2.0 ** -20                          # experts far apart in scale
    tdt = getattr(torch, dtype)
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    cfg_t, cfg_j = ttf.TFConfig(mode="separable"), jtf.TFConfig(
        mode="separable")
    jw = jax.jit(jax.vmap(lambda a: jtf.prepare_weight(a, cfg_j)))(
        jnp.asarray(w, dtype))
    jx = jax.jit(jax.vmap(lambda a: jtf.prepare_input(a, cfg_j)))(
        jnp.asarray(x, dtype))
    for slab in (ttf.QUANT_SLAB_ELEMS, 2 * 200 * 96, 5000):
        monkeypatch.setattr(ttf, "QUANT_SLAB_ELEMS", slab)
        pw = ttf.prepare_weight_stack(wt, cfg_t)
        px = ttf.prepare_input_experts(xt, cfg_t)
        for e in range(5):
            for got, want in ((pw, ttf.prepare_weight(wt[e], cfg_t)),
                              (px, ttf.prepare_input(xt[e], cfg_t))):
                for g, v in zip((got.scale[e], got.q.q[e], got.q.scale[e]),
                                (want.scale, want.q.q, want.q.scale)):
                    assert torch.equal(g, v), (slab, e)
        for got, ref in ((pw, jw), (px, jx)):
            for g, v in zip((got.scale, got.q.q, got.q.scale),
                            (ref.scale, ref.q.q, ref.q.scale)):
                assert_bitwise(g.numpy(), np.asarray(v), f"{dtype} {slab}")
        assert len(ttf.expert_groups(5, 200, 96)) == (
            1 if slab > 5 * 200 * 96 else 3 if slab == 2 * 200 * 96 else 5)
    # The weight cache's expert rule is the stacked prepare.
    entry = tcommon._prepare_by_rule(wt, "expert",
                                     dataclasses.replace(_cfgs()[1]))
    assert torch.equal(entry.q.q, pw.q.q) and torch.equal(entry.scale,
                                                          pw.scale)
    assert tcommon._leaf_rule(["layers", 1, "ffn", "wg"], 3,
                              torch.float32) == "expert"


def test_expert_linear_and_k1_over_experts_match_per_expert():
    """expert_linear equals linear expert by expert (outputs and
    gradients); K1's expert plain version and its wrapper on CPU tensors
    equal the 2-D plain version per expert; the wrapper checks shapes."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 8, 130)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((4, 130, 48)) * 0.1
                          ).astype(np.float32))
    for mode in ("separable", "pallas"):
        cfg = ttf.TFConfig(mode=mode)
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = ttf.expert_linear(xg, wg, None, cfg)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum(
            ).backward()
        for e in range(4):
            xe, we = x[e].clone().requires_grad_(), w[e].clone(
                ).requires_grad_()
            ye = ttf.linear(xe, we, cfg)
            assert torch.equal(y[e], ye), (mode, e)
            (ye * torch.linspace(-1, 1, y.numel()).reshape(y.shape)[e]
             ).sum().backward()
            assert torch.equal(xg.grad[e], xe.grad), (mode, e)
            assert torch.equal(wg.grad[e], we.grad), (mode, e)
    cfg = ttf.TFConfig(mode="pallas")
    px = ttf.prepare_input_experts(x, cfg)
    pw = ttf.prepare_weight_experts(w, cfg)
    before = km.timefloats_matmul_experts.launches
    got = km.timefloats_matmul_experts(px.q.q, px.q.scale, pw.q.q,
                                       pw.q.scale, cfg=cfg)
    assert km.timefloats_matmul_experts.launches == before  # plain on CPU
    for e in range(4):
        want = km.timefloats_matmul_plain(px.q.q[e], px.q.scale[e],
                                          pw.q.q[e], pw.q.scale[e], cfg)
        assert torch.equal(got[e], want)
    with pytest.raises(ValueError, match="same number of experts"):
        km.timefloats_matmul_experts(px.q.q, px.q.scale, pw.q.q[:3],
                                     pw.q.scale[:3], cfg=cfg)
    with pytest.raises(ValueError, match="need"):
        km.timefloats_matmul_experts(px.q.q[0], px.q.scale[0], pw.q.q[0],
                                     pw.q.scale[0], cfg=cfg)
    plan = km.k1_plan(8, 112, 2048, 132, experts=4)
    assert plan == km.K1Plan(0, 1)          # 4 experts x 64 tiles fill it
    assert km.k1_plan(8, 112, 2048, 132) == km.k1_plan(8, 112, 2048, 132, 1)


# ---------------------------------------------------------------------------
# moe_apply and moe_apply_reference.
# ---------------------------------------------------------------------------

APPLY_CASES = [
    # (activation dtype, quant, variant)
    ("bfloat16", "timefloats", "token_mask"),
    ("bfloat16", "timefloats", "drop_free"),
    ("bfloat16", "timefloats", "dispatch_chunk"),
    ("bfloat16", "none", "drops"),
    ("float32", "timefloats", "dispatch_chunk"),
    ("float32", "timefloats", "drop_free"),
    ("float32", "none", "token_mask"),
]


def _reference_logits(xf, router):
    """The reference's router product (XLA's f32 sums), for the port."""
    return torch.from_numpy(np.array(
        jnp.asarray(xf.to(torch.float32).numpy())
        @ jnp.asarray(router.to(torch.float32).numpy())))


def test_router_logits_row_invariant_and_close():
    """The float64 sums give every row the same logits in any batch, and
    stay within 1e-6 of the reference's f32 product."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((20, 512)).astype(np.float32))
    router = torch.from_numpy((rng.standard_normal((512, 64)) * 0.05
                               ).astype(np.float32))
    whole = tmoe.router_logits(x, router)
    rows = torch.cat([tmoe.router_logits(x[i:i + 4], router)
                      for i in range(0, 20, 4)])
    assert torch.equal(whole, rows) and whole.dtype == torch.float32
    _close(whole.numpy(), _reference_logits(x, router).numpy(), 1e-6,
           "router logits")


@pytest.mark.parametrize("dtype,quant,variant", APPLY_CASES)
def test_moe_apply_matches_reference(dtype, quant, variant, monkeypatch):
    """Against the reference, from the reference's router logits: bitwise
    at bf16, within 1e-5 of the output scale at f32; aux within 1e-5
    relative (dropped_frac exactly at bf16)."""
    monkeypatch.setattr(tmoe, "router_logits", _reference_logits)
    moe_kw = {"drops": dict(capacity_factor=0.5),
              "token_mask": dict(capacity_factor=0.5),
              "dispatch_chunk": dict(dispatch_chunk=16,
                                     capacity_factor=0.5)}.get(variant, {})
    cj, ct = _cfgs(dtype=dtype, quant=quant, moe=moe_kw)
    pj, pt = _moe_params(cj)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 16, cj.d_model)).astype(np.float32)
    mask = None
    if variant == "token_mask":
        mask = np.arange(16)[None, :] < np.array([16, 9, 0])[:, None]
    kw = dict(drop_free=variant == "drop_free")
    yj, aj = _compiled(
        lambda p, x, m: jmoe.moe_apply(p, x, cj, token_mask=m, **kw), pj,
        jnp.asarray(x, cj.activation_dtype),
        None if mask is None else jnp.asarray(mask))
    yt, at = tmoe.moe_apply(
        pt, torch.from_numpy(x).to(ct.activation_dtype), ct,
        token_mask=None if mask is None else torch.from_numpy(mask), **kw)
    assert yt.dtype == ct.activation_dtype and yt.shape == x.shape
    label = f"{dtype} {quant} {variant}"
    if dtype == "bfloat16":
        assert_bitwise(_f32(yt.float().numpy()), _f32(yj), label)
    else:
        _close(yt.numpy(), yj, F32_TOL, label)
    # The compiled reference takes a mean as a product by 1/n: 1 - mean
    # may miss 0 by an ulp of 1.
    assert abs(float(at["dropped_frac"]) - float(aj["dropped_frac"])) <= (
        2.0 ** -24), label
    if variant in ("drops", "dispatch_chunk", "token_mask"):
        assert float(at["dropped_frac"]) > 0, label
    if variant == "drop_free":
        assert float(at["dropped_frac"]) == 0.0
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(at[key]), float(aj[key]),
                                   rtol=AUX_RTOL, err_msg=f"{label} {key}")


@pytest.mark.parametrize("quant", ["none", "timefloats"])
def test_moe_apply_reference_matches(quant, monkeypatch):
    """The dense reference against the reference's, and the drop-free
    dispatch against the dense reference (f32)."""
    monkeypatch.setattr(tmoe, "router_logits", _reference_logits)
    cj, ct = _cfgs(dtype="float32", quant=quant)
    pj, pt = _moe_params(cj, seed=2)
    x = np.random.default_rng(13).standard_normal(
        (2, 8, cj.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: jmoe.moe_apply_reference(p, x, cj))(
        pj, jnp.asarray(x))
    got = tmoe.moe_apply_reference(pt, torch.from_numpy(x), ct)
    _close(got.numpy(), want, F32_TOL, f"{quant} moe_apply_reference")
    if quant == "none":   # every expert sees every token: no capacity
        dispatched, _ = tmoe.moe_apply(pt, torch.from_numpy(x), ct,
                                       drop_free=True)
        _close(dispatched.numpy(), got.numpy(), F32_TOL, "drop-free")


# ---------------------------------------------------------------------------
# Models: convert.py, loss, aux, gradients, the train step, remat="dots".
# ---------------------------------------------------------------------------


# The models' arithmetic: TimeFloats on deepseek-v3 (the reference compiles
# its gradient in ~18 s), plain on kimi-k2 (~2 s).
MODEL_QUANT = {"deepseek-v3-671b": "timefloats", "kimi-k2-1t-a32b": "none"}


@pytest.fixture(scope="module")
def models():
    """Per arch: (reference cfg, port cfg, reference params, numpy params,
    a batch, the reference's jitted loss, metrics and gradients)."""
    out = {}
    for arch in ARCHS:
        cj, ct = _cfgs(arch, dtype="float32", quant=MODEL_QUANT[arch])
        pj = jax.jit(lambda k, c=cj: JM.init(c, k))(jax.random.PRNGKey(1))
        rng = np.random.default_rng(2)
        tok = rng.integers(0, cj.vocab_size, (2, 16)).astype(np.int32)
        mask = np.ones(tok.shape, np.float32)
        mask[1, 12:] = 0.0
        batch = {"tokens": tok, "labels": np.roll(tok, -1, 1), "mask": mask}
        (_, mj), gj = jax.jit(jax.value_and_grad(
            lambda p, b, c=cj: JM.loss_fn(p, b, c), has_aux=True))(
            pj, jax.tree.map(jnp.asarray, batch))
        out[arch] = (cj, ct, pj, to_numpy(pj), batch,
                     {k: float(v) for k, v in mj.items()}, to_numpy(gj))
    return out


def _batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / max(float(a.norm() * b.norm()), 1e-300))


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_moe_trees(models, arch):
    cj, ct, _, npj, _, _, _ = models[arch]
    pt = from_jax_params(npj, ct, "cpu")
    assert ct.layer_kinds() == ("dense", "moe")
    moe_group = npj["groups"][1]["params"]["ffn"]
    for name in ("router", "wg", "wu", "wd", "shared_wg", "shared_wu",
                 "shared_wd"):
        assert_bitwise(pt["layers"][1]["ffn"][name].numpy(),
                       np.asarray(moe_group[name])[0], name)
    assert pt["layers"][1]["ffn"]["wg"].shape == (8, ct.d_model, 64)
    with pytest.raises(ValueError, match="layer kinds"):
        from_jax_params(npj, dataclasses.replace(
            ct, moe=dataclasses.replace(ct.moe, first_k_dense=2)), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_aux_and_grads_match_reference(models, arch):
    """Loss within 1e-3, MoE losses and dropped share within 1e-5, every
    leaf's gradient at cosine >= 0.99999 against the jitted reference."""
    cj, ct, _, npj, batch, mj, gj = models[arch]
    pt = from_jax_params(npj, ct, "cpu")
    leaves = tree_lib.leaves(pt)
    for t in leaves:
        t.requires_grad_(True)
    loss, mt = TM.loss_fn(pt, _batch(batch), ct)
    loss.backward()
    assert abs(loss.item() - mj["loss"]) <= LOSS_RTOL * abs(mj["loss"])
    for key in ("lb_loss", "z_loss", "dropped_frac"):
        np.testing.assert_allclose(mt[key].item(), mj[key], rtol=AUX_RTOL,
                                   atol=2.0 ** -24, err_msg=key)
    assert mj["lb_loss"] > 0 and mj["z_loss"] > 0
    want = tree_lib.leaves(from_jax_params(gj, ct, "cpu"))
    for (path, t), w in zip(tree_lib.leaves_with_path(pt), want):
        assert _cosine(t.grad, w) >= GRAD_COSINE, (arch, path)


def test_train_step_reports_moe_metrics(models):
    """The step's metric vector carries the MoE layer's terms: equal to
    the loss function's, and to the reference's within tolerance."""
    from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
    from repro_torch.train import step as tstep

    cj, ct, _, npj, batch, mj, _ = models["deepseek-v3-671b"]
    tcfg = tstep.TrainConfig(optimizer=OptimizerConfig(
        name="sgd", lr=0.1, schedule="constant", momentum=0.0))
    params = from_jax_params(npj, ct, "cpu")
    metrics, _ = tstep.loss_and_grads(ct, params, _batch(batch))
    step_fn = tstep.make_train_step(ct, tcfg)
    state = tstep.TrainState(step=0, params=params,
                             opt=make_optimizer(tcfg.optimizer).init(params),
                             generator=torch.Generator().manual_seed(0))
    _, sm = step_fn(state, _batch(batch))
    for key in ("loss", "lb_loss", "z_loss", "dropped_frac"):
        assert float(sm[key]) == float(metrics[key]), key
        np.testing.assert_allclose(float(sm[key]), mj[key], rtol=AUX_RTOL,
                                   atol=2.0 ** -24, err_msg=key)


@pytest.mark.parametrize("quant", ["timefloats", "none"])
def test_remat_dots_matches_full_and_none(models, quant, monkeypatch):
    """remat="dots" gives the loss and every gradient of "full" and
    "none" bitwise, and recomputes no TimeFloats projection: fewer
    quantizer calls and K1 (plain) calls than "full"."""
    cj, ct, _, npj, batch, _, _ = models["deepseek-v3-671b"]
    ct = dataclasses.replace(ct, quant=quant, tf=ttf.TFConfig(mode="pallas"))
    calls = {"k1": 0}
    real = km.timefloats_matmul_plain

    def counted(*a, **kw):
        calls["k1"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(km, "timefloats_matmul_plain", counted)
    runs = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(ct, remat=remat)
        pt = from_jax_params(npj, cfg, "cpu")
        for t in tree_lib.leaves(pt):
            t.requires_grad_(True)
        ttf.reset_quant_trace_counts()
        calls["k1"] = 0
        loss, _ = TM.loss_fn(pt, _batch(batch), cfg)
        loss.backward()
        runs[remat] = (loss.detach(), [t.grad for t in tree_lib.leaves(pt)],
                       sum(ttf.quant_trace_counts().values()), calls["k1"])
    for remat in ("full", "none"):
        assert torch.equal(runs["dots"][0], runs[remat][0]), remat
        for a, b in zip(runs["dots"][1], runs[remat][1]):
            assert torch.equal(a, b), remat
    if quant == "timefloats":   # only the expert products are recomputed
        assert runs["none"][2] <= runs["dots"][2] < runs["full"][2]
        assert runs["dots"][3] < runs["full"][3]
        assert runs["dots"][3] - runs["none"][3] == 3 * ct.moe.num_experts


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------


def _prompts(vocab):
    """Four greedy requests sharing a 16-token prefix, of 18-45 tokens."""
    rng = np.random.default_rng(6)
    shared = rng.integers(0, vocab, 16).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, vocab, 2 + 9 * u)
                            .astype(np.int32)]) for u in range(4)]


def _drain(eng, req_cls, prompts):
    for uid, p in enumerate(prompts):
        eng.submit(req_cls(uid=uid, prompt=p.copy(), max_new_tokens=5))
    return {f.uid: [int(t) for t in f.tokens]
            for f in eng.run_until_drained()}


ENGINE_MODES = {"dense": {},
                "paged_chunked_spec": dict(paged=True, page_size=8,
                                           chunk_tokens=8, spec=2)}


@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_reference(models, arch, mode):
    cj, ct, pj, npj, _, _, _ = models[arch]
    cj = dataclasses.replace(cj, quant="none")
    ct = dataclasses.replace(ct, quant="none")
    kw = dict(ENGINE_MODES[mode], slots=2, max_len=64)
    jkw, tkw = dict(kw), dict(kw)
    if "spec" in kw:
        jkw["spec"], tkw["spec"] = JSpec(k=kw["spec"]), SpecConfig(
            k=kw["spec"])
    prompts = _prompts(cj.vocab_size)
    want = _drain(JEngine(pj, cj, track_energy=False, **jkw), JRequest,
                  prompts)
    eng = Engine(from_jax_params(npj, ct, "cpu"), ct, device="cpu", **tkw)
    assert _drain(eng, Request, prompts) == want
    if kw.get("paged"):
        assert eng.chunk_waves > 0 and eng.pool.conserved()
        assert eng.stats()["radix_hits"] > 0


def test_moe_prefill_capacity_over_real_rows():
    """The port's counterpart of tests/test_paged.py::
    test_moe_prefill_capacity_over_real_rows (capacity_factor 0.25 forces
    drops): a ragged prefill of two prompts with 0 or 2 dummy admission
    rows routes and keeps every real assignment identically, and the real
    rows' logits part by no more than the reference's own do. The
    reference's bitwise form of this test fails (its logits differ by
    about one bf16 ulp between 2 and 4 rows): per-tensor prescales, norms
    and softmax sums see the rows a call carries, so the port claims only
    the reference's own gap."""
    cj, ct = _cfgs(dtype="bfloat16", quant="none",
                   moe=dict(capacity_factor=0.25))
    pj = jax.jit(lambda k: JM.init(cj, k))(jax.random.PRNGKey(0))
    pt = from_jax_params(to_numpy(pj), ct, "cpu")
    rng = np.random.default_rng(3)
    rows = [rng.integers(0, cj.vocab_size, 12).astype(np.int32),
            rng.integers(0, cj.vocab_size, 7).astype(np.int32)]
    seen = []
    real = tmoe.dispatch_indices

    def tapped(idx, n_tokens, cap, n_experts, cap_eff=None):
        slot, order, keep = real(idx, n_tokens, cap, n_experts, cap_eff)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.shape[0])
        seen.append((idx.reshape(-1), slot[rank], keep[rank]))
        return slot, order, keep

    def prefill(n, port):
        toks = np.zeros((n, 16), np.int32)
        lens = np.zeros((n,), np.int32)
        for r, p in enumerate(rows):
            toks[r, :len(p)] = p
            lens[r] = len(p)
        if not port:
            logits, _ = _compiled(lambda p, t, c, ln: JM.prefill(
                p, {"tokens": t}, cj, c, lengths=ln), pj, jnp.asarray(toks),
                JM.init_cache(cj, n, 32), jnp.asarray(lens))
            return _f32(logits[:2])
        tmoe.dispatch_indices = tapped
        try:
            logits, _ = TM.prefill(pt, torch.from_numpy(toks), ct,
                                   TM.init_cache(ct, n, 32, "cpu"),
                                   lengths=torch.from_numpy(lens))
        finally:
            tmoe.dispatch_indices = real
        return logits[:2].float().numpy()

    two, four = prefill(2, True), prefill(4, True)
    (i2, s2, k2), (i4, s4, k4) = seen
    a = 2 * 16 * ct.moe.top_k          # the real rows' assignments
    assert torch.equal(i2[:a], i4[:a]) and torch.equal(k2[:a], k4[:a])
    assert torch.equal(s2[:a][k2[:a]], s4[:a][k4[:a]])
    assert not bool(k2.all())          # drops happen
    ref_gap = float(np.abs(prefill(2, False) - prefill(4, False)).max())
    assert 0 < ref_gap and float(np.abs(two - four).max()) <= ref_gap
