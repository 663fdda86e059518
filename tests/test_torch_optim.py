"""Port parity: the optimizers, the LR schedule, global-norm clipping and
the FP8 codec's training additions (stochastic rounding, scale-aware
quantization, packing), against the JAX reference on the CPU.

One update of each optimizer runs on the same numpy-made params and
grads on both sides. Tolerance: 2e-7 absolute on params of order 0.1-1
and rates of 1e-2: the schedule's f32 cosine and power, and XLA's fused
elementwise chains, may round the last bit differently, which moves an
update by an ulp of the rate times the step. SGD, run op by op on both
sides, is held bitwise, and so is its in-situ requantization without
stochastic rounding. Stochastic rounding draws from a torch.Generator, so
it is held to the reference in distribution only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import assert_bitwise, to_numpy  # noqa: E402

from repro.core import float8 as jf8  # noqa: E402
from repro.core.timefloats import TFConfig as JTF  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.core import float8 as tf8  # noqa: E402
from repro_torch.core.timefloats import TFConfig  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

ATOL = 2e-7


def _tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa
    return {"w": f(8, 16), "b": f(16), "layers": [{"wo": f(2, 4, 8)}]}


def _torch(tree):
    return tree_lib.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


CASES = {
    "sgd": dict(name="sgd", lr=1e-2, warmup=2, total_steps=10),
    "adamw": dict(name="adamw", lr=1e-2, warmup=2, total_steps=10,
                  weight_decay=0.1),
    "adafactor": dict(name="adafactor", lr=1e-2, warmup=2, total_steps=10),
    "sgd_insitu": dict(name="sgd", lr=1e-2, schedule="constant", momentum=0.0,
                       stochastic_rounding=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_one_update_matches_reference(case):
    """Two updates (steps 2 and 3, across the warmup's end) from the same
    params and grads, state carried between them."""
    kw = dict(CASES[case])
    insitu = case.endswith("insitu")
    jo = jopt.make_optimizer(jopt.OptimizerConfig(
        **kw, insitu=JTF() if insitu else None))
    to = topt.make_optimizer(topt.OptimizerConfig(
        **kw, insitu=TFConfig() if insitu else None))
    params, grads = _tree(1), _tree(2)
    jp, js = jax.tree.map(jnp.asarray, params), None
    tp, ts = _torch(params), None
    js, ts = jo.init(jp), to.init(tp)
    # SGD runs eagerly on the JAX side, op by op like the port, so it can
    # be held bitwise; jit would contract p - lr*d into an FMA.
    jupdate = jo.update if case.startswith("sgd") else jax.jit(jo.update)
    for step in (2, 3):
        jp, js = jupdate(jax.tree.map(jnp.asarray, grads), js, jp,
                         jnp.int32(step))
        tp, ts = to.update(_torch(grads), ts, tp, step)
    for (path, got), want in zip(tree_lib.leaves_with_path(tp),
                                 tree_lib.leaves(to_numpy(jp))):
        label = f"{case} {tree_lib.path_str(path)}"
        if case.startswith("sgd"):
            assert_bitwise(got.numpy(), want, label)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL,
                                       err_msg=label)
    for (path, got), want in zip(tree_lib.leaves_with_path(ts),
                                 tree_lib.leaves(to_numpy(js))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0,
                                   err_msg=f"{case} state {path}")
    if insitu:  # on the E4M4 grid relative to the tensor's reference
        w = tp["w"]
        assert torch.equal(tf8.quantize_scaled(w), w)


def test_clip_by_global_norm_and_schedule_match_reference():
    grads = _tree(5)
    jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 0.5)
    tg, tn = topt.clip_by_global_norm(_torch(grads), 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for got, want in zip(tree_lib.leaves(tg), tree_lib.leaves(to_numpy(jg))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    from repro.optim import schedules as jsched
    from repro_torch.optim import schedules as tsched

    jf, tf = jsched.warmup_cosine(3e-4, 5, 50), tsched.warmup_cosine(3e-4, 5,
                                                                    50)
    for step in (0, 3, 5, 20, 49, 60):
        np.testing.assert_allclose(float(tf(step)), float(jf(step)),
                                   rtol=1e-6)


def test_warmup_cosine_bitwise_against_the_jitted_reference():
    """400 steps of a 100/10000 warmup-cosine, over the warmup and 300
    steps past it, equal bitwise the rate the reference's jitted update
    computes (XLA's cosine, reciprocal and fused multiply-add, replayed on
    the host in optim/schedules.py)."""
    from repro.optim import schedules as jsched
    from repro_torch.optim import schedules as tsched

    jf = jax.jit(jsched.warmup_cosine(3e-4, 100, 10000))
    tf = tsched.warmup_cosine(3e-4, 100, 10000)
    want = np.array([jf(jnp.int32(s)) for s in range(400)], np.float32)
    got = np.array([tf(s).numpy() for s in range(400)], np.float32)
    assert_bitwise(got, want, "warmup_cosine(3e-4, 100, 10000)")


def test_pack_unpack_and_quantize_scaled_bitwise():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal(4000) * 2.0 ** rng.integers(-9, 5, 4000)
         ).astype(np.float32)
    x[:4] = [0.0, -0.0, 1e-30, -3.0]
    jf = jax.jit(jf8.decompose)(jnp.asarray(x))
    jp = jax.jit(jf8.pack)(jf)
    tp = tf8.pack(tf8.decompose(torch.from_numpy(x)))
    assert_bitwise(tp.code.numpy(), np.asarray(jp.code), "code")
    assert_bitwise(tp.signbit.numpy(), np.asarray(jp.signbit), "signbit")
    back = tf8.compose(tf8.unpack(tp))
    assert_bitwise(back.numpy(), np.asarray(jax.jit(
        lambda p: jf8.compose(jf8.unpack(p)))(jp)), "unpack")
    w = x.reshape(40, 100) * 1e-3   # below E4M4's min normal unscaled
    assert_bitwise(tf8.quantize_scaled(torch.from_numpy(w)).numpy(),
                   np.asarray(jax.jit(jf8.quantize_scaled)(jnp.asarray(w))),
                   "quantize_scaled")


def test_stochastic_rounding_matches_reference_in_distribution():
    """Each value rounds to one of its two neighbours on the E4M4 grid, up
    with probability equal to its fractional position, on both sides:
    unbiased, and the up-fractions of the two agree within sampling noise
    (20000 draws of each value: 5 sigma of a binomial is < 0.02)."""
    vals = np.array([1.03, 1.5 + 1 / 64, -2.9, 0.3 + 1 / 128],
                    np.float32)
    n = 20000
    x = np.repeat(vals, n)
    tq = tf8.quantize_stochastic(torch.from_numpy(x),
                                 torch.Generator().manual_seed(0)).numpy()
    jq = np.asarray(jf8.quantize_stochastic(jnp.asarray(x),
                                            jax.random.PRNGKey(0)))
    for i, v in enumerate(vals):
        t = np.abs(tq[i * n:(i + 1) * n])   # magnitudes: up = away from 0
        j = np.abs(jq[i * n:(i + 1) * n])
        lo, hi = np.unique(j)
        assert set(np.unique(t)) <= {lo, hi}
        assert np.all(np.sign(tq[i * n:(i + 1) * n]) == np.sign(v))
        frac = (abs(v) - lo) / (hi - lo)
        up_t, up_j = np.mean(t == hi), np.mean(j == hi)
        assert abs(up_t - up_j) < 0.02 and abs(up_t - frac) < 0.02, (
            v, up_t, up_j, frac)
