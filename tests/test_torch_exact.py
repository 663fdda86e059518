"""Port parity: TimeFloats exact mode (the paper's five steps and the
per-(row, column, chunk) joint-max ``matmul_exact``) against the JAX
reference on the CPU.

Every step is an integer or power-of-two operation and the f32 chunk sum
runs in chunk order, so the five steps, ``matmul_exact`` (with and without
the 4-bit ADC, K a multiple of 64 or not), ``expected_sparsity`` and
exact-mode ``linear`` with its gradients are held bitwise. The reduced
qwen3 model in exact mode is held at the model tolerances of
tests/test_torch_train.py (loss 1e-3 relative, per-leaf gradient cosine >
0.999): attention, norms and softmax sum in another order than XLA.
Inputs come from numpy seeds; the reference's arrays cross through numpy.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import assert_bitwise, to_numpy  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.core import timefloats as jtf  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import timefloats as ttf  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ADC = {"noadc": {}, "adc4_dynamic": {"adc_bits": 4},
       "adc4_fixed": {"adc_bits": 4, "adc_mode": "fixed"}}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("k", [64, 100, 256])
def test_scalar_product_steps_bitwise(k):
    """The five steps on one (x, w) pair, chunk by chunk, with a zero in
    each operand (an invalid term) and a spread of exponents."""
    rng = np.random.default_rng(k)
    x = (rng.standard_normal(k) * np.exp2(rng.integers(-6, 6, k))
         ).astype(np.float32)
    w = rng.standard_normal(k).astype(np.float32)
    x[3] = w[5] = 0.0
    want = jax.jit(jtf.scalar_product_steps)(x, w)
    got = ttf.scalar_product_steps(_t(x), _t(w))
    assert_bitwise(got.numpy(), np.asarray(want), f"steps k={k}")


@pytest.mark.parametrize("adc", list(ADC))
@pytest.mark.parametrize("mkn", [(5, 128, 7), (9, 130, 16)])
def test_matmul_exact_bitwise(adc, mkn):
    m, k, n = mkn
    rng = np.random.default_rng(m * k + n)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.2).astype(np.float32)
    x[0, :7] = 0.0
    cj, ct = jtf.TFConfig(**ADC[adc]), ttf.TFConfig(**ADC[adc])
    want = jax.jit(lambda a, b: jtf.matmul_exact(a, b, cj))(x, w)
    got = ttf.matmul_exact(_t(x), _t(w), ct)
    assert_bitwise(got.numpy(), np.asarray(want), f"matmul_exact {adc}")
    want = jax.jit(lambda a, b: jtf.expected_sparsity(a, b, cj))(x, w)
    got = ttf.expected_sparsity(_t(x), _t(w), ct)
    assert_bitwise(got.numpy(), np.asarray(want), "expected_sparsity")


def test_matmul_exact_noise_waits_for_the_variability_slice():
    x, w = torch.ones(2, 64), torch.ones(64, 3)
    ct = ttf.TFConfig()
    quiet = ttf.matmul_exact(x, w, ct, noise=ttf.NoiseParams())
    assert torch.equal(quiet, ttf.matmul_exact(x, w, ct))
    with pytest.raises(NotImplementedError, match="variability"):
        ttf.matmul_exact(x, w, ct, noise=ttf.NoiseParams(sigma_exp=0.01))


@pytest.mark.parametrize("cache", [True, False])
def test_linear_exact_forward_and_grads_bitwise(cache):
    """Exact-mode ``linear`` at f32 with leading batch dims: y, dx and dW
    bitwise (the cached and uncached backward alike)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 4, 70)).astype(np.float32)
    w = (rng.standard_normal((70, 20)) * 0.1).astype(np.float32)
    g = rng.standard_normal((3, 4, 20)).astype(np.float32)
    cj = jtf.TFConfig(mode="exact", cache=cache)
    ct = ttf.TFConfig(mode="exact", cache=cache)

    @jax.jit
    def reference(x, w):
        y, vjp = jax.vjp(lambda a, b: jtf.linear(a, b, cj), x, w)
        return (y,) + vjp(jnp.asarray(g))

    y, dx, dw = reference(x, w)
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    yt = ttf.linear(xt, wt, ct)
    yt.backward(_t(g))
    assert_bitwise(yt.detach().numpy(), np.asarray(y), "y")
    assert_bitwise(xt.grad.numpy(), np.asarray(dx), "dx")
    assert_bitwise(wt.grad.numpy(), np.asarray(dw), "dW")


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / max(float(a.norm() * b.norm()), 1e-300))


def test_reduced_qwen3_exact_loss_and_grads():
    """One loss-and-gradients step of reduced qwen3-0.6b (one layer) at
    f32 activations with every projection in exact mode (the per-step weight
    cache in exact entries), against the reference's ``value_and_grad`` of
    its loss."""
    kw = dict(dtype="float32", n_layers=1)
    cj = dataclasses.replace(jreduced(jget_config("qwen3-0.6b")),
                             tf=jtf.TFConfig(mode="exact"), **kw)
    ct = dataclasses.replace(reduced_for_smoke(get_config("qwen3-0.6b")),
                             tf=ttf.TFConfig(mode="exact"), **kw)
    pj = to_numpy(jax.jit(lambda k: JM.init(cj, k))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cj.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": np.ones((2, 16), np.float32)}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, cj), has_aux=True))(
        jax.tree.map(jnp.asarray, pj), batch)
    params = from_jax_params(pj, ct, "cpu")
    metrics, got = tstep.loss_and_grads(
        ct, params, {k: _t(v) for k, v in batch.items()})
    assert abs(float(metrics["loss"]) - float(loss)) <= 1e-3 * abs(
        float(loss))
    want = from_jax_params(to_numpy(grads), ct, "cpu")
    for (path, g), w in zip(tree_lib.leaves_with_path(got),
                            tree_lib.leaves(want)):
        assert bool(torch.isfinite(g).all()), tree_lib.path_str(path)
        cos = _cosine(g, w)
        assert cos > 0.999, f"{tree_lib.path_str(path)}: cosine {cos}"
