"""Port parity: TimeFloats quantization and the K1 block-MAC, bitwise
against the JAX reference. The port's K1 wrapper runs its plain version on
these CPU tensors; the reference runs ``matmul_from_quantized`` and the
Pallas kernel in interpret mode. The CUDA kernel itself is held against the
same plain version on the card by chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import assert_bitwise, tolerance_report  # noqa: E402

from repro.core import timefloats as jtf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import timefloats as ttf  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import timefloats_matmul as tkm  # noqa: E402

ADC = {"noadc": {}, "adc4": {"adc_bits": 4, "adc_mode": "fixed"}}
# Ragged on purpose: M below the tile, K off the 64-block, N off the tile.
SHAPES = [(1, 64, 8), (3, 100, 70), (5, 200, 130)]


def _operands(m, k, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 2.0 ** rng.integers(-3, 4)).astype(dtype)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    return x, w


def _cfgs(mode, adc):
    return (jtf.TFConfig(mode=mode, **ADC[adc]),
            ttf.TFConfig(mode=mode, **ADC[adc]))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantized_planes_and_scales_bitwise(shape):
    m, k, n = shape
    x, w = _operands(m, k, n, seed=sum(shape))
    cj, ct = _cfgs("pallas", "noadc")
    for name, jfn, tfn, a in (("input", jtf.quantize_input,
                               ttf.quantize_input, x),
                              ("weight", jtf.quantize_weight,
                               ttf.quantize_weight, w)):
        want = jax.jit(jfn, static_argnums=1)(jnp.asarray(a), cj)
        got = tfn(torch.from_numpy(a), ct)
        assert_bitwise(got.q.numpy(), np.asarray(want.q), f"{name} q")
        assert_bitwise(got.scale.numpy(), np.asarray(want.scale),
                       f"{name} scale")


@pytest.mark.parametrize("adc", list(ADC))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k1_plain_matches_reference_and_interpret_kernel(shape, adc):
    """The port's K1 entry point (padding + plain version on CPU) against
    the reference's chunk-ordered spec AND its Pallas kernel run in
    interpret mode, on prescaled operands as the model feeds them."""
    m, k, n = shape
    x, w = _operands(m, k, n, seed=7 * sum(shape))
    cj, ct = _cfgs("pallas", adc)
    xs, _ = jtf._pow2_prescale(jnp.asarray(x), cj)
    ws, _ = jtf._pow2_prescale(jnp.asarray(w), cj)
    spec = jax.jit(lambda a, b: jtf.matmul_from_quantized(
        jtf.quantize_input(a, cj), jtf.quantize_weight(b, cj), cj))(xs, ws)
    pallas = jops.timefloats_matmul(xs, ws, cj, interpret=True)
    before = tkm.timefloats_matmul_quantized.launches
    got = tops.timefloats_matmul(torch.from_numpy(np.array(xs)),
                                 torch.from_numpy(np.array(ws)), ct)
    assert tkm.timefloats_matmul_quantized.launches == before  # CPU: plain
    assert got.shape == (m, n)
    assert_bitwise(got.numpy(), np.asarray(spec), "K1 plain vs spec")
    assert_bitwise(got.numpy(), np.asarray(pallas), "K1 plain vs interpret")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_forward_bitwise(dtype):
    """The whole forward linear (prescale both operands, K1, unscale) on
    activations in either dtype, as dense() calls it."""
    x, w = _operands(6, 192, 96, seed=11)
    cj, ct = _cfgs("pallas", "noadc")
    xj = jnp.asarray(x, getattr(jnp, dtype)).reshape(2, 3, 192)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype)).reshape(2, 3, 192)
    want = jax.jit(lambda a, b: jtf.linear(a, b, cj))(xj, jnp.asarray(w))
    got = ttf.linear(xt, torch.from_numpy(w), ct)
    assert got.shape == (2, 3, 96)
    assert_bitwise(got.numpy(), np.asarray(want), f"linear {dtype}")


def test_separable_within_summation_tolerance():
    """``separable`` is one dense f32 matmul of exactly dequantized
    operands, so it differs from the reference only by summation order:
    within a few f32 ulps of the result scale."""
    x, w = _operands(5, 200, 130, seed=3)
    cj, ct = _cfgs("separable", "noadc")
    want = np.asarray(jax.jit(jtf.matmul_separable, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(w), cj))
    got = ttf.matmul_separable(torch.from_numpy(x), torch.from_numpy(w),
                               ct).numpy()
    rep = tolerance_report(got, want)
    assert rep["max_abs"] <= 1e-5 * np.abs(want).max(), rep


def test_k1_wrapper_rejects_dynamic_adc_and_unpadded_operands():
    ct = ttf.TFConfig(mode="pallas", adc_bits=4, adc_mode="dynamic")
    q = ttf.quantize_input(torch.ones(8, 64), ct)
    qw = ttf.quantize_weight(torch.ones(64, 128), ct)
    with pytest.raises(ValueError, match="fixed"):
        tkm.timefloats_matmul_quantized(q.q, q.scale, qw.q, qw.scale, cfg=ct)
    ok = ttf.TFConfig(mode="pallas")
    qw = ttf.quantize_weight(torch.ones(64, 100), ok)
    with pytest.raises(ValueError, match="pad"):
        tkm.timefloats_matmul_quantized(q.q, q.scale, qw.q, qw.scale, cfg=ok)


def test_build_targets_hash_sources_and_need_nvcc(monkeypatch, tmp_path):
    """Kernels build into build/repro_torch/<name>-<source hash>.so at the
    checkout root, only when launched; without nvcc the build raises."""
    from repro_torch.kernels import _build

    target = _build._target("sampling")
    assert target.parent == _build.BUILD_DIR
    assert target.parent.parent.parent == _build.CSRC.parents[2]
    assert target.name.startswith("sampling-") and target.suffix == ".so"
    assert _build.build([]) == 0.0
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_build_signatures_match_the_c_entry_points():
    """The ctypes argument list declared for each entry point has as many
    arguments as its ``extern "C" int`` declaration in the source."""
    import re

    from repro_torch.kernels import _build

    for name, entries in _build.SIGNATURES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        for entry, argtypes in entries.items():
            decl = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
            assert decl is not None, f"{name}.cu has no {entry}"
            assert len(decl.group(1).split(",")) == len(argtypes), entry


def test_dispatch_override_is_scoped():
    from repro_torch.kernels import dispatch

    assert not dispatch._KERNELS_OFF
    with dispatch.override(kernels=False):
        with dispatch.override(kernels=False):
            assert len(dispatch._KERNELS_OFF) == 2
        assert dispatch._KERNELS_OFF
    assert not dispatch._KERNELS_OFF
    with pytest.raises(ValueError):
        with dispatch.override(kernels=True):
            pass
    assert not dispatch._KERNELS_OFF
