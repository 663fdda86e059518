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
# K1's edges: one chunk (C = 1) with M between 8 and 64 and N on 64 but off
# a 128-column tile; an odd C = 3 with M = 40; a 576-wide N (deepseek-v3's
# wkv_a) with M = 5.
EDGE_SHAPES = [(12, 64, 192), (40, 187, 64), (5, 130, 576)]


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
@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES, ids=str)
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


# (M, C, N) of every K1 call the smoke holds: qwen3-0.6b decode, prefill
# waves and training, deepseek-v3's dense-layer decode, and ragged ones.
QWEN_KN = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
           (3072, 1024), (1024, 151936)]
DEEPSEEK_KN = [(7168, 1536), (1536, 24576), (7168, 576), (16384, 7168),
               (7168, 18432), (18432, 7168), (7168, 129280)]
PLAN_CASES = ([(m, k // 64, n) for m in (8, 32, 64, 128, 256, 512, 1024)
               for k, n in QWEN_KN] + [(8, k // 64, n) for k, n in DEEPSEEK_KN]
              + [(16, 16, 608), (1000, 16, 3008), (8, 1, 16), (8, 3, 48)])


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_k1_plan_assigns_every_chunk_once_in_order(sms):
    """K1's tile and split rule: every plan is one the kernel takes; the
    splits' chunk runs, concatenated in block order (the order the owners
    add them), are 0..C-1 with none empty; at most 8 splits (one portable
    cluster) and at most C; the tiles cover the output; the tile's rows
    follow the regime (8 at decode, 32 up to 256 rows, larger tiles and no
    split above); and a split plan fills the card or is the deepest whose
    terms fit."""
    for m, c, n in PLAN_CASES:
        plan = tkm.k1_plan(m, c, n, sms)
        tkm.check_plan(plan, m, c, n)
        conf = tkm.CONFIGS[plan.config]
        runs = tkm.split_chunks(c, plan.splits)
        assert [i for lo, hi in runs for i in range(lo, hi)] == list(range(c))
        assert all(hi > lo for lo, hi in runs)
        assert 1 <= plan.splits <= min(c, tkm.MAX_SPLITS)
        gm, gn = -(-m // conf.bm), -(-n // conf.bn)
        assert (gm - 1) * conf.bm < m <= gm * conf.bm
        assert (gn - 1) * conf.bn < n <= gn * conf.bn
        if m <= 8:
            assert conf.bm == 8
        elif m <= tkm.SPLIT_MAX_M:
            assert conf.bm == 32
        else:
            assert conf.bm >= 64 and plan.splits == 1
        if plan.splits > 1:
            deeper = tkm.K1Plan(plan.config, plan.splits + 1)
            fits = (plan.splits < min(c, tkm.MAX_SPLITS) and
                    conf.smem(-(-c // deeper.splits)) <= tkm.SMEM_LIMIT)
            assert gm * gn * plan.splits >= tkm.FILL * sms or not fits


def test_k1_configs_mirror_the_kernel_table():
    """CONFIGS lists the kernel's tile table, index for index."""
    import re

    from repro_torch.kernels import _build

    src = (_build.CSRC / "timefloats_matmul.cu").read_text()
    rows = [tuple(int(v) for v in r) for r in re.findall(
        r"K1_CASE\((\d+), (\d+), (\d+), (\d+), (\d+)\)", src)]
    assert rows == [(i, *c) for i, c in enumerate(tkm.CONFIGS)]


def test_k1_split_and_biased_accumulator_are_exact():
    """What lets K1 run chunks in parallel: its int32 accumulator starts at
    0x4B400000, so every reachable chunk dot p (|p| <= 64 * 31^2) reads
    back as the float 1.5 * 2^23 + p, and one subtraction gives p exactly;
    and adding the chunks' terms in chunk order from 0, however the chunks
    are cut into splits, is the spec's sum bit for bit."""
    p = np.arange(-64 * 31 ** 2, 64 * 31 ** 2 + 1, dtype=np.int32)
    biased = (p + np.int32(0x4B400000)).view(np.float32)
    assert_bitwise(biased - np.float32(12582912.0), p.astype(np.float32),
                   "biased dot")
    x, w = _operands(9, 64 * 7, 40, seed=5)
    ct = ttf.TFConfig(mode="pallas")
    qx, qw = ttf.quantize_input(torch.from_numpy(x), ct), \
        ttf.quantize_weight(torch.from_numpy(w), ct)
    want = ttf.matmul_from_quantized(qx, qw, ct)
    terms = [(qx.q[c].float() @ qw.q[c].float()) * qx.scale[c][:, None]
             * qw.scale[c][None, :] for c in range(qx.q.shape[0])]
    for splits in (1, 2, 3, 7):
        acc = torch.zeros_like(want)
        for lo, hi in tkm.split_chunks(len(terms), splits):
            for c in range(lo, hi):
                acc = acc + terms[c]
        assert torch.equal(acc, want), splits


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
