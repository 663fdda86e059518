"""Port parity: the FP8 codec and the pow2 prescale, bitwise against the
JAX reference (repro.core.float8, repro.core.timefloats._pow2_prescale).
Inputs are made with numpy from a seed and fed to both sides."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import assert_bitwise  # noqa: E402

from repro.core import float8 as jf8  # noqa: E402
from repro.core import timefloats as jtf  # noqa: E402
from repro_torch.core import float8 as tf8  # noqa: E402
from repro_torch.core import timefloats as ttf  # noqa: E402

FORMATS = {"e4m4": (jf8.E4M4, tf8.E4M4), "e4m3": (jf8.E4M3, tf8.E4M3),
           "e5m2": (jf8.E5M2, tf8.E5M2)}


def _field_inputs(fmt) -> np.ndarray:
    rng = np.random.default_rng(0)
    top = fmt.max_value
    special = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-40, -1e-40,
               np.finfo(np.float32).max, -np.finfo(np.float32).max,
               top, -top, top * 1.01, top * 4.0, fmt.min_normal,
               fmt.min_normal * 0.49, fmt.min_normal * 0.51, 1.0, -1.0]
    # Mantissa carry: just below 2^e, at and around the rounding midpoint.
    step = 2.0 ** -fmt.man_bits
    for e in range(-3, 4):
        for f in (1.0 - step / 4, 1.0 - step / 2, 1.0 + step / 2, 2.0 - step / 2):
            special += [f * 2.0 ** e, -f * 2.0 ** e]
    rand = rng.standard_normal(4000) * 2.0 ** rng.integers(-12, 12, 4000)
    return np.concatenate([np.float32(special), rand.astype(np.float32)])


@pytest.mark.parametrize("name", list(FORMATS))
def test_decompose_and_quantize_fields_bitwise(name):
    jfmt, tfmt = FORMATS[name]
    x = _field_inputs(jfmt)
    want = jax.jit(lambda a: jf8.decompose(a, jfmt))(jnp.asarray(x))
    got = tf8.decompose(torch.from_numpy(x), tfmt)
    for field in ("sign", "exp", "man", "nonzero"):
        assert_bitwise(getattr(got, field).numpy(),
                       np.asarray(getattr(want, field)), f"{name}.{field}")
    qj = np.asarray(jf8.quantize(jnp.asarray(x), jfmt))
    qt = tf8.quantize(torch.from_numpy(x), tfmt).numpy()
    assert_bitwise(qt.view(np.int32), qj.view(np.int32), f"{name} quantize")


def test_exp2i_every_integer_exponent():
    """2^e over [-149, 127] and past both ends, bit for bit. The reference
    backend flushes subnormal results (e < -126) to zero; the port
    reproduces that rather than the mathematically exact subnormals."""
    e = np.arange(-160, 140, dtype=np.int32)
    want = np.asarray(jax.jit(jf8.exp2i)(jnp.asarray(e)))
    got = tf8.exp2i(torch.from_numpy(e)).numpy()
    assert_bitwise(got.view(np.int32), want.view(np.int32), "exp2i")
    normal = (e >= -126) & (e <= 127)
    assert np.array_equal(got[normal], np.ldexp(np.float32(1), e[normal]))


def _near_powers_of_two(lo: int, hi: int, ulps: int) -> np.ndarray:
    base = np.ldexp(np.float32(1), np.arange(lo, hi)).astype(np.float32)
    bits = base.view(np.int32)[:, None] + np.arange(-ulps, ulps + 1)
    return bits.astype(np.int32).ravel().view(np.float32)


def test_log2_floor_near_powers_of_two_f32():
    """floor(log2(amax)) decides the prescale; near 2^e its last ulp does.
    Every amax within 64 ulps of every normal power of two, plus a random
    sweep, must give the reference's floor."""
    rng = np.random.default_rng(1)
    a = np.concatenate([_near_powers_of_two(-126, 128, 64),
                        np.exp(rng.uniform(-87, 88, 20000)).astype(np.float32),
                        np.float32([0.0, 1e-35, 1e-30])])
    want = np.asarray(jax.jit(
        lambda v: jnp.floor(jnp.log2(jnp.maximum(v, 1e-30))))(jnp.asarray(a)))
    got = tf8.log2_floor(torch.from_numpy(a)).numpy()
    assert_bitwise(got, want, "log2 floor f32")


def test_log2_floor_every_bf16():
    """bf16 activations take amax and its log2 in bf16: every positive
    finite bf16 value."""
    bits = np.arange(0x0001, 0x7F80, dtype=np.uint16)
    want = np.asarray(jax.jit(
        lambda v: jnp.floor(jnp.log2(jnp.maximum(v, 1e-30))))(
            jnp.asarray(bits).view(jnp.bfloat16)).astype(jnp.float32))
    got = tf8.log2_floor(torch.from_numpy(bits.view(np.int16)).view(
        torch.bfloat16)).float().numpy()
    assert_bitwise(got, want, "log2 floor bf16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pow2_prescale_near_powers_of_two(dtype):
    """_pow2_prescale end to end (scaled array and scale) for tensors whose
    amax sits one ulp below, at and one ulp above a power of two."""
    rng = np.random.default_rng(2)
    cfg_j, cfg_t = jtf.TFConfig(mode="pallas"), ttf.TFConfig(mode="pallas")
    fn = jax.jit(lambda v: jtf._pow2_prescale(v, cfg_j))
    for e in (-9, -1, 0, 1, 3, 7, 12):
        for k in (-1, 0, 1):
            body = rng.uniform(-0.5, 0.5, (6, 10)) * 2.0 ** e
            amax = np.float32(2.0 ** e)
            if dtype == "bfloat16":
                amax_bits = np.array([amax]).view(np.int32)[0] >> 16
                amax_bits = np.uint16(amax_bits + k)
                x_j = jnp.asarray(body, jnp.bfloat16).at[2, 3].set(
                    jnp.asarray(amax_bits).view(jnp.bfloat16))
                x_t = torch.from_numpy(
                    np.array(x_j).view(np.uint16).view(np.int16)
                ).view(torch.bfloat16)
            else:
                body = body.astype(np.float32)
                body[2, 3] = (np.array([amax]).view(np.int32) + k
                              ).view(np.float32)[0]
                x_j, x_t = jnp.asarray(body), torch.from_numpy(body)
            ys_j, s_j = fn(x_j)
            ys_t, s_t = ttf._pow2_prescale(x_t, cfg_t)
            assert_bitwise(s_t.numpy(), np.asarray(s_j), f"scale e={e} k={k}")
            assert_bitwise(ys_t.numpy(), np.asarray(ys_j), f"xs e={e} k={k}")


def test_pow2_amax_scale_bitwise():
    rng = np.random.default_rng(3)
    for name, (jfmt, tfmt) in FORMATS.items():
        for e in (-20, -3, 0, 5):
            x = (rng.standard_normal(50) * 2.0 ** e).astype(np.float32)
            want = np.asarray(jf8.pow2_amax_scale(jnp.asarray(x), jfmt))
            got = tf8.pow2_amax_scale(torch.from_numpy(x), tfmt).numpy()
            assert_bitwise(got, want, f"{name} e={e}")
    zero = tf8.pow2_amax_scale(torch.zeros(4), tf8.E4M4)
    assert zero.item() == 1.0
