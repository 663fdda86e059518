"""Port parity: the dense model's serving steps on reduced qwen3-0.6b
(f32 activations, ``mode="pallas"``), parameters carried over from the
reference through convert.py.

Logits are held to a stated tolerance, not bitwise: torch and XLA sum the
attention, norm and softmax reductions in different orders, and a one-ulp
change in an activation can move a 5-bit quantizer code, which shifts a
projection by one code step. The tolerance below bounds that: 2e-3 of the
logit scale. (Measured on this case: the logits come out bitwise, since the
5-bit codes absorb the reduction-order ulps; the K cache, which is not
quantized after its norm and rope, is within 1.2e-6.) What is exact on both
sides (the slot scatter, masked lanes) is checked exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import tolerance_report, to_numpy  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.core.timefloats import TFConfig as JTF  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.timefloats import TFConfig  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

LOGIT_TOL = 2e-3


def configs():
    cj = dataclasses.replace(jreduced(jget_config("qwen3-0.6b")),
                             tf=JTF(mode="pallas"), dtype="float32")
    ct = dataclasses.replace(reduced_for_smoke(get_config("qwen3-0.6b")),
                             tf=TFConfig(mode="pallas"), dtype="float32")
    return cj, ct


@pytest.fixture(scope="module")
def models():
    cj, ct = configs()
    pj = JM.init(cj, jax.random.PRNGKey(0))
    pt = from_jax_params(to_numpy(pj), ct, "cpu")
    return cj, ct, pj, pt


def _close(got, want, label):
    rep = tolerance_report(got, want)
    scale = float(np.abs(np.asarray(want)).max())
    assert rep["max_abs"] <= LOGIT_TOL * scale, f"{label}: {rep}"


def test_prefill_then_decode_logits_within_tolerance(models):
    cj, ct, pj, pt = models
    rng = np.random.default_rng(0)
    b, s, max_len = 3, 16, 32
    tokens = rng.integers(0, cj.vocab_size, (b, s)).astype(np.int32)
    lengths = np.array([16, 9, 0], np.int32)  # full, ragged, dummy row
    prefill = jax.jit(lambda p, t, c, n: JM.prefill(
        p, {"tokens": t}, cj, c, lengths=n))
    lj, cache_j = prefill(pj, jnp.asarray(tokens), JM.init_cache(cj, b, max_len),
                          jnp.asarray(lengths))
    lt, cache_t = TM.prefill(pt, torch.from_numpy(tokens), ct,
                             TM.init_cache(ct, b, max_len, "cpu"),
                             lengths=torch.from_numpy(lengths))
    assert lt.shape == (b, 1, cj.vocab_size) and lt.dtype == torch.float32
    _close(lt.numpy(), lj, "prefill logits")
    kj = np.asarray(cache_j.groups[0].k[0])
    _close(cache_t.layers[0].k.numpy(), kj, "layer-0 K cache")
    assert np.array_equal(cache_t.lengths.numpy(), lengths)

    nxt = np.asarray(jnp.argmax(lj[:, 0], axis=-1), np.int32)[:, None]
    decode = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, cj))
    dj, _ = decode(pj, cache_j, jnp.asarray(nxt))
    dt, cache_t = TM.decode_step(pt, cache_t, torch.from_numpy(nxt.copy()), ct)
    _close(dt.numpy(), dj, "decode logits")
    assert np.array_equal(cache_t.lengths.numpy(), lengths + 1)


def test_masked_lanes_are_exact_zeros():
    """Prefill attends over the whole cache extent: every lane past a
    row's length (and every lane of a length-0 row) must weigh exactly 0."""
    rng = np.random.default_rng(1)
    b, s, hkv, g, d, smax = 2, 4, 2, 2, 8, 12
    q = torch.from_numpy(rng.standard_normal((b, s, hkv * g, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, smax, hkv, d)).astype(np.float32))
    v = torch.zeros((b, smax, hkv, d))
    v[:, 4:] = 1e30  # any weight on a lane past length 4 shows
    pos = torch.arange(s)[None].expand(b, s)
    out = TA.decode_attention(q, k, v, pos, torch.tensor([4, 0]), TA.MaskSpec())
    assert torch.equal(out, torch.zeros_like(out))


def test_scatter_cache_rows_drops_out_of_range_ids(models):
    _, ct, _, _ = models
    full = TM.init_cache(ct, 3, 8, "cpu")
    rows = TM.init_cache(ct, 3, 8, "cpu")
    for i, lay in enumerate(rows.layers):
        lay.k.copy_(torch.arange(3.0)[:, None, None, None] + 10 * i + 1)
    rows = rows._replace(lengths=torch.tensor([5, 6, 7], dtype=torch.int32))
    out = TM.scatter_cache_rows(full, rows, np.array([2, 3, -1]))
    assert out.lengths.tolist() == [0, 0, 5]  # ids 3 and -1 drop, never clamp
    k0 = out.layers[0].k[:, 0, 0, 0].tolist()
    assert k0 == [0.0, 0.0, 1.0]


def test_convert_carries_bf16_bits_and_slices_layers():
    cj, ct = configs()
    cj = dataclasses.replace(cj, param_dtype="bfloat16")
    ct = dataclasses.replace(ct, param_dtype="bfloat16")
    pj = JM.init(cj, jax.random.PRNGKey(1))
    pt = from_jax_params(to_numpy(pj), ct, "cpu")
    assert len(pt["layers"]) == ct.n_layers
    wq = np.asarray(pj["groups"][0]["params"]["mixer"]["wq"][1])
    got = pt["layers"][1]["mixer"]["wq"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          wq.view(np.uint16))
