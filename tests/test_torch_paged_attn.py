"""Port parity of K4, the fused split-K paged decode attention
(``repro_torch.kernels.paged_attn``), and of its split-count lookup.

On the CPU the port's wrapper runs its plain version (``_gqa_plain`` +
``_combine``), which mirrors the reference's ``_gqa_ref`` and ``_combine``
op for op. It is held against the reference's ``use_pallas=False`` path
and its Pallas kernel in interpret mode on the cases of
``tests/test_paged_attn.py`` (a length-0 row, a single-page table, trash
entries past each row's extent, bf16 pools, 1 to 8 splits).

Tolerance: max |diff| < 1e-6 on unit-normal inputs. Not bitwise: the
reference sums the score dot products, the softmax denominators and the
p.V products in float32, the port in float64 rounded once to float32 (so
that its kernel matches it bitwise on the card), so results differ by an
ulp or a few (measured here: at most 3e-7). Length-0 rows are exact zeros
on both sides. The hand kernel is held against the plain version on the
card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import tolerance_report  # noqa: E402

from repro.kernels.paged_attn import \
    paged_decode_attention as jpaged_decode_attention  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import paged_attn as kpa  # noqa: E402

K4_TOL = 1e-6

GQA_CASES = [
    # (b, t, page, hkv, g, dk, dv, dtype, n_splits)
    (2, 4, 8, 2, 2, 16, 16, "float32", 4),
    (1, 1, 4, 1, 1, 8, 8, "float32", 1),      # single-page table
    (3, 2, 16, 1, 4, 32, 16, "bfloat16", 2),  # MQA grouped heads
    (2, 8, 4, 4, 1, 16, 32, "bfloat16", 8),   # max splits
    (3, 4, 8, 2, 2, 32, 32, "float32", 2),    # the reduced qwen3 heads
]


def _torch(a) -> "torch.Tensor":
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _gqa_case(rng, b, t, page, hkv, g, dk, dv, dtype):
    """tests/test_paged_attn.py's construction: contiguous per-row page
    runs, trash entries past each row's extent, a length-0 row and a
    single-page row. Returns the JAX operands."""
    n_pages = b * t + 2
    q = jnp.asarray(rng.standard_normal((b, hkv * g, dk)), jnp.float32)
    kp = jnp.asarray(rng.standard_normal((n_pages, page, hkv, dk)), dtype)
    vp = jnp.asarray(rng.standard_normal((n_pages, page, hkv, dv)), dtype)
    lens = rng.integers(0, t * page + 1, b)
    lens[0] = 0
    if b > 1:
        lens[1] = min(page, t * page)
    pt = np.zeros((b, t), np.int32)
    ids = rng.permutation(np.arange(1, n_pages))[: b * t]
    pt.flat[: len(ids)] = ids
    for i in range(b):
        pt[i, (lens[i] + page - 1) // page:] = 0
    return q, kp, vp, jnp.asarray(pt), jnp.asarray(lens, jnp.int32)


@pytest.mark.parametrize("seed,case", list(enumerate(GQA_CASES)))
def test_plain_k4_matches_reference_and_interpret_kernel(seed, case):
    b, t, page, hkv, g, dk, dv, dtype, ns = case
    q, kp, vp, pt, lens = _gqa_case(np.random.default_rng(seed), b, t, page,
                                    hkv, g, dk, dv, dtype)
    got = kpa.paged_decode_attention(
        *(_torch(a) for a in (q, kp, vp, pt, lens)), n_splits=ns).numpy()
    want = jpaged_decode_attention(q, kp, vp, pt, lens, n_splits=ns,
                                   use_pallas=False)
    interp = jpaged_decode_attention(q, kp, vp, pt, lens, n_splits=ns,
                                     use_pallas=True, interpret=True)
    for label, ref in (("reference", want), ("interpret kernel", interp)):
        rep = tolerance_report(got, ref)
        assert rep["max_abs"] < K4_TOL, f"{case} vs {label}: {rep}"
    assert np.all(got[np.asarray(lens) == 0] == 0.0)
    assert kpa.paged_decode_attention.launches == 0  # CPU: plain version


def test_kv_cap_is_neutral_on_the_port():
    """A table prefix covering every row's length gives the same output:
    bitwise with one split, and the reference's own cap case (two splits,
    4 of 8 pages) within the K4 tolerance of the full table."""
    rng = np.random.default_rng(11)
    q, kp, vp, pt, lens = _gqa_case(rng, 2, 8, 4, 2, 2, 16, 16, "float32")
    lens = jnp.minimum(lens, 4 * 4)  # the live extent fits 4 of 8 pages
    q, kp, vp, pt, lens = (_torch(a) for a in (q, kp, vp, pt, lens))
    for ns, t_cap in ((1, 4), (1, 5), (2, 4)):
        full = kpa.paged_decode_attention(q, kp, vp, pt, lens, n_splits=ns)
        capped = kpa.paged_decode_attention(q, kp, vp, pt[:, :t_cap], lens,
                                            n_splits=ns)
        rep = tolerance_report(capped.numpy(), full.numpy())
        if ns == 1:
            assert rep["exact"], (t_cap, rep)
        assert rep["max_abs"] < K4_TOL, (ns, t_cap, rep)


def test_split_count_lookup_and_normalization():
    """_norm_splits cuts to the largest divisor of the table extent; the
    autotuner's lookup order is exact rows key, rows-agnostic key, nearest
    recorded shape, then 1; record() pins a value for the process."""
    assert [kpa._norm_splits(n, 8, page_size=16, heads=16, head_dim=128)
            for n in (1, 3, 4, 16)] == [1, 2, 4, 8]
    assert kpa._norm_splits(4, 6, page_size=16, heads=16,
                            head_dim=128) == 3
    saved = autotune._persisted
    try:
        autotune.clear_memo()
        autotune._persisted = {"p16_h16_d128": 4, "p16_h16_d128_r4": 2}
        assert autotune.best_n_splits(16, 16, 128, rows=4) == 2
        assert autotune.best_n_splits(16, 16, 128, rows=8) == 4
        assert autotune.best_n_splits(8, 16, 128) == 4        # nearest
        autotune._persisted = {}
        assert autotune.best_n_splits(8, 4, 32, rows=2) == 1  # empty
        autotune.record(8, 4, 32, 4, rows=2)
        assert autotune.best_n_splits(8, 4, 32, rows=2) == 4
    finally:
        autotune.clear_memo()
        autotune._persisted = saved
    # The committed record parses and holds positive split counts.
    assert all(v >= 1 for v in autotune._load_persisted().values())
