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


# K4's launch plan (``k4_plan``) and ring order (``k4_ring_schedule``): the
# card runs what these describe; chip_smoke.py holds the kernel itself.
QWEN3_DECODE = (2, 128, 128, 16, "bfloat16")  # G, Dk, Dv, page, pool
PLAN_SHAPES = [QWEN3_DECODE] + [(c[4], c[5], c[6], c[2], c[7])
                                for c in GQA_CASES]
ITEMSIZE = {"float32": 4, "bfloat16": 2}


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_k4_plan_is_one_launch_for_every_split_count(shape):
    """At caps 1, 8 and 32 and every n_splits the smoke takes, the splits
    of a (kv-head, row) form one cluster (so one launch reduces them) and
    the ring holds every page of a split up to K4_RING_MAX."""
    g, dk, dv, page, dtype = shape
    for cap in (1, 8, 32):
        for n in (1, 2, 4, 8):
            ns = kpa._norm_splits(n, cap, page_size=page, heads=g,
                                  head_dim=dk)
            ts = cap // ns
            plan = kpa.k4_plan(g, dk, dv, page, ts, ns, ITEMSIZE[dtype])
            assert plan.cluster == ns <= kpa.K4_MAX_CLUSTER
            assert plan.ring == min(ts, kpa.K4_RING_MAX), (cap, n, plan)
            assert plan.smem == kpa._k4_smem(g, dk, dv, page, ts, ns,
                                             plan.ring, ITEMSIZE[dtype])
            assert plan.smem <= kpa._MAX_SMEM


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("g,dk,dv", [(2, 128, 128), (16, 256, 256),
                                     (4, 32, 16)])
def test_k4_plan_fits_shared_memory_up_to_the_engine_extent(itemsize, g, dk,
                                                            dv):
    """bf16 and f32 pools up to max_len 512 at page 16 (32 pages): every
    split count fits the 227 KB a block can use; the ring is cut only where
    the widest heads would not fit, never below one page."""
    for ns in (1, 2, 4, 8):
        ts = 32 // ns
        plan = kpa.k4_plan(g, dk, dv, 16, ts, ns, itemsize)
        assert plan.smem <= 227 * 1024
        assert 1 <= plan.ring <= min(ts, kpa.K4_RING_MAX)
        if plan.ring < min(ts, kpa.K4_RING_MAX):
            assert kpa._k4_smem(g, dk, dv, 16, ts, ns, plan.ring + 1,
                                itemsize) > kpa._MAX_SMEM


@pytest.mark.parametrize("args,what", [
    ((2, 128, 128, 16, 2, 16, 2), "cluster"),     # 16 splits
    ((2, 128, 128, 16, 4, 9, 2), "cluster"),      # 9 splits
    ((17, 128, 128, 16, 4, 1, 2), "G = H/Hkv"),
    ((2, 512, 128, 16, 4, 1, 2), "head dims"),
    ((16, 256, 256, 16, 4096, 1, 4), "raise n_splits"),   # 65536 scores
])
def test_k4_plan_raises_past_its_limits(args, what):
    with pytest.raises(ValueError, match=what):
        kpa.k4_plan(*args)


@pytest.mark.parametrize("ring", [1, 3, 8])
@pytest.mark.parametrize("live", [0, 1, 15, 16, 17, 100, 512])
def test_k4_ring_covers_each_live_page_once_in_order(live, ring):
    """Page i of the split goes to slot i % ring at parity (i // ring) & 1,
    exactly once and in order; the first ``ring`` pages are issued at block
    start, a later one only after page i - ring (the slot's last occupant)
    is consumed; only live rows are copied."""
    page = 16
    sched = kpa.k4_ring_schedule(live, page, ring)
    n = -(-live // page)
    assert [c[0] for c in sched] == list(range(n))
    assert sum(c[3] for c in sched) == live
    for i, slot, parity, rows, after in sched:
        assert slot == i % ring and parity == (i // ring) & 1
        assert 1 <= rows <= page and (rows == page or i == n - 1)
        assert after == (-1 if i < ring else i - ring)
    assert sum(c[4] == -1 for c in sched) == min(n, ring)


# K5's launch plan (``k5_plan``) and stagings (``k5_ring_schedule``): the
# card runs what these describe; chip_smoke.py holds the kernel itself.
DEEPSEEK_MLA = (128, 512, 64)   # H, latent C, rope R of deepseek-v3
K5_PLAN_SHAPES = [DEEPSEEK_MLA, (4, 32, 16), (1, 64, 16), (8, 16, 8),
                  (2, 8, 8), (16, 32, 16), (1, 32, 8), (4, 16, 16),
                  (6, 32, 16), (20, 64, 16)]   # tests/test_torch_mla.py's


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", K5_PLAN_SHAPES)
def test_k5_plan_is_one_launch_for_every_split_count(shape, itemsize):
    """At caps 1, 8 and 32 and every n_splits the smoke takes, the splits
    of a (head group, row) form one cluster (so one launch reduces them),
    the head groups cover H, and the layout fits the 227 KB a block can
    use."""
    h, c, r = shape
    for cap in (1, 8, 32):
        for n in (1, 2, 4, 8):
            ns = kpa._norm_splits(n, cap, page_size=16, heads=h,
                                  head_dim=c + r)
            ts = cap // ns
            plan = kpa.k5_plan(h, c, r, 16, ts, ns, itemsize)
            assert plan.cluster == ns <= kpa.K5_MAX_CLUSTER
            hg = plan.heads_per_block
            assert 1 <= hg <= min(h, kpa.K5_MAX_HG)
            assert -(-h // hg) * hg >= h > (-(-h // hg) - 1) * hg
            assert 1 <= plan.ring <= min(ts, kpa.K5_RING_MAX), (cap, n, plan)
            assert plan.smem == kpa._k5_smem(hg, c, r, 16, ts, ns,
                                             plan.ring, itemsize)
            assert plan.smem <= kpa._MAX_SMEM


@pytest.mark.parametrize("h", [1, 6, 16, 20, 128])
def test_k5_plan_head_groups_cover_h(h):
    """A block takes min(H, 16) heads where they fit; H = 1 and H = 6 are
    one group, H = 20 two (16 and 4), H = 128 eight."""
    plan = kpa.k5_plan(h, 512, 64, 16, 1, 8, 2)
    assert plan.heads_per_block == min(h, kpa.K5_MAX_HG)
    assert -(-h // plan.heads_per_block) == {1: 1, 6: 1, 16: 1, 20: 2,
                                              128: 8}[h]


def test_k5_plan_fits_shared_memory_up_to_the_engine_extent():
    """deepseek-v3's widths, bf16 pools of 16-token pages, every table
    extent up to max_len 512 (T <= 32 pages) at every S <= 8 dividing T:
    16 heads a block within 227 KB, the ring cut only where one more slot
    would not fit, never below one page."""
    h, c, r = DEEPSEEK_MLA
    for t in range(1, 33):
        for ns in (n for n in range(1, 9) if t % n == 0):
            ts = t // ns
            plan = kpa.k5_plan(h, c, r, 16, ts, ns, 2)
            assert plan.heads_per_block == 16 and plan.cluster == ns
            assert plan.smem <= 227 * 1024
            assert 1 <= plan.ring <= min(ts, kpa.K5_RING_MAX)
            if plan.ring < min(ts, kpa.K5_RING_MAX):
                assert kpa._k5_smem(16, c, r, 16, ts, ns, plan.ring + 1,
                                    2) > kpa._MAX_SMEM


@pytest.mark.parametrize("args,what", [
    ((128, 512, 64, 16, 2, 16, 2), "cluster"),      # 16 splits
    ((128, 512, 64, 16, 4, 9, 2), "cluster"),       # 9 splits
    ((128, 1024, 64, 16, 1, 8, 2), "C=1024"),       # latent too wide
    ((128, 512, 256, 16, 1, 8, 2), "R=256"),        # rope too wide
    ((128, 512, 64, 16, 4096, 1, 4), "raise n_splits"),   # 65536 positions
    ((128, 512, 64, 1024, 1, 1, 4), "raise n_splits"),    # a 2.3 MB page
])
def test_k5_plan_raises_past_its_limits(args, what):
    with pytest.raises(ValueError, match=what):
        kpa.k5_plan(*args)


@pytest.mark.parametrize("ring", [1, 3, 8])
@pytest.mark.parametrize("live", [0, 1, 15, 16, 17, 100, 512])
def test_k5_ring_stages_each_live_page_once_a_pass(live, ring):
    """Pass 1 stages the split's pages in K4's order, with the rope rows;
    pass 2 reads them where pass 1 left them while the ring holds the
    split, and otherwise stages every page's latents once more, in order,
    staging k in slot k % ring at parity (k // ring) & 1 once staging
    k - ring is consumed."""
    page = 16
    sched = kpa.k5_ring_schedule(live, page, ring)
    n = -(-live // page)
    first = [c for c in sched if c[5]]
    again = [c for c in sched if not c[5]]
    assert [c[:5] for c in first] == kpa.k4_ring_schedule(live, page, ring)
    assert sched == first + again
    assert [c[0] for c in again] == (list(range(n)) if n > ring else [])
    for k, (i, slot, parity, rows, after, _) in enumerate(sched):
        assert slot == k % ring and parity == (k // ring) & 1
        assert after == (-1 if k < ring else k - ring)
        assert 1 <= rows <= page and (rows == page or i == n - 1)
    assert sum(c[3] for c in first) == live
