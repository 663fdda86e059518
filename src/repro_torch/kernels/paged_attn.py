"""K4: fused split-K flash-decoding over the paged KV pool (DESIGN.md §9).

Replaces the Pallas TPU kernel ``_gqa_kernel`` / ``_gqa_pallas`` and its
``_combine`` of ``repro.kernels.paged_attn``; the CUDA source is
``csrc/paged_attn_gqa.cu``. One launch per call: one block per (split,
kv-head, row) reads its slice of the row's page table, stages the live
pages' K and V rows from the shared pool into shared memory with bulk
copies, and computes its split's softmax state (m, l, acc) in two passes;
the split blocks of a (kv-head, row) form one thread-block cluster and
combine their states over distributed shared memory, in split order:

    m* = max_s m_s,   l* = sum_s l_s * exp(m_s - m*),
    out = sum_s acc_s * exp(m_s - m*) / max(l*, 1e-30).

Masking contract: row b attends to positions ``pos < lengths[b]``
(``lengths`` includes the just-written token). Length-0 rows return exact
zeros; entries past a row's extent (the trash page 0) are never mixed in.
A page-table prefix that covers every row's length (the engine's KV-extent
cap) may be passed.

Beside the kernel: its plain version (:func:`_gqa_plain` +
:func:`_combine`), which mirrors the reference's ``_gqa_ref`` and
``_combine`` op for op (same split partition, same ``NEG``, explicit
zeroing of masked lanes, ``max(l*, 1e-30)``), and a launch counter,
``paged_decode_attention.launches`` (one per call). :func:`k4_plan` sizes
the launch (cluster, ring depth, shared memory) and
:func:`k4_ring_schedule` spells out the order in which a block stages its
split's pages.

Every sum (the score dot products, ``l``, ``p @ V`` and the combine's
sums over splits) is accumulated in float64 from exact products of
float32 values and rounded once to float32, in the plain version and in
the kernel alike. The two then agree bitwise whatever order each sums in
(an order changes only float64 rounding, which the final rounding hides
but at a tie); the exponentials and the elementwise steps are the same
float32 operations. The reference sums in float32, so it differs from
both by its summation order's rounding: greedy streams through a
bf16/TimeFloats model amplify such ulps, and only a bitwise kernel keeps
its drain identical to the plain drain.

K5, the absorbed-MLA entry point (:func:`paged_decode_mla`, CUDA source
``csrc/paged_attn_mla.cu``), replaces ``_mla_kernel`` / ``_mla_pallas``:
latent and rope queries against the ``(P, page, C)`` / ``(P, page, R)``
pools, scores ``(q_lat·c_kv + q_rope·k_rope)·scale``, values the c_kv
latents. Like K4 it is one launch per call: the split blocks of a (group
of up to 16 heads, row) form one cluster, stage the live latent and rope
rows once through a ring of page slots, and combine their states in split
order over distributed shared memory; :func:`k5_plan` sizes the launch
(heads a block, cluster, ring, shared memory) and
:func:`k5_ring_schedule` spells out the stagings. Its plain version
(:func:`_mla_plain`, through :func:`_attend_block_mla`) runs the
reference's single-group MQA over the concatenated C+R features through
the GQA block above, and shares :func:`_combine`; the same float64
accumulation holds in both, and its counter is
``paged_decode_mla.launches`` (one per call).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, autotune, dispatch

Tensor = torch.Tensor
NEG = -0.7 * float(torch.finfo(torch.float32).max)
_EPS = 1e-30
_MAX_SMEM = 227 * 1024   # dynamic shared memory a Hopper block can use


def _norm_splits(n_splits: Optional[int], n_table: int, *, page_size: int,
                 heads: int, head_dim: int,
                 rows: Optional[int] = None) -> int:
    """The split count: ``n_splits`` or the autotuner's, cut to the
    largest divisor of the table extent that does not exceed it."""
    if n_splits is None:
        n_splits = autotune.best_n_splits(page_size, heads, head_dim,
                                          rows=rows, pages=n_table)
    n_splits = max(1, min(int(n_splits), n_table))
    while n_table % n_splits:
        n_splits -= 1
    return n_splits


def _attend_block_gqa(q: Tensor, k: Tensor, v: Tensor, start: int,
                      length: Tensor, scale: float):
    """One split for every row. q (B, Hkv, G, Dk); k (B, J, Hkv, Dk);
    v (B, J, Hkv, Dv); float32. Returns m, l (B, Hkv, G) and acc
    (B, Hkv, G, Dv), the unnormalized split state."""
    j = k.shape[1]
    pos = start + torch.arange(j, dtype=torch.int32, device=q.device)
    valid = (pos[None, :] < length[:, None])[:, None, None, :]  # (B,1,1,J)
    f64 = torch.float64
    s = torch.einsum("bkgd,bjkd->bkgj", q.to(f64), k.to(f64)
                     ).to(torch.float32) * scale
    s = torch.where(valid, s, NEG)
    m = s.amax(dim=-1)
    # Explicit zeroing: a fully masked split has m == NEG, where
    # exp(s - m) would be 1 on every masked lane.
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.to(f64).sum(dim=-1).to(torch.float32)
    acc = torch.einsum("bkgj,bjkd->bkgd", p.to(f64), v.to(f64)
                       ).to(torch.float32)
    return m, l, acc


def _gqa_plain(q: Tensor, k_pool: Tensor, v_pool: Tensor, pt: Tensor,
               lengths: Tensor, *, scale: float, n_splits: int):
    """Split state (m, l (B, S, H), acc (B, S, H, Dv)) as the reference's
    ``_gqa_ref`` computes it."""
    b, h, dk = q.shape
    _, page, hkv, _ = k_pool.shape
    dv = v_pool.shape[-1]
    g = h // hkv
    ts = pt.shape[1] // n_splits
    qf = q.to(torch.float32).reshape(b, hkv, g, dk)
    lengths = lengths.to(torch.int32)
    ms, ls, accs = [], [], []
    for s in range(n_splits):
        pts = pt[:, s * ts:(s + 1) * ts].to(torch.int64)
        ks = k_pool[pts].to(torch.float32).reshape(b, ts * page, hkv, dk)
        vs = v_pool[pts].to(torch.float32).reshape(b, ts * page, hkv, dv)
        m, l, acc = _attend_block_gqa(qf, ks, vs, s * ts * page, lengths,
                                      scale)
        ms.append(m.reshape(b, h))
        ls.append(l.reshape(b, h))
        accs.append(acc.reshape(b, h, dv))
    return torch.stack(ms, 1), torch.stack(ls, 1), torch.stack(accs, 1)


def _combine(m: Tensor, l: Tensor, acc: Tensor) -> Tensor:
    """Reduce split state over axis 1. m, l (B, S, N); acc (B, S, N, Dv).
    All-masked rows (every split at m == NEG) come out exactly zero."""
    m_star = m.amax(dim=1)
    alpha = torch.exp(m - m_star[:, None]).to(torch.float64)
    l_star = (l.to(torch.float64) * alpha).sum(dim=1).to(torch.float32)
    acc_star = (acc.to(torch.float64) * alpha[..., None]).sum(dim=1
                                                             ).to(torch.float32)
    return acc_star / torch.clamp_min(l_star, _EPS)[..., None]


class K4Plan(NamedTuple):
    """How K4 launches for one call: ``cluster`` blocks per cluster (the
    split count: the splits of a (kv-head, row) are reduced inside their
    cluster, so one launch does the whole call), ``ring`` page slots of K
    and of V per block, ``smem`` bytes of dynamic shared memory a block."""
    cluster: int
    ring: int
    smem: int


K4_MAX_CLUSTER = 8    # the portable cluster size
K4_RING_MAX = 8       # page slots in flight per block, for K and for V
K4_MAX_G = 16
K4_MAX_DIM = 256


def _k4_smem(g: int, dk: int, dv: int, page: int, ts: int, n_splits: int,
             ring: int, itemsize: int) -> int:
    """Bytes of K4's shared-memory layout (``layout`` in
    csrc/paged_attn_gqa.cu; the entry point rejects a size it disagrees
    with): mbarriers, page ids, q as double, the split's G x ts*page
    scores (float) and p (double), the second row group's sums of pass 2,
    the inbox of every split's (m, l, acc) for the block's share of the
    outputs, and the K and V rings; K rows are padded to whole 16-byte
    vectors of pool elements, q to whole chunks of eight such vectors."""
    def a16(n: int) -> int:
        return -(-n // 16) * 16
    vec = 16 // itemsize
    dkp = -(-dk // vec) * vec
    q_dims = -(-dk // (8 * vec)) * 8 * vec   # q in whole chunks of 8 vectors
    span, per = ts * page, -(-(g * dv) // n_splits)
    return (a16(16 * ring) + a16(4 * ts) + a16(8 * g * q_dims)
            + a16(4 * g * span) + a16(8 * g * span) + a16(8 * g * dv)
            + 2 * a16(4 * n_splits * g) + a16(4 * n_splits * per)
            + ring * (a16(page * dkp * itemsize) + a16(page * dv * itemsize)))


def k4_plan(g: int, dk: int, dv: int, page: int, ts: int, n_splits: int,
            itemsize: int) -> K4Plan:
    """K4's launch plan for G query heads per kv-head, head dims Dk/Dv,
    ``ts`` pages per split, ``n_splits`` splits and pools of ``itemsize``
    bytes: the deepest ring up to ``K4_RING_MAX`` pages (never more than
    a split holds) that fits beside the scores. Raises ValueError for what
    the kernel cannot hold."""
    if g < 1 or g > K4_MAX_G or min(dk, dv) < 1 or max(dk, dv) > K4_MAX_DIM:
        raise ValueError(f"K4 takes G = H/Hkv <= {K4_MAX_G} and head dims "
                         f"<= {K4_MAX_DIM}; got G={g} Dk={dk} Dv={dv}")
    if not 1 <= n_splits <= K4_MAX_CLUSTER:
        raise ValueError(f"K4 reduces a row's splits inside one cluster of "
                         f"at most {K4_MAX_CLUSTER} blocks; got "
                         f"n_splits={n_splits}")
    ring = min(ts, K4_RING_MAX)
    while ring > 1 and _k4_smem(g, dk, dv, page, ts, n_splits, ring,
                                itemsize) > _MAX_SMEM:
        ring -= 1
    smem = _k4_smem(g, dk, dv, page, ts, n_splits, ring, itemsize)
    if smem > _MAX_SMEM:
        raise ValueError(f"a split of {ts * page} positions needs {smem} "
                         "bytes of shared memory; raise n_splits")
    return K4Plan(n_splits, ring, smem)


def k4_ring_schedule(live: int, page: int, ring: int):
    """The copies a K4 block makes for a split of ``live`` positions, in
    issue order (the same for its K ring and its V ring): tuples (page,
    slot, parity, rows, after). Page i goes to slot i % ring with mbarrier
    parity (i // ring) & 1; the first ``ring`` pages are issued at block
    start (after = -1), page i >= ring once every warp is done with page
    i - ring (after = i - ring). Only the ``rows`` live positions of a page
    are copied."""
    n = -(-live // page)
    return [(i, i % ring, (i // ring) & 1, min(page, live - i * page),
             -1 if i < ring else i - ring) for i in range(n)]


def _gqa_kernel(q: Tensor, k_pool: Tensor, v_pool: Tensor, pt: Tensor,
                lengths: Tensor, *, scale: float, n_splits: int) -> Tensor:
    """Launch K4 on CUDA tensors: one launch per call."""
    dev = q.device
    if not all(t.is_cuda and t.device == dev
               for t in (k_pool, v_pool, pt, lengths)):
        raise ValueError("all operands must lie on the same CUDA device")
    if k_pool.dtype != v_pool.dtype or k_pool.dtype not in (
            torch.bfloat16, torch.float32):
        raise TypeError("k_pool and v_pool must both be bfloat16 or float32")
    if pt.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()
            and lengths.is_contiguous() and pt.stride(1) == 1):
        raise ValueError("pools and lengths must be contiguous and the "
                         "page table unit-strided along T")
    b, h, dk = q.shape
    p, page, hkv, _ = k_pool.shape
    dv = v_pool.shape[-1]
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    ts = pt.shape[1] // n_splits
    plan = k4_plan(h // hkv, dk, dv, page, ts, n_splits,
                   k_pool.element_size())
    if q.dtype not in (torch.bfloat16, torch.float32):
        q = q.to(torch.float32)
    q = q.contiguous()
    lib = _build.load("paged_attn_gqa")
    out = torch.empty((b, h, dv), dtype=torch.float32, device=dev)
    err = lib.paged_attn_gqa(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pt.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, h, hkv, dk, dv, p, page, ts,
        plan.cluster, plan.ring, pt.stride(0), scale,
        int(k_pool.dtype == torch.bfloat16), int(q.dtype == torch.bfloat16),
        plan.smem, _build.stream_ptr())
    _build.check(err, "paged_attn_gqa")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                           page_table: Tensor, lengths: Tensor, *,
                           scale: Optional[float] = None,
                           n_splits: Optional[int] = None) -> Tensor:
    """Fused paged GQA/MQA decode attention.

    q (B, H, Dk); k_pool (P, page, Hkv, Dk); v_pool (P, page, Hkv, Dv);
    page_table (B, T) int32; lengths (B,) int32. Returns (B, H, Dv)
    float32. A CUDA q launches K4 (or raises); a CPU q runs the plain
    version. ``n_splits`` None asks the autotuner (rows = B)."""
    b, h, dk = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    ns = _norm_splits(n_splits, page_table.shape[1],
                      page_size=k_pool.shape[1], heads=h, head_dim=dk,
                      rows=b)
    if dispatch.use_kernel(q):
        return _gqa_kernel(q, k_pool, v_pool, page_table, lengths,
                           scale=float(scale), n_splits=ns)
    return _combine(*_gqa_plain(q, k_pool, v_pool, page_table, lengths,
                                scale=float(scale), n_splits=ns))


paged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# K5: absorbed-MLA decode (MQA in latent space)
# ---------------------------------------------------------------------------


def _attend_block_mla(q_lat: Tensor, q_rope: Tensor, ckv: Tensor,
                      kr: Tensor, start: int, length: Tensor, scale: float):
    """One MLA split for every row, as the reference's: q_lat (B, H, C),
    q_rope (B, H, R), ckv (B, J, C), kr (B, J, R), float32, through the
    GQA block as single-group MQA over the concatenated C+R features.
    Returns m, l (B, H) and acc (B, H, C)."""
    q = torch.cat([q_lat, q_rope], dim=-1)[:, None]   # (B, 1, H, C+R)
    k = torch.cat([ckv, kr], dim=-1)[:, :, None]      # (B, J, 1, C+R)
    v = ckv[:, :, None]                               # (B, J, 1, C)
    m, l, acc = _attend_block_gqa(q, k, v, start, length, scale)
    return m[:, 0], l[:, 0], acc[:, 0]


def _mla_plain(q_lat: Tensor, q_rope: Tensor, ckv_pool: Tensor,
               kr_pool: Tensor, pt: Tensor, lengths: Tensor, *,
               scale: float, n_splits: int):
    """Split state (m, l (B, S, H), acc (B, S, H, C)) as the reference's
    ``_mla_ref`` computes it."""
    b, _, c = q_lat.shape
    r = q_rope.shape[-1]
    page = ckv_pool.shape[1]
    ts = pt.shape[1] // n_splits
    qlf = q_lat.to(torch.float32)
    qrf = q_rope.to(torch.float32)
    lengths = lengths.to(torch.int32)
    ms, ls, accs = [], [], []
    for s in range(n_splits):
        pts = pt[:, s * ts:(s + 1) * ts].to(torch.int64)
        cs = ckv_pool[pts].to(torch.float32).reshape(b, ts * page, c)
        rs = kr_pool[pts].to(torch.float32).reshape(b, ts * page, r)
        m, l, acc = _attend_block_mla(qlf, qrf, cs, rs, s * ts * page,
                                      lengths, scale)
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    return torch.stack(ms, 1), torch.stack(ls, 1), torch.stack(accs, 1)


class K5Plan(NamedTuple):
    """How K5 launches for one call: ``heads_per_block`` query heads a
    block (HG; the grid is (S, ceil(H/HG), B)), ``cluster`` blocks per
    cluster (the split count: a (head group, row)'s splits are reduced
    inside their cluster, so one launch does the whole call), ``ring`` page
    slots per block, ``smem`` bytes of dynamic shared memory a block."""
    heads_per_block: int
    cluster: int
    ring: int
    smem: int


K5_MAX_CLUSTER = 8    # the portable cluster size
K5_RING_MAX = 8       # page slots per block
K5_MAX_HG = 16        # query heads a block
K5_MAX_C = 512        # latent width
K5_MAX_R = 128        # rope width
_K5_WARPS, _K5_ROWS = 8, 16   # kWarps, kRows of csrc/paged_attn_mla.cu


def _k5_smem(hg: int, c: int, r: int, page: int, ts: int, n_splits: int,
             ring: int, itemsize: int) -> int:
    """Bytes of K5's shared-memory layout (``layout`` in
    csrc/paged_attn_mla.cu; the entry point rejects a size it disagrees
    with): the slots' mbarriers, page ids, q as double, the split's
    scores and then p (as double, ``maxg + 2`` a position), pass 1's sums
    over warps, the inbox of every split's (m, l, acc) for the block's share
    of the outputs, and the ring. A staged row holds the latent and then the
    rope, each padded to whole 16-byte vectors of pool elements, and one
    vector more."""
    def a16(n: int) -> int:
        return -(-n // 16) * 16

    def up(n: int, m: int) -> int:
        return -(-n // m) * m
    vec = 16 // itemsize
    d2 = up(c, vec) + up(r, vec)
    maxg = 4 if hg <= 4 else (8 if hg <= 8 else K5_MAX_HG)
    per = -(-(hg * c) // n_splits)
    return (a16(8 * ring) + a16(4 * ts) + a16(8 * hg * d2)
            + a16(8 * ts * page * (maxg + 2))
            + a16(8 * _K5_WARPS * maxg * _K5_ROWS)
            + 2 * a16(4 * n_splits * hg) + a16(4 * n_splits * per)
            + ring * a16(page * (d2 + vec) * itemsize))


def k5_plan(h: int, c: int, r: int, page: int, ts: int, n_splits: int,
            itemsize: int) -> K5Plan:
    """K5's launch plan for H query heads, latent width C, rope width R,
    ``ts`` pages per split, ``n_splits`` splits and pools of ``itemsize``
    bytes: the most heads a block (up to ``K5_MAX_HG``, halved until the
    layout fits), then the deepest ring up to ``K5_RING_MAX`` pages (never
    more than a split holds) that fits beside them. A split longer than its
    ring stages its latents twice (``k5_ring_schedule``). Raises ValueError
    for what the kernel cannot hold."""
    if h < 1 or not 1 <= c <= K5_MAX_C or not 0 <= r <= K5_MAX_R:
        raise ValueError(f"K5 takes H >= 1, C <= {K5_MAX_C} and R <= "
                         f"{K5_MAX_R}; got H={h} C={c} R={r}")
    if not 1 <= n_splits <= K5_MAX_CLUSTER:
        raise ValueError(f"K5 reduces a row's splits inside one cluster of "
                         f"at most {K5_MAX_CLUSTER} blocks; got "
                         f"n_splits={n_splits}")
    if page < 1 or ts < 1:
        raise ValueError(f"page={page} and ts={ts} must be >= 1")
    hg = min(h, K5_MAX_HG)
    while hg > 1 and _k5_smem(hg, c, r, page, ts, n_splits, 1,
                              itemsize) > _MAX_SMEM:
        hg = -(-hg // 2)
    ring = min(ts, K5_RING_MAX)
    while ring > 1 and _k5_smem(hg, c, r, page, ts, n_splits, ring,
                                itemsize) > _MAX_SMEM:
        ring -= 1
    smem = _k5_smem(hg, c, r, page, ts, n_splits, ring, itemsize)
    if smem > _MAX_SMEM:
        raise ValueError(f"a split of {ts * page} positions needs {smem} "
                         "bytes of shared memory; raise n_splits")
    return K5Plan(hg, n_splits, ring, smem)


def k5_ring_schedule(live: int, page: int, ring: int):
    """The stagings a K5 block makes for a split of ``live`` positions, in
    issue order: tuples (page, slot, parity, rows, after, rope). Pass 1
    takes K4's order (:func:`k4_ring_schedule`) with the rope rows; when
    the split has more pages than the ring, pass 2 walks the pages again
    (latent rows only), staging k going to slot k % ring at parity
    (k // ring) & 1 once staging k - ring is consumed. Otherwise pass 2
    reads the pages where pass 1 left them."""
    first = [c + (True,) for c in k4_ring_schedule(live, page, ring)]
    n = len(first)
    if n <= ring:
        return first
    return first + [(i, k % ring, (k // ring) & 1, rows, k - ring, False)
                    for k, (i, _, _, rows, _, _) in enumerate(first, n)]


def _mla_kernel(q_lat: Tensor, q_rope: Tensor, ckv_pool: Tensor,
                kr_pool: Tensor, pt: Tensor, lengths: Tensor, *,
                scale: float, n_splits: int) -> Tensor:
    """Launch K5 on CUDA tensors: one launch per call, no scratch."""
    dev = q_lat.device
    if not all(t.is_cuda and t.device == dev
               for t in (q_rope, ckv_pool, kr_pool, pt, lengths)):
        raise ValueError("all operands must lie on the same CUDA device")
    if ckv_pool.dtype != kr_pool.dtype or ckv_pool.dtype not in (
            torch.bfloat16, torch.float32):
        raise TypeError("ckv_pool and kr_pool must both be bfloat16 or "
                        "float32")
    if pt.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    if not (ckv_pool.is_contiguous() and kr_pool.is_contiguous()
            and lengths.is_contiguous() and pt.stride(1) == 1):
        raise ValueError("pools and lengths must be contiguous and the "
                         "page table unit-strided along T")
    b, h, c = q_lat.shape
    r = q_rope.shape[-1]
    p, page = ckv_pool.shape[:2]
    if (q_rope.shape[:2] != (b, h) or kr_pool.shape[:2] != (p, page)
            or ckv_pool.shape[2] != c or kr_pool.shape[2] != r):
        raise ValueError("q_lat (B,H,C), q_rope (B,H,R) and the pools "
                         "(P,page,C), (P,page,R) disagree")
    ts = pt.shape[1] // n_splits
    plan = k5_plan(h, c, r, page, ts, n_splits, ckv_pool.element_size())
    qs = []
    for q in (q_lat, q_rope):
        if q.dtype not in (torch.bfloat16, torch.float32):
            q = q.to(torch.float32)
        if q.stride(-1) != 1:
            q = q.contiguous()
        qs.append(q)
    q_lat, q_rope = qs
    lib = _build.load("paged_attn_mla")
    out = torch.empty((b, h, c), dtype=torch.float32, device=dev)
    err = lib.paged_attn_mla(
        q_lat.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(),
        kr_pool.data_ptr(), pt.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, h, plan.heads_per_block, c, r, p, page, ts,
        plan.cluster, plan.ring, pt.stride(0), q_lat.stride(0),
        q_lat.stride(1), q_rope.stride(0), q_rope.stride(1), scale,
        int(ckv_pool.dtype == torch.bfloat16),
        int(q_lat.dtype == torch.bfloat16),
        int(q_rope.dtype == torch.bfloat16), plan.smem, _build.stream_ptr())
    _build.check(err, "paged_attn_mla")
    paged_decode_mla.launches += 1
    return out


def paged_decode_mla(q_lat: Tensor, q_rope: Tensor, ckv_pool: Tensor,
                     kr_pool: Tensor, page_table: Tensor, lengths: Tensor, *,
                     scale: float, n_splits: Optional[int] = None) -> Tensor:
    """Fused paged absorbed-MLA decode.

    q_lat (B, H, C) (queries absorbed into the latent space), q_rope
    (B, H, R); pools (P, page, C) / (P, page, R); page_table (B, T) int32;
    lengths (B,) int32. scores = (q_lat·c_kv + q_rope·k_rope)·scale, values
    are the c_kv latents. Returns the latent attention output (B, H, C)
    float32 (the caller applies W_v_b). ``scale`` is required: it depends
    on the pre-absorption head dims (nope + rope), not on C. A CUDA q_lat
    launches K5 (or raises); a CPU one runs the plain version."""
    b, h, c = q_lat.shape
    ns = _norm_splits(n_splits, page_table.shape[1],
                      page_size=ckv_pool.shape[1], heads=h,
                      head_dim=c + q_rope.shape[-1], rows=b)
    if dispatch.use_kernel(q_lat):
        return _mla_kernel(q_lat, q_rope, ckv_pool, kr_pool, page_table,
                           lengths, scale=float(scale), n_splits=ns)
    return _combine(*_mla_plain(q_lat, q_rope, ckv_pool, kr_pool,
                                page_table, lengths, scale=float(scale),
                                n_splits=ns))


paged_decode_mla.launches = 0
