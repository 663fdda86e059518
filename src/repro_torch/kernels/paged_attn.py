"""K4: fused split-K flash-decoding over the paged KV pool (DESIGN.md §9).

Replaces the Pallas TPU kernel ``_gqa_kernel`` / ``_gqa_pallas`` and its
``_combine`` of ``repro.kernels.paged_attn``; the CUDA source is
``csrc/paged_attn_gqa.cu``. The kernel walks each row's page table itself,
one block per (split, kv-head, row), reads the live pages straight from
the shared pool, and emits per-split online-softmax state (m, l, acc); a
second kernel combines the splits:

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
``paged_decode_attention.launches`` (one per call; each call runs the
split kernel and the combine).

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

The MLA entry point (``paged_decode_mla``, K5) comes with the MLA slice.
"""
from __future__ import annotations

import math
from typing import Optional

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
                                          rows=rows)
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


def _gqa_kernel(q: Tensor, k_pool: Tensor, v_pool: Tensor, pt: Tensor,
                lengths: Tensor, *, scale: float, n_splits: int) -> Tensor:
    """Launch K4 (split kernel + combine) on CUDA tensors."""
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
    if h % hkv or h // hkv > 16 or max(dk, dv) > 256:
        raise ValueError(f"K4 takes G = H/Hkv <= 16 and head dims <= 256; "
                         f"got H={h} Hkv={hkv} Dk={dk} Dv={dv}")
    lib = _build.load("paged_attn_gqa")
    ts = pt.shape[1] // n_splits
    smem = lib.paged_attn_gqa_smem(h // hkv, dk, ts * page)
    if smem > _MAX_SMEM:
        raise ValueError(f"a split of {ts * page} positions needs {smem} "
                         "bytes of shared memory; raise n_splits")
    qf = q.to(torch.float32).contiguous()
    m = torch.empty((b, n_splits, h), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((b, n_splits, h, dv), dtype=torch.float32, device=dev)
    out = torch.empty((b, h, dv), dtype=torch.float32, device=dev)
    err = lib.paged_attn_gqa(
        qf.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pt.data_ptr(),
        lengths.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        out.data_ptr(), b, h, hkv, dk, dv, p, page, ts, n_splits,
        pt.stride(0), scale, int(k_pool.dtype == torch.bfloat16),
        _build.stream_ptr())
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
