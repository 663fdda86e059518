"""GQA attention (port of ``repro.models.attention``): the dense-cache and
paged-cache decode branches and the full-sequence blockwise branch.

Serving never runs the blockwise (flash-style) path: prefill writes its
K/V slab into the cache and attends through :func:`decode_attention` over
the whole ``max_len`` extent with ragged masks, exactly as the reference
does. Training (no cache) runs :func:`blockwise_attention`. On a paged
cache (:class:`PagedKVCache`, DESIGN.md §8) single-token decode runs the
fused split-K kernel K4 (``kernels/paged_attn``) over the table's
KV-extent prefix; prefill, and decode with ``fused=False``, read the
rows' dense view through the page gather K6 (``kernels/paged``) and attend
with :func:`decode_attention`. The speculative chain verify (DESIGN.md
§12, ``spec_verify``) writes a (B, K+1) chain at once: on a paged cache K4
runs over B·(K+1) flattened rows that share each slot's table, with
per-row lengths; on the dense cache the chain lands through
:func:`scatter_rows`, which drops writes past the row instead of clamping
the slab onto committed positions, and attends one chain column at a time.

Caches are updated in place (``cache_update``, ``paged_write``): the
reference returns new ones, but every caller here drops the old one, and
in-place writes save a cache- or pool-sized copy per layer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged import gather_pages
from repro_torch.kernels.paged_attn import paged_decode_attention
from repro_torch.models.common import ParamSpec, dense, dense_in, rms_norm, rope

Tensor = torch.Tensor
NEG = -0.7 * float(torch.finfo(torch.float32).max)


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    causal: bool = True
    prefix_len: int = 0          # bidirectional / window-exempt prefix
    window: Optional[int] = None  # kv_pos > q_pos - window


def mask_allowed(q_pos: Tensor, kv_pos: Tensor, mask: MaskSpec) -> Tensor:
    """Boolean visibility; q_pos, kv_pos broadcastable int tensors."""
    if mask.causal:
        allowed = kv_pos <= q_pos
    else:
        allowed = torch.ones(torch.broadcast_shapes(q_pos.shape, kv_pos.shape),
                             dtype=torch.bool, device=q_pos.device)
    if mask.prefix_len:
        allowed = allowed | ((q_pos < mask.prefix_len)
                             & (kv_pos < mask.prefix_len))
    if mask.window is not None:
        in_window = kv_pos > (q_pos - mask.window)
        if mask.prefix_len:
            in_window = in_window | (kv_pos < mask.prefix_len)
        allowed = allowed & in_window
    return allowed


class KVCache(NamedTuple):
    """Per-layer KV cache. k/v: (B, S_max, Hkv, D)."""

    k: Tensor
    v: Tensor


class PagedKVCache(NamedTuple):
    """Per-layer PAGED KV cache (DESIGN.md §8): k/v are page pools
    ``(P, page, Hkv, D)`` shared by every batch row; ``pt (B, T)`` int32 is
    the per-row page table (``T * page == max_len``). Page 0 is the
    reserved trash page: unassigned entries point there, so out-of-range
    or stale writes land in scratch instead of another row's pages."""

    k: Tensor
    v: Tensor
    pt: Tensor


def paged_write(pool: Tensor, new: Tensor, positions: Tensor,
                page_table: Tensor) -> Tensor:
    """Scatter ``new (B, S, *feat)`` into ``pool (P, page, *feat)`` in place
    at per-row start ``positions (B,)``: position ``p`` of row ``b`` lands
    in page ``page_table[b, p // page]`` at offset ``p % page``; positions
    past the table hit the trash page. Rows only ever share the trash
    page, so colliding writes land only there."""
    b, s = new.shape[:2]
    page = pool.shape[1]
    n_tab = page_table.shape[1]
    pos = (positions.to(torch.int64)[:, None]
           + torch.arange(s, dtype=torch.int64, device=new.device)[None, :])
    pslot = pos // page
    pids = torch.gather(page_table.to(torch.int64), 1,
                        torch.clamp_max(pslot, n_tab - 1))
    pids = torch.where(pslot < n_tab, pids, 0)
    pool[pids, pos % page] = new.to(pool.dtype)
    return pool


def paged_view(pool: Tensor, page_table: Tensor) -> Tensor:
    """Dense per-row read view ``(B, T*page, *feat)`` of a page pool
    through the page gather (K6)."""
    b, t = page_table.shape
    gathered = gather_pages(pool, page_table)  # (B, T, page, *feat)
    return gathered.reshape((b, t * pool.shape[1]) + tuple(pool.shape[2:]))


def fused_paged_ok(mask: MaskSpec, seq: int) -> bool:
    """The fused split-K kernel covers single-token decode under the plain
    causal mask; anything else takes the gather + softmax composition."""
    return (seq == 1 and mask.causal and mask.window is None
            and not mask.prefix_len)


def spec_verify_ok(mask: MaskSpec) -> bool:
    """The chain verify rides the fused kernel by flattening the (B, K+1)
    query chain into B·(K+1) independent rows with per-row lengths: sound
    only under the plain causal mask, the boundary of ``fused_paged_ok``."""
    return mask.causal and mask.window is None and not mask.prefix_len


def verify_rows(pt: Tensor, positions: Tensor, page: int
                ) -> tuple[Tensor, Tensor]:
    """The chain verify's kernel rows: each slot's table repeated once per
    chain position, and row lengths ``pos + 1`` clamped to the table's
    extent (an overhanging row near the cache end is computed, never
    emitted). positions (B, S); returns (B·S, T) and (B·S,) int32."""
    s = positions.shape[1]
    ptf = pt.repeat_interleave(s, dim=0)
    row_len = torch.clamp_max(positions.reshape(-1).to(torch.int32) + 1,
                              pt.shape[1] * page)
    return ptf, row_len


def _capped_pt(page_table: Tensor, page: int, kv_cap: Optional[int]
               ) -> Tensor:
    """The prefix of the page table covering ``kv_cap`` positions, the
    engine's KV-extent cap (DESIGN.md §9): the host guarantees every live
    row's length fits it. None (or an oversized cap) keeps the table."""
    if kv_cap is None:
        return page_table
    if kv_cap % page:
        raise ValueError(f"kv_cap {kv_cap} is not a multiple of the page "
                         f"size {page}")
    t_cap = max(1, min(kv_cap // page, page_table.shape[1]))
    return page_table[:, :t_cap]


def decode_attention(
    q: Tensor,            # (B, Sq, H, D)
    k: Tensor,            # (B, S_max, Hkv, D) — cache
    v: Tensor,
    q_positions: Tensor,  # (B, Sq) absolute positions of the queries
    lengths: Tensor,      # (B,) valid cache length (inclusive of new tokens)
    mask: MaskSpec,
) -> Tensor:
    """Masked softmax attention of the queries over the cache. Masked lanes
    are exact zeros after the softmax; a row with nothing visible (a dummy
    admission row of length 0) returns zeros."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qi = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)
    s = torch.einsum("bkgqd,bjkd->bkgqj", qi.to(torch.float32),
                     k.to(torch.float32)) * scale
    kv_pos = torch.arange(k.shape[1], device=q.device)
    ok = mask_allowed(q_positions[:, :, None], kv_pos[None, None, :], mask)
    ok = ok & (kv_pos[None, None, :] < lengths[:, None, None])
    ok = ok[:, None, None]
    s = torch.where(ok, s, NEG)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(ok, e / e.sum(dim=-1, keepdim=True), 0.0)
    out = torch.einsum("bkgqj,bjkd->bkgqd", p, v.to(torch.float32))
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv)


def _pad_seq(a: Tensor, mult: int) -> Tensor:
    pad = (-a.shape[1]) % mult
    if pad == 0:
        return a
    widths = [0, 0] * (a.ndim - 2) + [0, pad]  # F.pad lists the last dim first
    return torch.nn.functional.pad(a, widths)


def blockwise_attention(q: Tensor, k: Tensor, v: Tensor, mask: MaskSpec, *,
                        q_block: int, kv_block: int, q_offset: int = 0
                        ) -> Tensor:
    """Online-softmax attention over (q block, kv block) tiles; positions
    are ``q_offset + arange`` for q and ``arange`` for kv. q (B, Sq, H, D),
    k/v (B, Skv, Hkv, D). Blocks a causal or windowed mask hides entirely
    are skipped, as in the reference (whose kv loop is a scan; here it is a
    Python loop over the same block list)."""
    b, sq_in, h, d = q.shape
    dv = v.shape[-1]
    qb = min(q_block, sq_in)
    kvb = min(kv_block, k.shape[1])
    # Padded kv sits at positions past every real query, so the causal
    # mask excludes it; padded q rows are sliced off.
    q, k, v = _pad_seq(q, qb), _pad_seq(k, kvb), _pad_seq(v, kvb)
    sq, skv, hkv = q.shape[1], k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qr = q.reshape(b, sq // qb, qb, hkv, g, d).permute(1, 0, 3, 4, 2, 5)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    outs = []
    for i in range(sq // qb):
        qi = qr[i].to(torch.float32)  # (B, Hkv, G, qb, D)
        q_pos = q_offset + i * qb + torch.arange(qb, device=q.device)
        hi = min(skv, q_offset + (i + 1) * qb) if mask.causal else skv
        j_max = -(-hi // kvb)
        j_min = 0
        if mask.window is not None:
            j_min = max(0, q_offset + i * qb - mask.window + 1) // kvb
        blocks = list(range(j_min, j_max))
        if mask.prefix_len and j_min > 0:
            n_prefix = -(-mask.prefix_len // kvb)
            blocks = list(range(0, min(n_prefix, j_min))) + blocks
        m = torch.full((b, hkv, g, qb), NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, qb), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, qb, dv), dtype=torch.float32,
                          device=q.device)
        for j in blocks:
            kb = kf[:, j * kvb:(j + 1) * kvb]
            vb = vf[:, j * kvb:(j + 1) * kvb]
            kv_pos = j * kvb + torch.arange(kvb, device=q.device)
            s = torch.einsum("bkgqd,bjkd->bkgqj", qi, kb) * scale
            ok = mask_allowed(q_pos[:, None], kv_pos[None, :], mask)
            s = torch.where(ok, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqj,bjkd->bkgqd",
                                                       p, vb)
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.stack(outs, dim=0)  # (nq, B, Hkv, G, qb, Dv)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, dv)
    return out[:, :sq_in]


def slab_write(buf: Tensor, new: Tensor, positions: Tensor) -> Tensor:
    """Write ``new (B, Sq, ...)`` into ``buf (B, S_max, ...)`` at per-row
    start ``positions`` (B,), in place. Like the reference's
    dynamic_update_slice, a start past ``S_max - Sq`` is clamped so the
    slab always fits."""
    b, sq = new.shape[:2]
    start = torch.clamp(positions.to(torch.int64), 0, buf.shape[1] - sq)
    rows = torch.arange(b, device=new.device)[:, None]
    cols = start[:, None] + torch.arange(sq, device=new.device)[None, :]
    buf[rows, cols] = new.to(buf.dtype)
    return buf


def scatter_rows(buf: Tensor, new: Tensor, positions: Tensor) -> Tensor:
    """Write ``new (B, S, ...)`` into ``buf (B, S_max, ...)`` at the
    positions ``positions (B, S)``, in place, dropping writes past the row:
    the chain-verify write, where :func:`slab_write` would clamp the slab's
    start and overwrite committed positions when a chain overhangs
    ``S_max``. Each row's positions are consecutive (a chain), so its
    dropped writes are a suffix; they are aimed at the row's last position
    with the value that position receives anyway (the chain's own write
    there, or what it holds), which keeps every index write
    deterministic without a device sync."""
    b, s = new.shape[:2]
    s_max = buf.shape[1]
    pos = positions.to(torch.int64)
    j = torch.arange(s, device=buf.device)[None, :]
    rows = torch.arange(b, device=buf.device)[:, None].expand(b, s)
    ok = pos < s_max
    n_ok = ok.sum(dim=1, keepdim=True)
    col = torch.clamp_max(pos, s_max - 1)
    src = torch.where(ok, j, torch.clamp_min(n_ok - 1, 0))
    shape = (b, s) + (1,) * (new.ndim - 2)
    val = torch.where((ok | (n_ok > 0)).reshape(shape),
                      new[rows, src].to(buf.dtype), buf[rows, col])
    buf[rows, col] = val
    return buf


def cache_update(cache: KVCache, k_new: Tensor, v_new: Tensor,
                 positions: Tensor) -> KVCache:
    """Write (B, Sq, Hkv, D) K/V slabs at per-row start ``positions``
    (B,), in place (:func:`slab_write`)."""
    slab_write(cache.k, k_new, positions)
    slab_write(cache.v, v_new, positions)
    return cache


def attention_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, hkv, hd = cfg.d_model, cfg.n_kv_heads, cfg.resolved_head_dim
    h = cfg.padded_heads
    specs = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"),
                        scale=1.0 / math.sqrt(h * hd / d)),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
        specs["k_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
    return specs


def head_mask(cfg: ModelConfig, device=None) -> Optional[Tensor]:
    """(padded_heads,) 1/0 mask over kv-major heads (head = kv*g + j): the
    real heads of each kv group come first, pads at the tail."""
    h_pad = cfg.padded_heads
    if h_pad == cfg.n_heads:
        return None
    hkv = max(cfg.n_kv_heads, 1)
    g_pad = h_pad // hkv
    g_real = cfg.n_heads // hkv
    mask = (torch.arange(g_pad, device=device) < g_real).to(torch.float32)
    return mask.repeat(hkv)


def attention_apply(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                    *, mask: MaskSpec, positions: Tensor,
                    cache: Optional[KVCache | PagedKVCache],
                    lengths: Optional[Tensor], kv_cap: Optional[int] = None,
                    fused: bool = True, spec_verify: bool = False
                    ) -> tuple[Tensor, Optional[KVCache | PagedKVCache]]:
    """Self-attention: project, qk-norm, rope, then either write the new
    K/V at ``positions[:, 0]`` and attend over the cache (``lengths`` (B,)
    are the post-update cache lengths), or, with no cache, attend over the
    sequence itself blockwise (training). On a paged cache, single-token
    decode with ``fused`` runs K4 over the table's ``kv_cap`` prefix, and
    so does the chain verify (``spec_verify``), over B·S rows."""
    q = dense(x, params["wq"], cfg)   # (B, S, H, hd)
    k = dense(x, params["wk"], cfg)
    v = dense(x, params["wv"], cfg)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if cfg.pos_variant == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if isinstance(cache, PagedKVCache):
        paged_write(cache.k, k, positions[:, 0], cache.pt)
        paged_write(cache.v, v, positions[:, 0], cache.pt)
        if fused and fused_paged_ok(mask, q.shape[1]):
            pt = _capped_pt(cache.pt, cache.k.shape[1], kv_cap)
            out = paged_decode_attention(q[:, 0], cache.k, cache.v, pt,
                                         lengths)[:, None]
        elif fused and spec_verify and spec_verify_ok(mask):
            # Row j of slot b is the single-token decode of chain position
            # j: the slot's table, length pos + 1.
            b, s = q.shape[:2]
            page = cache.k.shape[1]
            ptf, row_len = verify_rows(_capped_pt(cache.pt, page, kv_cap),
                                       positions, page)
            out = paged_decode_attention(q.reshape((b * s,) + q.shape[2:]),
                                         cache.k, cache.v, ptf, row_len)
            out = out.reshape((b, s) + out.shape[1:])
        else:
            out = decode_attention(q, paged_view(cache.k, cache.pt),
                                   paged_view(cache.v, cache.pt),
                                   positions, lengths, mask)
    elif cache is not None and spec_verify and q.shape[1] > 1:
        scatter_rows(cache.k, k, positions)
        scatter_rows(cache.v, v, positions)
        # One chain column at a time, as a decode step attends: a batched
        # product's summation order depends on its number of query rows.
        out = torch.cat([decode_attention(q[:, j:j + 1], cache.k, cache.v,
                                          positions[:, j:j + 1], lengths,
                                          mask)
                         for j in range(q.shape[1])], dim=1)
    elif cache is not None:
        cache = cache_update(cache, k, v, positions[:, 0])
        out = decode_attention(q, cache.k, cache.v, positions, lengths, mask)
    else:
        out = blockwise_attention(q, k, v, mask, q_block=cfg.q_block,
                                  kv_block=cfg.kv_block)
    hm = head_mask(cfg, x.device)
    if hm is not None:
        out = out * hm[None, None, :, None]
    y = dense_in(out.to(cfg.activation_dtype), params["wo"], cfg)
    return y, cache
