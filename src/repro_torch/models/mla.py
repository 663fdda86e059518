"""Multi-head Latent Attention (port of ``repro.models.mla``, the
deepseek-v3 family).

Without a cache (the full-sequence forward) the latent projections are
expanded to per-head K/V and run through the shared blockwise attention.
With a cache (serving prefill and decode) the *absorbed* form runs: the
up-projection ``W_kv_b`` is folded into the query and output projections,
so a cache position holds only the normalized latent ``c_kv`` (C =
kv_lora_rank) and the shared rope key ``k_rope`` (R) and attention runs
in the latent space.

- Dense slot cache (:class:`MLACache`): the new rows are written at
  ``positions[:, 0]`` and every query attends over the cache with the
  causal mask and the row lengths (prefill runs here at S > 1).
- Paged pool (:class:`PagedMLACache`, DESIGN.md §8): the new rows go to
  the row's pages (``paged_write``); single-token decode runs the fused
  split-K kernel K5 (``kernels/paged_attn.paged_decode_mla``) over the
  table's KV-extent prefix, anything else reads the rows' dense view
  through the page gather K6 and attends as on the dense cache.
- Chain verify (``spec_verify``, DESIGN.md §12): a (B, K+1) chain of
  queries at once; on the paged pool K5 runs over B·(K+1) flattened rows
  that share each slot's table, with per-row lengths; on the dense cache
  the chain's rows land through ``scatter_rows`` (writes past the row
  drop) and attend one chain column at a time.

The absorption ``q_lat = q_nope · W_k_b``, the output up-projection
``o_lat · W_v_b`` and the latent attention's products are float32 results
as in the reference, but each is summed in float64 from its operands'
exact products and then rounded (:func:`_exact_einsum`), as K5 sums. A
float32 product's summation order is the BLAS's choice, which on the card
changes with the number of rows a call carries (a chain verify's 20 rows
against a decode's 4, a chunk against a whole prompt); rounded from a
float64 sum, the result no longer depends on it. Every projection goes through ``dense``/
``dense_in`` (TimeFloats arithmetic when enabled). Caches are updated in
place.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attn import paged_decode_mla
from repro_torch.models.attention import (NEG, MaskSpec, _capped_pt,
                                          blockwise_attention, fused_paged_ok,
                                          mask_allowed, paged_view,
                                          paged_write, scatter_rows,
                                          slab_write, spec_verify_ok,
                                          verify_rows)
from repro_torch.models.common import ParamSpec, dense, dense_in, rms_norm, rope

Tensor = torch.Tensor


class MLACache(NamedTuple):
    """Per-layer slot cache: c_kv (B, S_max, C), k_rope (B, S_max, R)."""

    c_kv: Tensor
    k_rope: Tensor


class PagedMLACache(NamedTuple):
    """Per-layer paged cache: latent and rope page pools ``(P, page, C)``
    and ``(P, page, R)`` shared by every row, and the per-row page table
    ``pt (B, T)`` (page 0 is the trash page), as attention.PagedKVCache."""

    c_kv: Tensor
    k_rope: Tensor
    pt: Tensor


def mla_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": ParamSpec((d, m.q_lora_rank), ("embed", "q_lora")),
        "q_a_norm": ParamSpec((m.q_lora_rank,), ("q_lora",), init="ones"),
        "wq_b": ParamSpec((m.q_lora_rank, h, qk),
                          ("q_lora", "heads", "head_dim")),
        "wkv_a": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                           ("embed", "kv_lora")),
        "kv_a_norm": ParamSpec((m.kv_lora_rank,), ("kv_lora",),
                               init="ones"),
        "wkv_b": ParamSpec((m.kv_lora_rank, h,
                            m.qk_nope_head_dim + m.v_head_dim),
                           ("kv_lora", "heads", "head_dim")),
        "wo": ParamSpec((h, m.v_head_dim, d), ("heads", "head_dim", "embed"),
                        scale=1.0 / math.sqrt(h * m.v_head_dim / d)),
    }


def _project_q(params, x: Tensor, cfg: ModelConfig, positions: Tensor):
    m = cfg.mla
    q_lat = rms_norm(dense(x, params["wq_a"], cfg), params["q_a_norm"])
    q = dense(q_lat, params["wq_b"], cfg)  # (B, S, H, nope+rope)
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _project_kv_latent(params, x: Tensor, cfg: ModelConfig,
                       positions: Tensor):
    m = cfg.mla
    kv_a = dense(x, params["wkv_a"], cfg)  # (B, S, kv_lora+rope)
    c_kv = rms_norm(kv_a[..., : m.kv_lora_rank], params["kv_a_norm"])
    k_rope = kv_a[..., m.kv_lora_rank:][:, :, None, :]  # 1 shared head
    k_rope = rope(k_rope, positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _exact_einsum(eq: str, a: Tensor, b: Tensor) -> Tensor:
    """``torch.einsum(eq, a, b)`` rounded to float32 from float64 sums.
    Operands of at most 24 significant bits multiply exactly in float64,
    and the sum's order moves its float64 rounding by far less than a
    float32 ulp, so the float32 result changes with the order only where
    the sum lies that close to a float32 rounding boundary: a call's rows
    equal the same rows computed in another batch (bitwise on the card at
    a verify's 20 rows against a decode's 4, chip_smoke.py)."""
    return torch.einsum(eq, a.to(torch.float64),
                        b.to(torch.float64)).to(torch.float32)


def absorb_query(q_nope: Tensor, wk_b: Tensor) -> Tensor:
    """q_lat (B, S, H, C) = q_nope (B, S, H, nope) · W_k_b (C, H, nope)."""
    return _exact_einsum("bshn,chn->bshc", q_nope, wk_b)


def _up_project(o_lat: Tensor, wv_b: Tensor, params, cfg: ModelConfig
                ) -> Tensor:
    """Latent attention output (B, S, H, C) -> the layer's output."""
    out = _exact_einsum("bshc,chv->bshv", o_lat, wv_b)
    return dense_in(out.to(cfg.activation_dtype), params["wo"], cfg)


def mla_apply(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig, *,
              mask: MaskSpec, positions: Tensor,
              cache: Optional[MLACache | PagedMLACache] = None,
              lengths: Optional[Tensor] = None,
              kv_cap: Optional[int] = None, fused: bool = True,
              spec_verify: bool = False
              ) -> tuple[Tensor, Optional[MLACache | PagedMLACache]]:
    """MLA mixer. With no cache, the expanded blockwise path; with one,
    the absorbed path: write the new latent/rope rows at
    ``positions[:, 0]`` and attend over the cache (``lengths`` (B,) are the
    post-update lengths). On a paged cache, single-token decode with
    ``fused`` runs K5 over the table's ``kv_cap`` prefix, and so does the
    chain verify (``spec_verify``), over B·S rows."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _project_q(params, x, cfg, positions)
    c_kv, k_rope = _project_kv_latent(params, x, cfg, positions)

    if cache is None:
        # Expanded path: per-head K/V, shared blockwise attention.
        kv = dense(c_kv, params["wkv_b"], cfg)  # (B, S, H, nope+v)
        k_nope = kv[..., : m.qk_nope_head_dim]
        v = kv[..., m.qk_nope_head_dim:]
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            b, s, h, m.qk_rope_head_dim)], dim=-1)
        out = blockwise_attention(q, k, v, mask, q_block=cfg.q_block,
                                  kv_block=cfg.kv_block)
        return dense_in(out.to(cfg.activation_dtype), params["wo"],
                        cfg), None

    # Absorbed path.
    write_pos = positions[:, 0]
    wkv_b = params["wkv_b"]                    # (kv_lora, H, nope+v)
    wk_b = wkv_b[..., : m.qk_nope_head_dim]    # (kv_lora, H, nope)
    wv_b = wkv_b[..., m.qk_nope_head_dim:]     # (kv_lora, H, v)
    q_lat = absorb_query(q_nope, wk_b)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)

    if isinstance(cache, PagedMLACache):
        paged_write(cache.c_kv, c_kv, write_pos, cache.pt)
        paged_write(cache.k_rope, k_rope, write_pos, cache.pt)
        if fused and fused_paged_ok(mask, s):
            pt = _capped_pt(cache.pt, cache.c_kv.shape[1], kv_cap)
            o_lat = paged_decode_mla(q_lat[:, 0], q_rope[:, 0], cache.c_kv,
                                     cache.k_rope, pt, lengths,
                                     scale=scale)[:, None]
            return _up_project(o_lat, wv_b, params, cfg), cache
        if fused and spec_verify and spec_verify_ok(mask):
            page = cache.c_kv.shape[1]
            ptf, row_len = verify_rows(_capped_pt(cache.pt, page, kv_cap),
                                       positions, page)
            o_lat = paged_decode_mla(
                q_lat.reshape((b * s,) + q_lat.shape[2:]),
                q_rope.reshape((b * s,) + q_rope.shape[2:]), cache.c_kv,
                cache.k_rope, ptf, row_len, scale=scale)
            o_lat = o_lat.reshape((b, s) + o_lat.shape[1:])
            return _up_project(o_lat, wv_b, params, cfg), cache
        c_kv_all = paged_view(cache.c_kv, cache.pt)      # (B, T*page, C)
        k_rope_all = paged_view(cache.k_rope, cache.pt)
    else:
        if spec_verify and s > 1:
            scatter_rows(cache.c_kv, c_kv, positions)
            scatter_rows(cache.k_rope, k_rope, positions)
        else:
            slab_write(cache.c_kv, c_kv, write_pos)
            slab_write(cache.k_rope, k_rope, write_pos)
        c_kv_all, k_rope_all = cache.c_kv, cache.k_rope
    ckf = c_kv_all.to(torch.float32)
    krf = k_rope_all.to(torch.float32)
    if spec_verify and s > 1:
        # One chain column at a time, as a decode step attends: a batched
        # product's summation order depends on its number of query rows.
        o_lat = torch.cat([_latent_attention(
            q_lat[:, j:j + 1], q_rope[:, j:j + 1], ckf, krf,
            positions[:, j:j + 1], lengths, mask, scale) for j in range(s)],
            dim=1)
    else:
        o_lat = _latent_attention(q_lat, q_rope, ckf, krf, positions,
                                  lengths, mask, scale)
    return _up_project(o_lat, wv_b, params, cfg), cache


def _latent_attention(q_lat: Tensor, q_rope: Tensor, ckf: Tensor,
                      krf: Tensor, positions: Tensor, lengths: Tensor,
                      mask: MaskSpec, scale: float) -> Tensor:
    """Masked softmax attention in the latent space: queries (B, S, H, C)
    and (B, S, H, R) against the f32 latents (B, S_max, C) and rope keys
    (B, S_max, R); returns (B, S, H, C)."""
    s_lat = _exact_einsum("bshc,bjc->bhsj", q_lat, ckf)
    s_rope = _exact_einsum("bshr,bjr->bhsj", q_rope, krf)
    scores = (s_lat + s_rope) * scale  # (B, H, S, S_max)
    kv_pos = torch.arange(ckf.shape[1], device=ckf.device)
    ok = mask_allowed(positions[:, :, None], kv_pos[None, None, :], mask)
    ok = (ok & (kv_pos[None, None, :] < lengths[:, None, None]))[:, None]
    scores = torch.where(ok, scores, NEG)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    den = e.to(torch.float64).sum(dim=-1, keepdim=True).to(torch.float32)
    p = torch.where(ok, e / den, 0.0)
    return _exact_einsum("bhsj,bjc->bshc", p, ckf)
