"""LMModel (port of ``repro.models.model``) for the dense family (GQA
attention) and the ``moe`` family (MLA or GQA attention; the first
``moe.first_k_dense`` layers dense blocks of FFN width ``moe.dense_d_ff``,
the rest MoE blocks, models/moe.py). Parameters, the layer loop with the
MoE layers' auxiliary losses summed over layers, the full-sequence
training forward and loss, the slot cache, the paged cache (DESIGN.md §8)
and the serving steps ``prefill`` / ``decode_step`` / ``verify_step`` (the
speculative chain verify, DESIGN.md §12) / ``prefill_into_slots``
(resumable at per-row offsets for chunked prefill, DESIGN.md §10) /
``prefill_into_pages``.

The reference stacks layers and scans them; here the parameters hold a list
of per-layer dicts (``params["layers"]``) and a Python loop walks it, each
layer's kind from ``cfg.layer_kinds()``. Its ``remat="full"``
(``jax.checkpoint`` of the scan body) becomes ``torch.utils.checkpoint``
around each block; ``remat="dots"`` (the reference's
``dots_with_no_batch_dims_saveable`` policy) checkpoints each block but
keeps its 2-D products through a selective checkpoint policy: each
``aten.mm`` and, at ``quant="timefloats"``, each projection's quantized
planes and output (``timefloats.PROJECTION_OPS``). A layer's cache is a
``KVCache``/``PagedKVCache`` (GQA) or an ``MLACache``/``PagedMLACache``;
every function below that touches caches works on their fields
generically. SSM, hybrid, audio and VLM come with later slices.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import timefloats
from repro_torch.models import attention as attn_mod
from repro_torch.models import common
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import KVCache, MaskSpec, PagedKVCache
from repro_torch.models.common import (ParamSpec, dense, init_params,
                                       mlp_apply, mlp_specs, norm_apply,
                                       norm_specs)

Tensor = torch.Tensor
Tree = Any
# A layer's cache: GQA K/V or MLA latents, on slot rows or on the page pool.
Cache = KVCache | PagedKVCache | mla_mod.MLACache | mla_mod.PagedMLACache
AUX_KEYS = ("lb_loss", "z_loss", "dropped_frac")   # the reference's AUX_ZERO


def _require_ported(cfg: ModelConfig) -> None:
    """Every layer must be a dense or MoE block of a ported family."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")


def _uses_mla(cfg: ModelConfig) -> bool:
    return cfg.mla is not None


def default_mask(cfg: ModelConfig) -> MaskSpec:
    return MaskSpec(causal=True,
                    prefix_len=(cfg.num_prefix_tokens
                                if cfg.prefix_bidirectional else 0),
                    window=cfg.sliding_window)


def block_specs(kind: str, cfg: ModelConfig) -> Dict[str, Any]:
    """A block: the MLA or GQA mixer, then an MoE layer (``kind="moe"``)
    or an MLP, of width ``moe.dense_d_ff`` in a ``moe``-family config's
    dense layers."""
    mixer = (mla_mod.mla_specs(cfg) if _uses_mla(cfg)
             else attn_mod.attention_specs(cfg))
    if kind == "moe":
        ffn = moe_mod.moe_specs(cfg)
    else:
        d_ff = cfg.d_ff
        if cfg.moe and cfg.moe.dense_d_ff:
            d_ff = cfg.moe.dense_d_ff
        ffn = mlp_specs(cfg, d_ff)
    return {"norm1": norm_specs(cfg), "mixer": mixer,
            "norm2": norm_specs(cfg), "ffn": ffn}


def block_apply(kind: str, params: Dict[str, Any], x: Tensor,
                cfg: ModelConfig, *, positions: Tensor,
                cache: Optional[Cache], lengths: Optional[Tensor],
                kv_cap: Optional[int] = None, fused_paged: bool = True,
                spec_verify: bool = False
                ) -> tuple[Tensor, Optional[Cache], Dict[str, Tensor]]:
    """One block -> (x, cache, aux); aux holds the MoE layer's losses and
    dropped share (zeros for a dense block)."""
    h = norm_apply(params["norm1"], x, cfg)
    mixer = mla_mod.mla_apply if _uses_mla(cfg) else attn_mod.attention_apply
    y, cache = mixer(
        params["mixer"], h, cfg, mask=default_mask(cfg), positions=positions,
        cache=cache, lengths=lengths, kv_cap=kv_cap, fused=fused_paged,
        spec_verify=spec_verify)
    x = x + y
    h2 = norm_apply(params["norm2"], x, cfg)
    if kind != "moe":
        return x + mlp_apply(params["ffn"], h2, cfg), cache, {}
    # A ragged or suffix prefill tells the router which positions are
    # real, so capacity follows the real tokens and pads take no expert
    # slot; decode (S == 1) and the verify keep every token. The verify
    # routes drop-free: it must keep what single-token decodes keep.
    tok_valid = None
    if lengths is not None and x.shape[1] > 1 and not spec_verify:
        tok_valid = positions < lengths[:, None]
    y2, aux = moe_mod.moe_apply(params["ffn"], h2, cfg, token_mask=tok_valid,
                                drop_free=spec_verify)
    return x + y2, cache, aux


def model_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _require_ported(cfg)
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           init="embed", scale=0.02),
        "layers": [block_specs(kind, cfg) for kind in cfg.layer_kinds()],
        "final_norm": norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"))
    return specs


def init(cfg: ModelConfig, seed: int, device="cuda") -> Tree:
    """Random parameters from ``seed`` (a torch.Generator on ``device``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(model_param_specs(cfg), gen, cfg.param_torch_dtype,
                       device)


def embed_tokens(params: Tree, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    x = params["embed"][tokens].to(cfg.activation_dtype)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def _head(params: Tree, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Logits in f32. The tied head is the transposed read of the table;
    its cache entry (prepared from embed.T) is keyed on the table."""
    if cfg.tie_embeddings:
        return dense(x, params["embed"].T, cfg,
                     pw=common.cached_weight(params["embed"])
                     ).to(torch.float32)
    return dense(x, params["lm_head"], cfg).to(torch.float32)


def _run_layers(params: Tree, x: Tensor, cfg: ModelConfig, *,
                positions: Tensor, caches: List[Cache],
                lengths: Tensor, kv_cap: Optional[int] = None,
                fused_paged: bool = True, spec_verify: bool = False
                ) -> tuple[Tensor, List[Cache]]:
    new = []
    for kind, lp, lc in zip(cfg.layer_kinds(), params["layers"], caches):
        x, lc, _ = block_apply(kind, lp, x, cfg, positions=positions,
                               cache=lc, lengths=lengths, kv_cap=kv_cap,
                               fused_paged=fused_paged,
                               spec_verify=spec_verify)
        new.append(lc)
    return x, new


# remat="dots": the 2-D products a checkpointed block keeps, as the
# reference's ``dots_with_no_batch_dims_saveable`` policy keeps them; at
# quant="timefloats" a projection's quantizers and product (the expert
# products carry a batch dim and are recomputed, as in the reference).
_DOTS_SAVED = (torch.ops.aten.mm.default, *timefloats.PROJECTION_OPS)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _sequence_layers(params: Tree, x: Tensor, cfg: ModelConfig,
                     positions: Tensor, remat: str
                     ) -> tuple[Tensor, Dict[str, Tensor]]:
    """The layer loop of the full-sequence forward -> (x, aux summed over
    layers in f32, in layer order from zero, as the reference's scan
    carries it). With ``remat="full"`` each block is checkpointed: its
    activations are dropped after the forward and recomputed in the
    backward; ``"dots"`` keeps the block's 2-D products (``_DOTS_SAVED``).
    The recomputation runs after the loss has left its weight-cache scope,
    so each block reinstalls the table it saw in the forward."""
    table = common.active_weight_cache()

    def block(kind, lp, h):
        with common.weight_cache_scope(table):
            out, _, aux = block_apply(kind, lp, h, cfg, positions=positions,
                                      cache=None, lengths=None)
        return (out, *(aux[k] for k in AUX_KEYS)) if aux else (out,)

    aux_tot = {k: torch.zeros((), dtype=torch.float32, device=x.device)
               for k in AUX_KEYS}
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    for kind, lp in zip(cfg.layer_kinds(), params["layers"]):
        if remat in ("full", "dots"):
            out = torch.utils.checkpoint.checkpoint(block, kind, lp, x, **kw)
        else:
            out = block(kind, lp, x)
        x = out[0]
        for key, v in zip(AUX_KEYS, out[1:]):
            aux_tot[key] = aux_tot[key] + v.to(torch.float32)
    return x, aux_tot


def forward(params: Tree, batch: Dict[str, Tensor], cfg: ModelConfig, *,
            train: bool = True) -> tuple[Tensor, Dict[str, Tensor]]:
    """Full-sequence forward -> (logits (B, S, V) f32, aux). ``train``
    applies ``cfg.remat`` to the layer loop."""
    _require_ported(cfg)
    x = embed_tokens(params, batch["tokens"], cfg)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    x, aux = _sequence_layers(params, x, cfg, positions,
                              cfg.remat if train else "none")
    x = norm_apply(params["final_norm"], x, cfg)
    return _head(params, x, cfg), aux


def _nll(logits: Tensor, labels: Tensor) -> Tensor:
    """-log p[labels]: a max-shifted log-sum-exp minus the label's logit.
    The reference extracts the label logit with a masked sum over the
    vocab (for sharding); a gather picks the same value."""
    m = logits.amax(dim=-1, keepdim=True).detach()
    s = logits - m
    lse = torch.log(torch.exp(s).sum(dim=-1))
    label = torch.gather(s, -1, labels[..., None].to(torch.int64))[..., 0]
    return lse - label


def loss_fn(params: Tree, batch: Dict[str, Tensor], cfg: ModelConfig
            ) -> tuple[Tensor, Dict[str, Tensor]]:
    """Masked mean next-token cross entropy plus the MoE layers' load-
    balance and router-z losses (zero for the dense family), and the
    reference's metrics (``dropped_frac`` summed over the MoE layers)."""
    logits, aux = forward(params, batch, cfg, train=True)
    mask = batch["mask"].to(torch.float32)
    nll = _nll(logits, batch["labels"])
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = (nll * mask).sum() / denom
    loss = ce + aux["lb_loss"] + aux["z_loss"]
    metrics = {"loss": loss, "ce": ce, "lb_loss": aux["lb_loss"],
               "z_loss": aux["z_loss"], "dropped_frac": aux["dropped_frac"],
               "tokens": denom}
    return loss, metrics


class ModelCache(NamedTuple):
    layers: tuple                # per-layer Cache
    lengths: Tensor              # (B,) int32 valid lengths


def _layer_cache(cfg: ModelConfig, rows: int, row_len: int, device,
                 pt: Optional[Tensor] = None) -> Cache:
    """One layer's zeroed cache: ``rows`` slot rows of ``row_len``
    positions, or with a page table ``pt``, ``rows`` pages of ``row_len``
    positions."""
    dt = cfg.activation_dtype

    def z(*feat):
        return torch.zeros((rows, row_len) + feat, dtype=dt, device=device)

    if _uses_mla(cfg):
        m = cfg.mla
        lat, rot = z(m.kv_lora_rank), z(m.qk_rope_head_dim)
        return (mla_mod.MLACache(lat, rot) if pt is None
                else mla_mod.PagedMLACache(lat, rot, pt))
    feat = (cfg.n_kv_heads, cfg.resolved_head_dim)
    return (KVCache(z(*feat), z(*feat)) if pt is None
            else PagedKVCache(z(*feat), z(*feat), pt))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> ModelCache:
    _require_ported(cfg)
    layers = tuple(_layer_cache(cfg, batch, max_len, device)
                   for _ in range(cfg.n_layers))
    return ModelCache(layers=layers,
                      lengths=torch.zeros((batch,), dtype=torch.int32,
                                          device=device))


def paged_supported(cfg: ModelConfig) -> bool:
    """The paged pool covers the attention families whose K/V (or MLA
    latents) at a position are a pure function of the token prefix (no
    meta-token or patch prefix): of those the port has the dense family
    and the ``moe`` family, dense and MoE layers alike."""
    return (cfg.family in ("dense", "moe")
            and all(k in ("dense", "moe") for k in cfg.layer_kinds())
            and not cfg.num_prefix_tokens)


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     page_size: int, num_pages: int, device="cuda"
                     ) -> ModelCache:
    """Paged ModelCache: per-layer page pools ``(P, page, ...)`` (GQA
    K/V, or MLA latents and rope keys) shared by every row, and ONE
    ``(B, T)`` int32 page table (T*page == max_len) that every layer's
    cache holds: the reference replicates the table over L so it rides its
    layer scan; the port's layer loop needs no copy. Entries start at the
    trash page 0."""
    if not paged_supported(cfg):
        raise NotImplementedError(f"paged cache: {cfg.name} is not a "
                                  "supported family")
    if max_len % page_size:
        raise ValueError("max_len must be a page multiple")
    pt = torch.zeros((batch, max_len // page_size), dtype=torch.int32,
                     device=device)
    layers = tuple(_layer_cache(cfg, num_pages, page_size, device, pt)
                   for _ in range(cfg.n_layers))
    return ModelCache(layers=layers,
                      lengths=torch.zeros((batch,), dtype=torch.int32,
                                          device=device))


def set_page_rows(cache: ModelCache, slot_ids, rows) -> ModelCache:
    """Write page-table rows ``rows (n, T)`` for slots ``slot_ids (n,)``
    into the shared table, in place; ids outside [0, B) drop. The engine
    calls it on admission and on slot teardown (all-trash rows). The ids
    and rows are host data."""
    pt = cache.layers[0].pt
    ids = np.asarray(slot_ids, np.int64)
    rows = np.asarray(rows, np.int32).reshape(len(ids), pt.shape[1])
    keep = (ids >= 0) & (ids < pt.shape[0])
    if keep.any():
        pt[torch.as_tensor(ids[keep], device=pt.device)] = torch.as_tensor(
            rows[keep], device=pt.device)
    return cache


def decode_step(params: Tree, cache: ModelCache, tokens: Tensor,
                cfg: ModelConfig, *, kv_cap: Optional[int] = None,
                fused_paged: bool = True) -> tuple[Tensor, ModelCache]:
    """One decode step. tokens (B, 1). Positions are cache.lengths (append
    at the end); lengths advance by 1. Returns (logits (B, 1, V), cache).

    On a paged cache attention runs the fused split-K kernel, K4 (GQA) or
    K5 (MLA) (``fused_paged=False`` keeps the gather + softmax
    composition), over the ``kv_cap`` prefix of each table (tokens, a page
    multiple): the caller guarantees every row's post-step length fits it.
    Dense caches ignore both."""
    x = embed_tokens(params, tokens, cfg)
    positions = cache.lengths[:, None]
    lengths = cache.lengths + 1
    x, layers = _run_layers(params, x, cfg, positions=positions,
                            caches=list(cache.layers), lengths=lengths,
                            kv_cap=kv_cap, fused_paged=fused_paged)
    x = norm_apply(params["final_norm"], x, cfg)
    return _head(params, x, cfg), ModelCache(tuple(layers), lengths)


def verify_step(params: Tree, cache: ModelCache, tokens: Tensor,
                cfg: ModelConfig, *, kv_cap: Optional[int] = None,
                fused_paged: bool = True) -> tuple[Tensor, ModelCache]:
    """Speculative chain verify (DESIGN.md §12). ``tokens (B, S)`` is the
    pending token and S-1 draft tokens; they are written at positions
    ``cache.lengths .. lengths+S-1`` and all S next-token logits come back
    ``(B, S, V)``. Column j is the decode step after consuming the chain's
    first j+1 tokens; the caller rolls ``lengths`` back to the accepted
    prefix, which erases the rejected suffix (masked now, overwritten by
    the next write at the same positions).

    On a paged cache attention runs K4 (GQA) or K5 (MLA) over B·S rows
    that share each slot's table (``kv_cap`` must cover ``lengths + S``);
    writes past the table go to the trash page. On the dense cache writes
    past ``max_len`` drop (``attention.scatter_rows``)."""
    if not paged_supported(cfg):
        raise NotImplementedError(f"verify_step: {cfg.name} is not an "
                                  "attention family")
    s = tokens.shape[1]
    x = embed_tokens(params, tokens, cfg)
    positions = (cache.lengths[:, None]
                 + torch.arange(s, dtype=cache.lengths.dtype,
                                device=x.device)[None, :])
    lengths = cache.lengths + s
    x, layers = _run_layers(params, x, cfg, positions=positions,
                            caches=list(cache.layers), lengths=lengths,
                            kv_cap=kv_cap, fused_paged=fused_paged,
                            spec_verify=True)
    x = norm_apply(params["final_norm"], x, cfg)
    return _head(params, x, cfg), ModelCache(tuple(layers), lengths)


def prefill(params: Tree, tokens: Tensor, cfg: ModelConfig,
            cache: ModelCache, *, lengths: Tensor | None = None,
            offsets: Tensor | None = None) -> tuple[Tensor, ModelCache]:
    """Run right-padded prompts (B, S) through the model, writing K/V at
    positions [0, S) of ``cache``. ``lengths`` (B,) are the per-row valid
    TOTAL lengths (ragged prefill; None = all S). Returns the logits at
    each row's last valid position (B, 1, V) and the cache.

    ``offsets`` (B,) makes it a per-row SUFFIX prefill (the radix
    prefix-hit path): row b's tokens occupy absolute positions
    ``offsets[b] + [0, S)`` and attend to the cache content below them,
    read and not recomputed."""
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None, :].expand(b, s)
    if offsets is not None:
        positions = offsets.to(torch.int32)[:, None] + positions
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
    x, layers = _run_layers(params, x, cfg, positions=positions,
                            caches=list(cache.layers), lengths=lengths)
    x = norm_apply(params["final_norm"], x, cfg)
    idx = lengths.to(torch.int64) - 1
    if offsets is not None:
        idx = idx - offsets.to(torch.int64)
    idx = torch.clamp(idx, 0, s - 1)
    last = x[torch.arange(b, device=x.device), idx][:, None]
    return _head(params, last, cfg), ModelCache(tuple(layers), lengths)


def slot_ids_tensor(slot_ids, device) -> Tensor:
    """Wave-row slot ids as an int64 tensor on ``device`` (host arrays are
    copied; a device tensor is used as it is, so a captured step reads the
    ids its static buffer holds at replay)."""
    if isinstance(slot_ids, Tensor):
        return slot_ids.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(slot_ids, np.int64), device=device)


def slot_sources(slot_ids, slots: int, device) -> tuple[Tensor, Tensor]:
    """For each of ``slots`` cache rows, the first wave row whose id names
    it and whether any does: ``(src (slots,) int64, has (slots,) bool)``.
    Ids outside [0, slots) (the drop sentinel ``slots``, negative padding)
    name no row, so they write nowhere. Fixed shape and no host sync: the
    device-side form of filtering the ids on the host."""
    ids = slot_ids_tensor(slot_ids, device)
    match = ids[None, :] == torch.arange(slots, device=device)[:, None]
    return match.to(torch.float32).argmax(dim=1), match.any(dim=1)


def merge_rows(buf: Tensor, new: Tensor, src: Tensor, has: Tensor) -> None:
    """``buf[i] = new[src[i]]`` where ``has[i]``, in place; other rows keep
    what they hold. Bitwise the indexed write of the filtered rows."""
    keep = has.reshape((-1,) + (1,) * (buf.ndim - 1))
    buf.copy_(torch.where(keep, new[src].to(buf.dtype), buf))


def scatter_cache_rows(full: ModelCache, rows: ModelCache,
                       slot_ids) -> ModelCache:
    """Write row j of ``rows`` into batch row ``slot_ids[j]`` of ``full``,
    in place. Ids outside [0, slots) are padding rows and are dropped
    (never clamped). ``slot_ids`` is a host array or a device tensor; the
    write has a fixed shape either way (:func:`slot_sources`)."""
    slots = full.lengths.shape[0]
    src, has = slot_sources(slot_ids, slots, full.lengths.device)
    for f, r in zip(full.layers, rows.layers):
        for buf, new in zip(f, r):
            merge_rows(buf, new, src, has)
    merge_rows(full.lengths, rows.lengths, src, has)
    return full


def gather_cache_rows(cache: ModelCache, slot_ids) -> ModelCache:
    """Copy per-slot rows out of the slot cache, the inverse of
    :func:`scatter_cache_rows`. Out-of-range ids clamp into [0, slots):
    those are padding rows, which the scatter later drops and the chunked
    prefill runs at length 0, so the copied content is never attended."""
    slots = cache.lengths.shape[0]
    ids = torch.clamp(slot_ids_tensor(slot_ids, cache.lengths.device), 0,
                      slots - 1)
    layers = tuple(type(lc)(*(buf[ids] for buf in lc))
                   for lc in cache.layers)
    return ModelCache(layers=layers, lengths=cache.lengths[ids])


def prefill_into_slots(params: Tree, tokens: Tensor, cfg: ModelConfig,
                       cache: ModelCache, lengths: Tensor,
                       slot_ids, *, max_len: int,
                       offsets: Optional[Tensor] = None
                       ) -> tuple[Tensor, ModelCache]:
    """Bucketed batched prefill straight into slot rows: one ragged
    ``prefill`` on a throwaway cache, whose rows (and lengths) then land in
    ``cache`` at ``slot_ids`` (host array or device tensor); out-of-range
    ids are padding rows.

    ``offsets`` (B,) makes it resumable (the chunked-prefill path, DESIGN.md
    §10): the slots' current rows are copied out instead of a zeroed
    scratch, row r's tokens land at absolute positions ``offsets[r] +
    [0, S)`` on top of the K/V earlier chunks wrote, and the rows (with
    lengths ``lengths``) are scattered back."""
    if offsets is None:
        scratch = init_cache(cfg, tokens.shape[0], max_len, tokens.device)
    else:
        scratch = gather_cache_rows(cache, slot_ids)
    logits, rows = prefill(params, tokens, cfg, scratch, lengths=lengths,
                           offsets=offsets)
    return logits, scatter_cache_rows(cache, rows, slot_ids)


def prefill_into_pages(params: Tree, tokens: Tensor, cfg: ModelConfig,
                       cache: ModelCache, lengths: Tensor, offsets: Tensor,
                       slot_ids) -> tuple[Tensor, ModelCache]:
    """Bucketed batched SUFFIX prefill straight into the shared page pools
    (DESIGN.md §8). Row r holds the tokens of slot ``slot_ids[r]`` from
    absolute position ``offsets[r]`` (its radix-matched, page-aligned
    prefix already sits in shared pages) up to total valid length
    ``lengths[r]``; it computes only the suffix, attends through its page
    table (prefix K/V read through the gather K6, never copied), and
    writes the new K/V into the pages the engine assigned it. Ids outside
    [0, slots) are dummy rows: their table view is all-trash and their
    length 0, so they write only to the trash page. Returns (last-valid
    logits, cache with the rows' lengths set); ``slot_ids`` is a host array
    or a device tensor, and every write has a fixed shape."""
    slots = cache.lengths.shape[0]
    dev = cache.lengths.device
    ids = slot_ids_tensor(slot_ids, dev)
    real = (ids >= 0) & (ids < slots)
    pt = cache.layers[0].pt
    view = torch.where(real[:, None], pt[torch.clamp(ids, 0, slots - 1)], 0)
    rows = ModelCache(layers=tuple(lc._replace(pt=view)
                                   for lc in cache.layers),
                      lengths=lengths)
    logits, _ = prefill(params, tokens, cfg, rows, lengths=lengths,
                        offsets=offsets)
    src, has = slot_sources(ids, slots, dev)
    merge_rows(cache.lengths, lengths, src, has)
    return logits, cache
