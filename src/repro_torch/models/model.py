"""LMModel, dense family (port of ``repro.models.model``): parameters, the
layer loop, the full-sequence training forward and loss, the slot cache and
the serving steps ``prefill`` / ``decode_step`` / ``prefill_into_slots``.

The reference stacks layers and scans them; here the parameters hold a list
of per-layer dicts (``params["layers"]``) and a Python loop walks it. Its
``remat="full"`` (``jax.checkpoint`` of the scan body) becomes
``torch.utils.checkpoint`` around each block. Other families (MoE, MLA,
SSM, hybrid, audio, VLM) come with later slices.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import common
from repro_torch.models.attention import KVCache, MaskSpec
from repro_torch.models.common import (ParamSpec, dense, init_params,
                                       mlp_apply, mlp_specs, norm_apply,
                                       norm_specs)

Tensor = torch.Tensor
Tree = Any


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.mla is not None:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")


def default_mask(cfg: ModelConfig) -> MaskSpec:
    return MaskSpec(causal=True,
                    prefix_len=(cfg.num_prefix_tokens
                                if cfg.prefix_bidirectional else 0),
                    window=cfg.sliding_window)


def block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"norm1": norm_specs(cfg), "mixer": attn_mod.attention_specs(cfg),
            "norm2": norm_specs(cfg), "ffn": mlp_specs(cfg)}


def block_apply(params: Dict[str, Any], x: Tensor, cfg: ModelConfig, *,
                positions: Tensor, cache: Optional[KVCache],
                lengths: Optional[Tensor]
                ) -> tuple[Tensor, Optional[KVCache]]:
    h = norm_apply(params["norm1"], x, cfg)
    y, cache = attn_mod.attention_apply(
        params["mixer"], h, cfg, mask=default_mask(cfg), positions=positions,
        cache=cache, lengths=lengths)
    x = x + y
    h2 = norm_apply(params["norm2"], x, cfg)
    return x + mlp_apply(params["ffn"], h2, cfg), cache


def model_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _require_dense(cfg)
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           init="embed", scale=0.02),
        "layers": [block_specs(cfg) for _ in range(cfg.n_layers)],
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
                positions: Tensor, caches: List[KVCache], lengths: Tensor
                ) -> tuple[Tensor, List[KVCache]]:
    new = []
    for lp, lc in zip(params["layers"], caches):
        x, lc = block_apply(lp, x, cfg, positions=positions, cache=lc,
                            lengths=lengths)
        new.append(lc)
    return x, new


def _sequence_layers(params: Tree, x: Tensor, cfg: ModelConfig,
                     positions: Tensor, remat: str) -> Tensor:
    """The layer loop of the full-sequence forward. With ``remat="full"``
    each block is checkpointed: its activations are dropped after the
    forward and recomputed in the backward. The recomputation runs after
    the loss has left its weight-cache scope, so each block reinstalls the
    table it saw in the forward."""
    if remat == "dots":
        raise NotImplementedError('remat="dots" is not ported yet')
    table = common.active_weight_cache()

    def block(lp, h):
        with common.weight_cache_scope(table):
            return block_apply(lp, h, cfg, positions=positions, cache=None,
                               lengths=None)[0]

    for lp in params["layers"]:
        if remat == "full":
            x = torch.utils.checkpoint.checkpoint(
                block, lp, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(lp, x)
    return x


def forward(params: Tree, batch: Dict[str, Tensor], cfg: ModelConfig, *,
            train: bool = True) -> tuple[Tensor, Dict[str, Tensor]]:
    """Full-sequence forward -> (logits (B, S, V) f32, aux). ``train``
    applies ``cfg.remat`` to the layer loop."""
    _require_dense(cfg)
    x = embed_tokens(params, batch["tokens"], cfg)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    x = _sequence_layers(params, x, cfg, positions,
                         cfg.remat if train else "none")
    x = norm_apply(params["final_norm"], x, cfg)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"lb_loss": zero, "z_loss": zero, "dropped_frac": zero}
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
    """Masked mean next-token cross entropy (plus the MoE aux terms, zero
    for the dense family), and the reference's metrics."""
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
    layers: tuple                # per-layer KVCache
    lengths: Tensor              # (B,) int32 valid lengths


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> ModelCache:
    _require_dense(cfg)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = cfg.activation_dtype
    layers = tuple(KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                           v=torch.zeros(shape, dtype=dt, device=device))
                   for _ in range(cfg.n_layers))
    return ModelCache(layers=layers,
                      lengths=torch.zeros((batch,), dtype=torch.int32,
                                          device=device))


def decode_step(params: Tree, cache: ModelCache, tokens: Tensor,
                cfg: ModelConfig) -> tuple[Tensor, ModelCache]:
    """One decode step. tokens (B, 1). Positions are cache.lengths (append
    at the end); lengths advance by 1. Returns (logits (B, 1, V), cache)."""
    x = embed_tokens(params, tokens, cfg)
    positions = cache.lengths[:, None]
    lengths = cache.lengths + 1
    x, layers = _run_layers(params, x, cfg, positions=positions,
                            caches=list(cache.layers), lengths=lengths)
    x = norm_apply(params["final_norm"], x, cfg)
    return _head(params, x, cfg), ModelCache(tuple(layers), lengths)


def prefill(params: Tree, tokens: Tensor, cfg: ModelConfig,
            cache: ModelCache, *, lengths: Tensor | None = None
            ) -> tuple[Tensor, ModelCache]:
    """Run right-padded prompts (B, S) through the model, writing K/V at
    positions [0, S) of ``cache``. ``lengths`` (B,) are the per-row valid
    lengths (ragged prefill; None = all S). Returns the logits at each
    row's last valid position (B, 1, V) and the cache."""
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
    x, layers = _run_layers(params, x, cfg, positions=positions,
                            caches=list(cache.layers), lengths=lengths)
    x = norm_apply(params["final_norm"], x, cfg)
    idx = torch.clamp(lengths.to(torch.int64) - 1, 0, s - 1)
    last = x[torch.arange(b, device=x.device), idx][:, None]
    return _head(params, last, cfg), ModelCache(tuple(layers), lengths)


def scatter_cache_rows(full: ModelCache, rows: ModelCache,
                       slot_ids: np.ndarray) -> ModelCache:
    """Write row j of ``rows`` into batch row ``slot_ids[j]`` of ``full``,
    in place. Ids outside [0, slots) are padding rows and are dropped
    (never clamped); the ids are host data, so the filter costs no
    device sync."""
    slots = full.lengths.shape[0]
    ids = np.asarray(slot_ids)
    keep = np.nonzero((ids >= 0) & (ids < slots))[0]
    if keep.size == 0:
        return full
    dev = full.lengths.device
    src = torch.as_tensor(keep, device=dev)
    dst = torch.as_tensor(ids[keep].astype(np.int64), device=dev)
    for f, r in zip(full.layers, rows.layers):
        f.k[dst] = r.k[src]
        f.v[dst] = r.v[src]
    full.lengths[dst] = rows.lengths[src].to(full.lengths.dtype)
    return full


def prefill_into_slots(params: Tree, tokens: Tensor, cfg: ModelConfig,
                       cache: ModelCache, lengths: Tensor,
                       slot_ids: np.ndarray, *, max_len: int
                       ) -> tuple[Tensor, ModelCache]:
    """Bucketed batched prefill straight into slot rows: one ragged
    ``prefill`` on a throwaway cache, whose rows (and lengths) then land in
    ``cache`` at ``slot_ids``; out-of-range ids are padding rows."""
    scratch = init_cache(cfg, tokens.shape[0], max_len, tokens.device)
    logits, rows = prefill(params, tokens, cfg, scratch, lengths=lengths)
    return logits, scatter_cache_rows(cache, rows, slot_ids)
