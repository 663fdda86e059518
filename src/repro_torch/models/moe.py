"""Mixture-of-Experts layer (port of ``repro.models.moe``): a top-k softmax
router, sort-based capacity dispatch into an (E, C, d) expert buffer, the
experts' SwiGLU, shared experts, and the load-balance and router-z losses.

The experts are the crossbars of the train-in-memory picture: in TimeFloats
arithmetic each expert's operands take their own per-tensor prescale, as
under the reference's ``jax.vmap`` over the experts. Here the expert
products run as one batched call per group of experts
(``common.expert_mlp_apply`` -> ``timefloats.expert_linear`` -> one K1
launch per group on the card), the groups bounding the quantizer's
temporaries.

Where the port must decide what the reference leaves to XLA:

- Router logits are summed in float64 from exact f32 products and rounded
  once (as ``models/mla._exact_einsum``), so a token's logits, and so its
  routing, do not depend on how many rows the call carries.
- Top-k takes the lower expert index first on equal probabilities, as
  ``jax.lax.top_k`` does: a stable descending sort, not ``torch.topk``.
- The combine adds each token's k weighted contributions in the
  activation dtype, starting from zero, in the reference's sorted-assignment
  order (its scatter-add), one add per contribution rank, without atomics:
  the sums are the same on every run and in a captured graph.
- ``capacity_dynamic`` multiplies by the f32 reciprocal of the expert
  count, as XLA compiles the reference's division by a constant.

Left out: the reference's ``ep_mode`` / ``constrain`` sharding hints (they
do nothing on one device) and ``timefloats.census_scale`` (the op census
is not ported yet).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, cached_weight, expert_mlp_apply

Tensor = torch.Tensor


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    mo = cfg.moe
    assert mo is not None
    d, f = cfg.d_model, mo.d_expert
    specs = {
        "router": ParamSpec((d, mo.num_experts), ("embed", "experts")),
        "wg": ParamSpec((mo.num_experts, d, f), ("experts", "embed", "ffw")),
        "wu": ParamSpec((mo.num_experts, d, f), ("experts", "embed", "ffw")),
        "wd": ParamSpec((mo.num_experts, f, d), ("experts", "ffw", "embed")),
    }
    if mo.num_shared:
        fs = mo.shared_d_ff or f
        specs.update({
            "shared_wg": ParamSpec((d, mo.num_shared * fs), ("embed", "ffw")),
            "shared_wu": ParamSpec((d, mo.num_shared * fs), ("embed", "ffw")),
            "shared_wd": ParamSpec((mo.num_shared * fs, d), ("ffw", "embed")),
        })
    return specs


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    mo = cfg.moe
    c = int(math.ceil(n_tokens * mo.top_k / mo.num_experts
                      * mo.capacity_factor))
    return max(8, -(-c // 8) * 8)  # pad to multiple of 8 for layout sanity


def capacity_dynamic(n_tokens: Tensor, cfg: ModelConfig) -> Tensor:
    """:func:`capacity` of a token count held in a tensor (serving prefill:
    the real tokens of a padded admission batch), in f32 as the reference
    computes it, as an int32 tensor."""
    mo = cfg.moe
    inv = torch.full((), float(np.float32(1) / np.float32(mo.num_experts)),
                     dtype=torch.float32, device=n_tokens.device)
    c = torch.ceil(n_tokens.to(torch.float32) * mo.top_k * inv
                   * mo.capacity_factor).to(torch.int32)
    return torch.clamp_min(((c + 7) // 8) * 8, 8)


def router_logits(xf: Tensor, router: Tensor) -> Tensor:
    """(T, d) tokens x (d, E) router -> (T, E) f32 logits, each summed in
    float64 from exact products of the f32 operands, rounded once."""
    return (xf.to(torch.float32).to(torch.float64)
            @ router.to(torch.float64)).to(torch.float32)


def route(logits: Tensor, cfg: ModelConfig
          ) -> Tuple[Tensor, Tensor, Dict[str, Tensor]]:
    """logits (T, E) -> (weights (T, k), idx (T, k) int64, aux losses)."""
    mo = cfg.moe
    lf = logits.to(torch.float32)
    probs = torch.softmax(lf, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights = top.values[:, :mo.top_k]
    idx = top.indices[:, :mo.top_k]
    weights = weights / weights.sum(dim=-1, keepdim=True)
    # load-balance loss (Switch-style): E * sum_e f_e P_e
    e = mo.num_experts
    onehot = F.one_hot(idx, e).to(torch.float32)        # (T, k, E)
    f_e = onehot.sum(dim=1).mean(dim=0)                 # fraction per expert
    p_e = probs.mean(dim=0)
    lb = e * (f_e * p_e).sum() * mo.router_aux_coef
    z = (torch.logsumexp(lf, dim=-1) ** 2).mean() * mo.router_z_coef
    return weights, idx, {"lb_loss": lb, "z_loss": z}


def dispatch_indices(idx: Tensor, n_tokens: int, cap: int, n_experts: int,
                     cap_eff: Optional[Tensor] = None):
    """Sort-based dispatch bookkeeping.

    Returns (slot (T*k,), order (T*k,), keep (T*k,)): slot is the
    destination row in the (E*C) expert buffer of the a-th sorted
    assignment, E*C (the overflow row) for a dropped one; ``order`` maps
    sorted position -> original assignment index.

    ``idx`` may carry the sentinel expert ``n_experts`` for masked (pad)
    tokens: sentinels sort behind every real expert, count toward no
    expert's occupancy and are never kept. ``cap_eff`` (an int32 tensor,
    <= cap) tightens the keep threshold to the real-token capacity while
    the buffer keeps its static ``cap``. Fixed shapes throughout (no host
    sync), so a captured step can run it."""
    flat = idx.reshape(-1).to(torch.int64)
    order = torch.sort(flat, stable=True).indices
    sorted_e = flat[order]
    counts = torch.zeros(n_experts + 1, dtype=torch.int64,
                         device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    zero = counts[:1] * 0
    offsets = torch.cat([zero, torch.cumsum(counts[:n_experts], 0)[:-1],
                         zero])       # the sentinel's offset is 0
    pos = torch.arange(flat.shape[0], device=flat.device) - offsets[sorted_e]
    limit = (cap if cap_eff is None
             else torch.clamp_max(cap_eff.to(torch.int64), cap))
    keep = (pos < limit) & (sorted_e < n_experts)
    slot = torch.where(keep, sorted_e * cap + pos, n_experts * cap)
    return slot, order, keep


def moe_apply(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
              token_mask: Optional[Tensor] = None, drop_free: bool = False
              ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x (B, S, d) -> (y, aux). Dispatch is over the flattened tokens, in
    chunks of ``moe.dispatch_chunk`` when set and dividing them (the
    reference's scan, a loop here; aux is the chunks' mean).

    ``token_mask`` (B, S) bool marks the real tokens of a padded serving
    batch: the others route to the sentinel expert (they never take
    capacity) and the capacity follows the real count.

    ``drop_free`` raises each expert's capacity to the token count, so no
    assignment drops (the speculative verify: its routing must keep what
    single-token decode dispatches keep)."""
    mo = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    mf = None if token_mask is None else token_mask.reshape(t)
    ck = mo.dispatch_chunk
    if ck and t > ck and t % ck == 0:
        ys, auxs = [], []
        for i in range(0, t, ck):
            yi, ai = _moe_tokens(params, xf[i:i + ck], cfg,
                                 token_mask=None if mf is None
                                 else mf[i:i + ck], drop_free=drop_free)
            ys.append(yi)
            auxs.append(ai)
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        y = torch.cat(ys)
        return y.reshape(b, s, d).to(cfg.activation_dtype), aux
    y, aux = _moe_tokens(params, xf, cfg, token_mask=mf, drop_free=drop_free)
    return y.reshape(b, s, d).to(cfg.activation_dtype), aux


def ordered_combine(upd: Tensor, order: Tensor, n_tokens: int, k: int
                    ) -> Tensor:
    """y[t] = sum of token t's k rows of ``upd`` (T*k, d), in sorted
    position order, from zero, in upd's dtype: the reference's scatter-add
    of the sorted assignments, one add per contribution rank."""
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    per_tok = torch.sort(rank.reshape(n_tokens, k), dim=1).values
    y = torch.zeros((n_tokens, upd.shape[1]), dtype=upd.dtype,
                    device=upd.device)
    for j in range(k):
        y = y + upd[per_tok[:, j]]
    return y


def _moe_tokens(params: Dict[str, Tensor], xf: Tensor, cfg: ModelConfig,
                token_mask: Optional[Tensor] = None, drop_free: bool = False
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """(T, d) tokens -> (T, d) output + aux; one dispatch buffer."""
    mo = cfg.moe
    t, d = xf.shape
    e, k = mo.num_experts, mo.top_k
    weights, idx, aux = route(router_logits(xf, params["router"]), cfg)

    cap = capacity(t, cfg)
    cap_eff = None
    if drop_free:
        # An expert takes at most one assignment per token (a token's k
        # experts are distinct), so cap == t keeps everything.
        cap = t
    elif token_mask is not None:
        idx = torch.where(token_mask[:, None], idx, e)
        cap_eff = capacity_dynamic(token_mask.to(torch.int32).sum(), cfg)
    slot, order, keep = dispatch_indices(idx, t, cap, e, cap_eff=cap_eff)
    tok_of_sorted = order // k

    # The (E, C, d) expert buffer; dropped assignments land on the
    # overflow row, which is cut off.
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf = buf.index_put((slot,), xf[tok_of_sorted])
    xe = buf[:e * cap].reshape(e, cap, d)

    pws = tuple(cached_weight(params[n]) for n in ("wg", "wu", "wd"))
    ye = expert_mlp_apply(params["wg"], params["wu"], params["wd"], xe, cfg,
                          pws=pws if all(p is not None for p in pws)
                          else None)

    # Combine in the activation dtype (the reference's bf16 scatter-add).
    adt = cfg.activation_dtype
    ye_flat = torch.cat([ye.reshape(e * cap, d), ye.new_zeros((1, d))])
    contrib = ye_flat[slot]                      # (T*k, d), sorted order
    w_sorted = weights.reshape(-1)[order] * keep.to(torch.float32)
    upd = (contrib.to(torch.float32) * w_sorted[:, None]).to(adt)
    y = ordered_combine(upd, order, t, k)

    if mo.num_shared:
        y = y + expert_mlp_apply(params["shared_wg"], params["shared_wu"],
                                 params["shared_wd"], xf, cfg).to(adt)
    aux["dropped_frac"] = 1.0 - keep.to(torch.float32).mean()
    return y.to(adt), aux


def moe_apply_reference(params: Dict[str, Tensor], x: Tensor,
                        cfg: ModelConfig) -> Tensor:
    """O(T*E) dense reference (every expert sees every token, masked), to
    validate the sort-based dispatch. No capacity drops."""
    mo = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    weights, idx, _ = route(router_logits(xf, params["router"]), cfg)
    xs = xf.expand(mo.num_experts, *xf.shape)
    ye = expert_mlp_apply(params["wg"], params["wu"], params["wd"], xs,
                          cfg)                                # (E, T, d)
    onehot = F.one_hot(idx, mo.num_experts).to(torch.float32)  # (T, k, E)
    comb = torch.einsum("tke,k->te", onehot * weights[..., None],
                        torch.ones(mo.top_k, device=x.device))
    y = torch.einsum("te,etd->td", comb, ye.to(torch.float32))
    if mo.num_shared:
        y = y + expert_mlp_apply(params["shared_wg"], params["shared_wu"],
                                 params["shared_wd"], xf, cfg
                                 ).to(torch.float32)
    return y.reshape(b, s, d).to(cfg.activation_dtype)
