"""Parameters and paged caches from the JAX package into the port's layout.

``from_jax_params(np_tree, cfg, device)`` takes the tree that
``repro.models.model.init`` returns, already turned into numpy arrays by
the caller (this package never imports JAX), and returns the port's
parameters: the dense family, or the ``moe`` family (MLA or GQA mixers;
its dense layers, and its MoE layers with the router, the (E, d, f) /
(E, f, d) expert stacks and the shared expert's ``shared_w*``). The
reference stacks each layer group's leaves along a leading ``(layers,)``
dim; here they are sliced into one dict per layer, in layer order. ``from_jax_cache`` and
``from_jax_paged_cache`` do the same for a serving cache, GQA or MLA. bf16
leaves cross as a uint16 bit view (or numpy's ``bfloat16`` extension
dtype, which is viewed the same way).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy torch may own
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_jax_params(np_tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Reference parameter tree (numpy leaves) -> port parameters."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is "
                                  "not ported")
    layers = []
    for group in np_tree["groups"]:
        gp = group.get("params", group)
        count = int(np.asarray(gp["norm1"]["scale"]).shape[0])
        for i in range(count):
            layers.append(_map(gp, lambda a, i=i: _tensor(np.asarray(a)[i],
                                                          device)))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.n_layers}")
    kinds = ["moe" if "router" in lp["ffn"] else "dense" for lp in layers]
    if tuple(kinds) != cfg.layer_kinds():
        raise ValueError(f"the tree's layer kinds {kinds} are not the "
                         f"config's {cfg.layer_kinds()}")
    out = {"embed": _tensor(np_tree["embed"], device), "layers": layers,
           "final_norm": _map(np_tree["final_norm"],
                              lambda a: _tensor(a, device))}
    if "lm_head" in np_tree:
        out["lm_head"] = _tensor(np_tree["lm_head"], device)
    return out


def _cache_layers(np_cache: Any, device, paged: bool):
    """Per-layer caches and lengths from a reference ``ModelCache``; paged
    groups' tables (replicated over L in the reference) become one shared
    table, so the copies must agree."""
    from repro_torch.models.attention import KVCache, PagedKVCache
    from repro_torch.models.mla import MLACache, PagedMLACache

    layers = []
    pt = None
    for g in np_cache.groups:
        fields = [f for f in g._fields if f != "pt"]
        mla = "c_kv" in fields
        cls = ((PagedMLACache if mla else PagedKVCache) if paged
               else (MLACache if mla else KVCache))
        if paged:
            tables = np.asarray(g.pt)
            if not (tables == tables[:1]).all():
                raise ValueError("the page tables differ across layers")
            if pt is None:
                pt = _tensor(tables[0].astype(np.int32), device)
            elif not np.array_equal(pt.cpu().numpy(), tables[0]):
                raise ValueError("the page tables differ across layer groups")
        stacks = [np.asarray(getattr(g, f)) for f in fields]
        for i in range(stacks[0].shape[0]):
            bufs = [_tensor(a[i], device) for a in stacks]
            layers.append(cls(*bufs, pt) if paged else cls(*bufs))
    return tuple(layers), _tensor(np.asarray(np_cache.lengths, np.int32),
                                  device)


def from_jax_cache(np_cache: Any, device="cuda"):
    """Reference slot ``ModelCache`` with numpy leaves -> the port's. Each
    group holds stacked ``k``/``v`` ``(L, B, S_max, Hkv, D)`` or MLA
    ``c_kv``/``k_rope`` ``(L, B, S_max, C|R)``."""
    from repro_torch.models.model import ModelCache

    return ModelCache(*_cache_layers(np_cache, device, paged=False))


def from_jax_paged_cache(np_cache: Any, device="cuda"):
    """Reference paged ``ModelCache`` with numpy leaves (for instance the
    reference cache mapped through ``np.asarray`` leaf by leaf) -> the
    port's. Each of its ``groups`` holds stacked pools, ``k``/``v``
    ``(L, P, page, Hkv, D)`` or MLA ``c_kv``/``k_rope`` ``(L, P, page,
    C|R)``, and tables ``pt (L, B, T)``, which the reference replicates
    over L; the port keeps one table for every layer."""
    from repro_torch.models.model import ModelCache

    return ModelCache(*_cache_layers(np_cache, device, paged=True))
