"""Parameters from the JAX package into the port's layout.

``from_jax_params(np_tree, cfg, device)`` takes the tree that
``repro.models.model.init`` returns, already turned into numpy arrays by
the caller (this package never imports JAX), and returns the port's
parameters. The reference stacks each layer group's leaves along a leading
``(layers,)`` dim; here they are sliced into one dict per layer. bf16
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
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
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
    out = {"embed": _tensor(np_tree["embed"], device), "layers": layers,
           "final_norm": _map(np_tree["final_norm"],
                              lambda a: _tensor(a, device))}
    if "lm_head" in np_tree:
        out["lm_head"] = _tensor(np_tree["lm_head"], device)
    return out
