"""Train step factory (port of ``repro.train.step``): gradient
accumulation over microbatches, global-norm clipping, the optimizer update
and optional in-situ FP8 requantization.

The per-step weight cache (DESIGN.md §3) is built once per step, outside
autograd and outside the microbatch loop, from the very tensors the loss
differentiates, so ``dense()`` finds every eligible weight in it. The
reference's sharding constraints are dropped: one card has no mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, model as model_lib
from repro_torch.optim.optimizers import (OptimizerConfig, clip_by_global_norm,
                                          make_optimizer)

Tensor = torch.Tensor
Tree = Any

METRIC_KEYS = ("loss", "ce", "lb_loss", "z_loss", "dropped_frac", "tokens")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    accum: int = 1                    # gradient-accumulation microbatches
    accum_dtype: str = "float32"      # float32 | bfloat16


class TrainState(NamedTuple):
    step: int
    params: Tree
    opt: Tree
    generator: torch.Generator        # stochastic rounding (in-situ mode)


def init_state(model_cfg: ModelConfig, train_cfg: TrainConfig, seed: int,
               device="cuda") -> TrainState:
    """Parameters from ``seed``; the rounding generator from ``seed + 1``."""
    params = model_lib.init(model_cfg, seed, device)
    opt = make_optimizer(train_cfg.optimizer).init(params)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return TrainState(step=0, params=params, opt=opt, generator=gen)


def loss_and_grads(model_cfg: ModelConfig, params: Tree,
                   batch: Dict[str, Tensor]
                   ) -> Tuple[Dict[str, Tensor], Tree]:
    """(metrics, grads) of one batch, the weight cache built first from
    the differentiated tensors (outside autograd)."""
    leaves = tree_lib.tree_map(lambda p: p.detach().requires_grad_(True),
                               params)
    wcache = common.build_weight_cache(leaves, model_cfg)
    with common.weight_cache_scope(wcache):
        loss, metrics = model_lib.loss_fn(leaves, batch, model_cfg)
    flat = tree_lib.leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, grads))
    return ({k: v.detach() for k, v in metrics.items()},
            tree_lib.tree_map(lambda _: next(it), params))


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    optimizer = make_optimizer(train_cfg.optimizer)
    adt = getattr(torch, train_cfg.accum_dtype)

    def train_step(state: TrainState, batch: Dict[str, Tensor]
                   ) -> Tuple[TrainState, Dict[str, Tensor]]:
        a = train_cfg.accum
        if a == 1:
            metrics, grads = loss_and_grads(model_cfg, state.params, batch)
        else:
            for v in batch.values():
                if v.shape[0] % a:
                    raise ValueError(f"batch {v.shape[0]} not divisible by "
                                     f"accum {a}")
            gsum = msum = None
            for i in range(a):
                # Microbatch i takes rows i, i+a, ... as the reference's
                # (B/a, a) reshape and swap do.
                mb = {k: v[i::a] for k, v in batch.items()}
                m, g = loss_and_grads(model_cfg, state.params, mb)
                g = tree_lib.tree_map(lambda t: t.to(adt), g)
                gsum = g if gsum is None else tree_lib.tree_map(
                    torch.add, gsum, g)
                m = {k: m[k].to(torch.float32) for k in METRIC_KEYS}
                msum = m if msum is None else {k: msum[k] + m[k] for k in m}
            grads = tree_lib.tree_map(lambda g: (g / a).to(torch.float32),
                                      gsum)
            metrics = {k: v / a for k, v in msum.items()}
            metrics["tokens"] = msum["tokens"]

        grads, gnorm = clip_by_global_norm(grads,
                                           train_cfg.optimizer.grad_clip)
        params, opt = optimizer.update(grads, state.opt, state.params,
                                       state.step, generator=state.generator)
        metrics = dict(metrics, grad_norm=gnorm,
                       lr_step=torch.tensor(float(state.step)))
        return TrainState(step=state.step + 1, params=params, opt=opt,
                          generator=state.generator), metrics

    return train_step
