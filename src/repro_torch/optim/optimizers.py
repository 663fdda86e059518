"""Optimizers (port of ``repro.optim.optimizers``): SGD (+momentum), AdamW,
Adafactor, and the paper's in-situ FP8 update mode.

The formulas are the reference's, written out: AdamW with ``b2=0.95``,
``eps`` outside the square root and weight decay only on leaves with
ndim >= 2; Adafactor with factored second moments and RMS update clipping.
``torch.optim`` is not used: its AdamW differs (decoupled decay applied
before the step, eps placement). Updates are functional, as in the
reference: ``update`` returns new parameter and state trees and leaves its
inputs untouched, so a caller may keep an earlier state.

In-situ mode (train-in-memory): after every update the >= 2-D parameters
are re-quantized onto the E4M4 grid relative to their pow2 reference,
``w <- Q(w - lr*g)``, with stochastic rounding drawn from a
``torch.Generator`` (the reference draws from a JAX key, so the two agree
in distribution only; without stochastic rounding they agree exactly).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import float8
from repro_torch.core.timefloats import TFConfig
from repro_torch.optim import schedules

Tensor = torch.Tensor
Tree = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"             # sgd | adamw | adafactor
    lr: float = 3e-4
    schedule: str = "warmup_cosine"
    warmup: int = 100
    total_steps: int = 10000
    momentum: float = 0.9
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    # in-situ FP8 storage (the paper's mode); None -> master weights
    insitu: Optional[TFConfig] = None
    stochastic_rounding: bool = True


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[..., tuple]


def global_norm(tree: Tree) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_lib.leaves(tree)))


def clip_by_global_norm(grads: Tree, max_norm: float) -> tuple[Tree, Tensor]:
    gn = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)
    return tree_lib.tree_map(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gn


def _maybe_requantize(cfg: OptimizerConfig, params: Tree,
                      generator: Optional[torch.Generator]) -> Tree:
    if cfg.insitu is None:
        return params
    fmt = cfg.insitu.fmt
    gen = generator if cfg.stochastic_rounding else None

    def q(x):
        if x.ndim < 2:  # norms/biases stay digital (periphery registers)
            return x
        # Scale-aware: codes are relative to the per-tensor reference; the
        # raw grid would flush sub-min-normal weights to zero.
        return float8.quantize_scaled(x, fmt, generator=gen)

    return tree_lib.tree_map(q, params)


def _f32(t) -> Tensor:
    return t.to(torch.float32)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    sched = schedules.get(cfg.schedule, cfg.lr, cfg.warmup, cfg.total_steps)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)

    def scalars(params, step, *vals):
        """The step's lr (and any other f32 scalars) on the params' device,
        so the updates never mix a host scalar into device arithmetic."""
        dev = tree_lib.leaves(params)[0].device
        return [v.to(dev) for v in (sched(step), *vals)]

    if cfg.name == "sgd":
        def init(params):
            return {"mom": tree_lib.tree_map(zeros, params)} \
                if cfg.momentum else {}

        def update(grads, state, params, step, generator=None):
            (lr,) = scalars(params, step)
            if cfg.momentum:
                delta = tree_lib.tree_map(
                    lambda m, g: cfg.momentum * m + _f32(g), state["mom"],
                    grads)
                state = {"mom": delta}
            else:
                delta = tree_lib.tree_map(_f32, grads)
            new = tree_lib.tree_map(
                lambda p, d: (_f32(p) - lr * d).to(p.dtype), params, delta)
            return _maybe_requantize(cfg, new, generator), state

        return Optimizer(init, update)

    if cfg.name == "adamw":
        def init(params):
            return {"m": tree_lib.tree_map(zeros, params),
                    "v": tree_lib.tree_map(zeros, params)}

        def update(grads, state, params, step, generator=None):
            t = torch.tensor(step + 1.0, dtype=torch.float32)
            lr, bc1, bc2 = scalars(
                params, step,
                1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), t),
                1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), t))
            m = tree_lib.tree_map(
                lambda m, g: cfg.b1 * m + (1 - cfg.b1) * _f32(g),
                state["m"], grads)
            v = tree_lib.tree_map(
                lambda v, g: cfg.b2 * v + (1 - cfg.b2) * torch.square(_f32(g)),
                state["v"], grads)

            def upd(p, m, v):
                step_ = lr * (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                if cfg.weight_decay and p.ndim >= 2:
                    step_ = step_ + lr * cfg.weight_decay * _f32(p)
                return (_f32(p) - step_).to(p.dtype)

            new = tree_lib.tree_map(upd, params, m, v)
            return _maybe_requantize(cfg, new, generator), {"m": m, "v": v}

        return Optimizer(init, update)

    if cfg.name == "adafactor":
        # Factored second moments for >= 2-D params: O(sum of dims) state.
        def init(params):
            def f(p):
                if p.ndim >= 2:
                    return {"vr": zeros(p[..., 0]), "vc": zeros(p[..., 0, :])}
                return {"v": zeros(p)}

            return {"fac": tree_lib.tree_map(f, params)}

        def update(grads, state, params, step, generator=None):
            lr, decay = scalars(params, step, 1.0 - torch.pow(
                torch.tensor(step + 1.0, dtype=torch.float32), -0.8))

            def upd(p, g, s):
                g = _f32(g)
                g2 = torch.square(g) + 1e-30
                if p.ndim >= 2:
                    vr = decay * s["vr"] + (1 - decay) * g2.mean(dim=-1)
                    vc = decay * s["vc"] + (1 - decay) * g2.mean(dim=-2)
                    denom = torch.clamp_min(vr.mean(dim=-1, keepdim=True),
                                            1e-30)
                    vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
                    u = g / (torch.sqrt(vhat) + 1e-30)
                    ns = {"vr": vr, "vc": vc}
                else:
                    v = decay * s["v"] + (1 - decay) * g2
                    u = g / (torch.sqrt(v) + 1e-30)
                    ns = {"v": v}
                # update clipping (RMS <= 1), standard adafactor
                rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
                u = u / torch.clamp_min(rms, 1.0)
                return (_f32(p) - lr * u).to(p.dtype), ns

            # The state tree holds a dict per parameter leaf; tree_map walks
            # the params' structure and hands each leaf its dict.
            out = tree_lib.tree_map(upd, params, grads, state["fac"])
            new = tree_lib.tree_map(lambda _, o: o[0], params, out)
            fac = tree_lib.tree_map(lambda _, o: o[1], params, out)
            return _maybe_requantize(cfg, new, generator), {"fac": fac}

        return Optimizer(init, update)

    raise ValueError(cfg.name)
