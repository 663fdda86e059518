"""Optimizers (port of ``repro.optim.optimizers``): SGD (+momentum), AdamW,
Adafactor, and the paper's in-situ FP8 update mode.

The formulas are the reference's, written out: AdamW with ``b2=0.95``,
``eps`` outside the square root and weight decay only on leaves with
ndim >= 2; Adafactor with factored second moments and RMS update clipping.
``torch.optim`` is not used: its AdamW differs (decoupled decay applied
before the step, eps placement). Each optimizer's arithmetic is written
once, as an in-place update (``apply_``): leaf by leaf, each new moment and
parameter is computed as the reference computes it and written into its
tensor before the next leaf, so at most one leaf's temporaries are alive
(the training step's static buffers, train/step.py). ``update`` is the
functional form, as in the reference: it applies the same arithmetic to
copies and leaves its inputs untouched. The step's f32 scalars (the rate,
AdamW's bias corrections, Adafactor's decay) are made on the host by
``scalars`` exactly as before and handed to ``apply_`` as one device
vector, so a captured step reads them from a static buffer.

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
    scalars: Callable[[int], Tensor]
    apply_: Callable[..., None]


def global_norm(tree: Tree) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_lib.leaves(tree)))


def clip_scale(grads: Tree, max_norm: float) -> tuple[Tensor, Tensor]:
    """(the factor every gradient is multiplied by, the global norm)."""
    gn = global_norm(grads)
    return torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0), gn


def _clipped(g: Tensor, scale: Optional[Tensor]) -> Tensor:
    return g if scale is None else (g.to(torch.float32) * scale).to(g.dtype)


def clip_by_global_norm(grads: Tree, max_norm: float) -> tuple[Tree, Tensor]:
    scale, gn = clip_scale(grads, max_norm)
    return tree_lib.tree_map(lambda g: _clipped(g, scale), grads), gn


def _requantized(cfg: OptimizerConfig, x: Tensor,
                 generator: Optional[torch.Generator]) -> Tensor:
    """In-situ mode: a >= 2-D parameter back on the E4M4 grid."""
    if cfg.insitu is None or x.ndim < 2:  # norms/biases stay digital
        return x
    # Scale-aware: codes are relative to the per-tensor reference; the raw
    # grid would flush sub-min-normal weights to zero.
    return float8.quantize_scaled(
        x, cfg.insitu.fmt,
        generator=generator if cfg.stochastic_rounding else None)


def _f32(t) -> Tensor:
    return t.to(torch.float32)


def _clone(tree: Tree) -> Tree:
    return tree_lib.tree_map(lambda t: t.clone(), tree)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    sched = schedules.get(cfg.schedule, cfg.lr, cfg.warmup, cfg.total_steps)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)

    # Per optimizer: ``init``; ``scalars(step)``, the step's f32 host
    # scalars (the rate first); ``leaf(p, g, s, scal)``, which writes one
    # parameter's new moments into its state dict ``s`` and returns its
    # new value; ``moments``, those dicts in leaf order.
    if cfg.name == "sgd":
        def init(params):
            return {"mom": tree_lib.tree_map(zeros, params)} \
                if cfg.momentum else {}

        def scalars(step):
            return torch.stack([sched(step)])

        def leaf(p, g, s, scal):
            lr = scal[0]
            if cfg.momentum:
                d = cfg.momentum * s["mom"] + _f32(g)
                s["mom"].copy_(d)
            else:
                d = _f32(g)
            return (_f32(p) - lr * d).to(p.dtype)

        def moments(state, params):
            if cfg.momentum:
                return _per_param(lambda m: {"mom": m}, params, state["mom"])
            return _per_param(dict, params)

    elif cfg.name == "adamw":
        def init(params):
            return {"m": tree_lib.tree_map(zeros, params),
                    "v": tree_lib.tree_map(zeros, params)}

        def scalars(step):
            t = torch.tensor(step + 1.0, dtype=torch.float32)
            return torch.stack([
                sched(step),
                1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), t),
                1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), t)])

        def leaf(p, g, s, scal):
            lr, bc1, bc2 = scal[0], scal[1], scal[2]
            m = cfg.b1 * s["m"] + (1 - cfg.b1) * _f32(g)
            s["m"].copy_(m)
            v = cfg.b2 * s["v"] + (1 - cfg.b2) * torch.square(_f32(g))
            s["v"].copy_(v)
            step_ = lr * (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.weight_decay and p.ndim >= 2:
                step_ = step_ + lr * cfg.weight_decay * _f32(p)
            return (_f32(p) - step_).to(p.dtype)

        def moments(state, params):
            return _per_param(lambda m, v: {"m": m, "v": v}, params,
                              state["m"], state["v"])

    elif cfg.name == "adafactor":
        # Factored second moments for >= 2-D params: O(sum of dims) state.
        def init(params):
            def f(p):
                if p.ndim >= 2:
                    return {"vr": zeros(p[..., 0]), "vc": zeros(p[..., 0, :])}
                return {"v": zeros(p)}

            return {"fac": tree_lib.tree_map(f, params)}

        def scalars(step):
            return torch.stack([sched(step), 1.0 - torch.pow(
                torch.tensor(step + 1.0, dtype=torch.float32), -0.8)])

        def leaf(p, g, s, scal):
            lr, decay = scal[0], scal[1]
            g = _f32(g)
            g2 = torch.square(g) + 1e-30
            if p.ndim >= 2:
                vr = decay * s["vr"] + (1 - decay) * g2.mean(dim=-1)
                vc = decay * s["vc"] + (1 - decay) * g2.mean(dim=-2)
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
                denom = torch.clamp_min(vr.mean(dim=-1, keepdim=True), 1e-30)
                vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
                u = g / (torch.sqrt(vhat) + 1e-30)
            else:
                v = decay * s["v"] + (1 - decay) * g2
                s["v"].copy_(v)
                u = g / (torch.sqrt(v) + 1e-30)
            # update clipping (RMS <= 1), standard adafactor
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp_min(rms, 1.0)
            return (_f32(p) - lr * u).to(p.dtype)

        def moments(state, params):
            # The state tree holds a dict per parameter leaf.
            return _per_param(lambda f: f, params, state["fac"])

    else:
        raise ValueError(cfg.name)

    @torch.no_grad()
    def apply_(grads, state, params, scal: Tensor,
               generator: Optional[torch.Generator] = None,
               clip: Optional[Tensor] = None) -> None:
        """Update ``params`` and ``state`` in place, leaf by leaf: the
        gradient times ``clip`` (when given), the new moments, the new
        parameter, then (in-situ mode) its requantization, each written
        before the next leaf. ``scal`` is ``scalars(step)`` on the params'
        device."""
        for p, g, s in zip(tree_lib.leaves(params), tree_lib.leaves(grads),
                           moments(state, params)):
            p.copy_(_requantized(cfg, leaf(p, _clipped(g, clip), s, scal),
                                 generator))

    def update(grads, state, params, step, generator=None):
        """Functional: new (params, state) from copies; the inputs are
        untouched."""
        params, state = _clone(params), _clone(state)
        dev = tree_lib.leaves(params)[0].device
        apply_(grads, state, params, scalars(step).to(dev), generator)
        return params, state

    return Optimizer(init, update, scalars, apply_)


def _per_param(fn: Callable, params: Tree, *state: Tree) -> list:
    """``fn`` of each parameter's state subtrees, in leaf order: tree_map
    walks the params' structure and hands each leaf the subtree (a tensor
    or a dict of tensors) at its place in every ``state`` tree."""
    out: list = []
    tree_lib.tree_map(lambda _, *s: out.append(fn(*s)), params, *state)
    return out
