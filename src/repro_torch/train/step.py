"""Train step factory (port of ``repro.train.step``): gradient
accumulation over microbatches, global-norm clipping, the optimizer update
and optional in-situ FP8 requantization.

The per-step weight cache (DESIGN.md §3) is built once per step, outside
autograd and outside the microbatch loop, from the very tensors the loss
differentiates, so ``dense()`` finds every eligible weight in it. The
reference's sharding constraints are dropped: one card has no mesh.

Compile discipline: the reference runs ``jax.jit(train_step,
donate_argnums=(0,))``, traced once per batch shape, its state buffers
reused in place. Here :func:`make_train_step` builds one step callable per
static batch shape through ``serve/request.StepGraphs`` (counted in
``graphs.counts``): on the card the first call of a shape runs eagerly as
its warm-up (its results stand), is then captured into a CUDA graph, and
every later call replays it. Parameters, optimizer state and the rounding
generator live in the step's static buffers and are updated in place; the
step's f32 scalars are made on the host and copied in before each call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, model as model_lib
from repro_torch.optim.optimizers import (OptimizerConfig, clip_scale,
                                          make_optimizer)
from repro_torch.serve.request import StepGraphs

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


def accumulated_grads(model_cfg: ModelConfig, train_cfg: TrainConfig,
                      params: Tree, batch: Dict[str, Tensor]
                      ) -> Tuple[Dict[str, Tensor], Tree]:
    """(metrics, grads) of a step's batch: one :func:`loss_and_grads`, or
    with ``accum`` > 1 the mean over its microbatches, summed in
    ``accum_dtype``."""
    a = train_cfg.accum
    if a == 1:
        return loss_and_grads(model_cfg, params, batch)
    for v in batch.values():
        if v.shape[0] % a:
            raise ValueError(f"batch {v.shape[0]} not divisible by "
                             f"accum {a}")
    adt = getattr(torch, train_cfg.accum_dtype)
    gsum = msum = None
    for i in range(a):
        # Microbatch i takes rows i, i+a, ... as the reference's (B/a, a)
        # reshape and swap do.
        mb = {k: v[i::a] for k, v in batch.items()}
        m, g = loss_and_grads(model_cfg, params, mb)
        g = tree_lib.tree_map(lambda t: t.to(adt), g)
        gsum = g if gsum is None else tree_lib.tree_map(torch.add, gsum, g)
        m = {k: m[k].to(torch.float32) for k in METRIC_KEYS}
        msum = m if msum is None else {k: msum[k] + m[k] for k in m}
    grads = tree_lib.tree_map(lambda g: (g / a).to(torch.float32), gsum)
    metrics = {k: v / a for k, v in msum.items()}
    metrics["tokens"] = msum["tokens"]
    return metrics, grads


# The step's outputs, one f32 vector in this order.
OUT_KEYS = METRIC_KEYS + ("grad_norm",)


class TrainStep:
    """``(state, batch) -> (state, metrics)``, one step program per static
    batch shape (:func:`make_train_step`).

    Donation, as under the reference's donated jit: parameters, optimizer
    state and the rounding generator live in this step's static buffers
    and are updated in place. A call whose state is not those buffers (the
    first call, a restored checkpoint, an older state) copies it in first,
    so the caller's own state is never written. The returned
    ``TrainState`` aliases the buffers: the next call overwrites it, as a
    donated JAX buffer is consumed. Its metrics are a copy and stay.
    """

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 graphs: Optional[bool] = None):
        self.model_cfg, self.train_cfg = model_cfg, train_cfg
        self.optimizer = make_optimizer(train_cfg.optimizer)
        self.want_graphs = graphs
        self.graphs: Optional[StepGraphs] = None  # made at the first call
        self.state: Optional[TrainState] = None   # the static buffers

    def _bind(self, state: TrainState) -> None:
        """Make the static buffers at the first call, on the device of
        ``state``'s generator; copy ``state`` into them unless it is them.
        A state whose leaves are the buffers must be the latest one: an
        older returned state aliases them too, but its step has passed."""
        if self.state is None:
            # The generator names no index ("cuda"); a tensor made there
            # does.
            dev = torch.empty(0, device=state.generator.device).device
            for t in tree_lib.leaves((state.params, state.opt)):
                if t.device not in (dev, torch.device("cpu")):
                    raise ValueError(f"a state leaf lies on {t.device}, its "
                                     f"generator on {dev}")
            capture = (dev.type == "cuda" if self.want_graphs is None
                       else self.want_graphs)
            gen = torch.Generator(device=dev)
            clone = lambda t: torch.empty_like(  # noqa: E731
                t, device=dev).copy_(t)
            self.state = TrainState(
                step=state.step, params=tree_lib.tree_map(clone, state.params),
                opt=tree_lib.tree_map(clone, state.opt), generator=gen)
            self.graphs = StepGraphs(dev, capture=capture,
                                     generators=(gen,) if capture else ())
            gen.set_state(state.generator.get_state())
            return
        own = self.state
        mine = tree_lib.leaves((own.params, own.opt))
        theirs = tree_lib.leaves((state.params, state.opt))
        if len(mine) != len(theirs):
            raise ValueError("the state does not match the step's buffers")
        aliased = all(a is b for a, b in zip(mine, theirs))
        if aliased and state.step != own.step:
            raise ValueError(f"a state of step {state.step} aliases the "
                             f"step's buffers, which hold step {own.step}: "
                             f"a later call consumed it")
        if state.generator is not own.generator:
            own.generator.set_state(state.generator.get_state())
        if aliased:
            return
        with torch.no_grad():
            for a, b in zip(mine, theirs):
                if a.shape != b.shape:
                    raise ValueError(f"state leaf {tuple(b.shape)} does not "
                                     f"match its buffer {tuple(a.shape)}")
                a.copy_(b)

    def _body(self, keys):
        """The step program on the buffers: the batch tensors in ``keys``
        order and the scalars vector in, one metrics vector out."""
        mcfg, tcfg, own = self.model_cfg, self.train_cfg, self.state

        def fn(*inputs):
            batch, scal = dict(zip(keys, inputs[:-1])), inputs[-1]
            metrics, grads = accumulated_grads(mcfg, tcfg, own.params, batch)
            with torch.no_grad():
                clip, gnorm = clip_scale(grads, tcfg.optimizer.grad_clip)
                self.optimizer.apply_(grads, own.opt, own.params, scal,
                                      generator=own.generator, clip=clip)
            metrics = dict(metrics, grad_norm=gnorm)
            return (torch.stack([metrics[k].to(torch.float32)
                                 for k in OUT_KEYS]),)

        return fn

    def __call__(self, state: TrainState, batch: Dict[str, Tensor]
                 ) -> Tuple[TrainState, Dict[str, Tensor]]:
        self._bind(state)
        keys = sorted(batch)
        shapes = sorted({tuple(v.shape) for v in batch.values()})
        name = "train_step[" + ",".join("x".join(map(str, s))
                                        for s in shapes) + "]"
        (out,) = self.graphs.call(
            name, self._body(keys), *(batch[k] for k in keys),
            self.optimizer.scalars(state.step))
        vec = out.clone()
        metrics = {k: vec[i] for i, k in enumerate(OUT_KEYS)}
        metrics["lr_step"] = torch.tensor(float(state.step))
        self.state = self.state._replace(step=state.step + 1)
        return self.state, metrics


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    graphs: Optional[bool] = None) -> TrainStep:
    """The step callable. Its buffers lie where the first state's generator
    lies (a state whose tensors wait on the host, as :func:`on_host` makes
    it, is copied onto the card). ``graphs=None`` captures a CUDA graph per
    batch shape when the buffers lie on the card and runs eagerly on the
    CPU; ``graphs=False`` runs the same program eagerly (the A/B arm);
    ``graphs=True`` with buffers on the CPU raises."""
    return TrainStep(model_cfg, train_cfg, graphs)


def on_host(state: TrainState) -> TrainState:
    """A copy of ``state``'s tensors in host memory, its generator kept: an
    initial state a caller can hand to a step on the card without a second
    copy there beside the step's buffers."""
    host = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
    return state._replace(params=tree_lib.tree_map(host, state.params),
                          opt=tree_lib.tree_map(host, state.opt))
