"""Shared model machinery (port of ``repro.models.common``, the parts the
dense and MoE blocks run, GQA and MLA): parameter specs and their
initialization, the quantization-dispatched dense layer with its per-step
weight cache, norms, rotary embeddings, the MLP and the experts' SwiGLU.

Weights keep the reference's layout: a projection weight is (K, ...) and is
contracted over its leading dim(s) exactly as ``dense``/``dense_in`` do
there, because ``quantize_weight`` chunks along K. The serving path builds
no weight cache and quantizes every weight per call, as the reference's
does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch import tree as tree_lib
from repro_torch.core import timefloats

Tensor = torch.Tensor
Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple              # logical axis names, len == len(shape)
    init: str = "fan_in"     # fan_in | zeros | ones | embed | normal
    scale: float = 1.0

    def initialize(self, gen: torch.Generator, dtype: torch.dtype,
                   device) -> Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        if self.init in ("embed", "normal"):
            std = self.scale
        elif self.init == "fan_in":
            fan_in = (self.shape[0] if len(self.shape) <= 2
                      else math.prod(self.shape[:-1]))
            std = self.scale / math.sqrt(max(fan_in, 1))
        else:
            raise ValueError(self.init)
        x = torch.randn(self.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (x * std).to(dtype)


def init_params(specs: Tree, gen: torch.Generator, dtype: torch.dtype,
                device) -> Tree:
    """Initialize a nested dict/list tree of ParamSpec, leaves drawn in
    tree order from ``gen`` (a generator on ``device``)."""
    if isinstance(specs, ParamSpec):
        return specs.initialize(gen, dtype, device)
    if isinstance(specs, dict):
        return {k: init_params(v, gen, dtype, device)
                for k, v in specs.items()}
    return [init_params(v, gen, dtype, device) for v in specs]


# ---------------------------------------------------------------------------
# The dense layer — the paper's integration point. Every projection goes
# through here; cfg.quant selects plain vs TimeFloats arithmetic.
#
# Weight cache (DESIGN.md §3): train/step.py quantizes every dense-eligible
# weight once per optimizer step (build_weight_cache, outside autograd) and
# installs the entries for the loss (weight_cache_scope). dense()/dense_in()
# find an entry by the identity of the parameter tensor they are handed; a
# hit routes through timefloats.linear_cached (the stored planes serve the
# forward AND the dx read), a miss through timefloats.linear. The reference
# scans stacked layers and threads a stacked cache through the scan; the
# port loops over per-layer dicts, so one flat table covers every layer.
#
# Preparation mirrors how each consumer reshapes its weight, a per-leaf
# rule:
#   dense    — w.reshape(w.shape[0], -1)   (wq/wk/wv, MLP, lm_head)
#   dense_in — w.reshape(-1, w.shape[-1])  (wo: contract leading dims)
#   expert   — each expert's (d, f) slice under the dense rule, its own
#              prescale (MoE wg/wu/wd; the reference's vmapped
#              prepare_weight), quantized in groups of experts
# plus the tied head, the transposed read of the embedding table, prepared
# from embed.T and keyed on the table. Excluded: <2-D leaves, non-float,
# embeddings/meta tables, the MoE router, conv kernels.
# ---------------------------------------------------------------------------

_EXPERT_LEAVES = ("wg", "wu", "wd")  # MoE expert stacks (E, d, f)/(E, f, d)
_DENSE_IN_LEAVES = ("wo",)           # consumed via dense_in


def _leaf_name(path) -> str:
    """Last string key on a tree path (list indices skipped)."""
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return ""


def leaf_rule_with_reason(path, ndim: int, dtype) -> tuple:
    """(rule, reason) for a leaf consumed at ``ndim`` dims: ``rule`` is
    "dense"/"dense_in"/"expert", or None with the reason the leaf is not
    dense-eligible."""
    if ndim < 2:
        return None, "sub-2D (bias/scale vectors are digital)"
    if not dtype.is_floating_point:
        return None, "non-float"
    name = _leaf_name(path)
    if any(t in name for t in ("embed", "meta")):
        return None, "embedding/meta table (gather-read, not a matmul)"
    if name == "router":
        return None, "f32 MoE router (precision-critical plain matmul)"
    if name.startswith("conv"):
        return None, "depthwise conv kernel (not a dense() operand)"
    if name in _EXPERT_LEAVES and ndim == 3:
        return "expert", ""
    if name in _DENSE_IN_LEAVES:
        return "dense_in", ""
    return "dense", ""


def _leaf_rule(path, ndim: int, dtype) -> Optional[str]:
    return leaf_rule_with_reason(path, ndim, dtype)[0]


def _prepare_by_rule(leaf: Tensor, rule: str, cfg: ModelConfig
                     ) -> timefloats.PreparedOperand:
    """One leaf -> PreparedOperand under its consumer's reshape."""
    if rule == "dense":
        return timefloats.prepare_weight(leaf.reshape(leaf.shape[0], -1),
                                         cfg.tf)
    if rule == "dense_in":
        return timefloats.prepare_weight(leaf.reshape(-1, leaf.shape[-1]),
                                         cfg.tf)
    if rule == "expert":
        return timefloats.prepare_weight_stack(leaf, cfg.tf)
    raise ValueError(rule)


# {id(param): (param, PreparedOperand)}: the stored reference keeps the id
# valid and guards against its reuse.
WeightCache = Dict[int, tuple]

_ACTIVE_WEIGHT_CACHE: Optional[WeightCache] = None


@torch.no_grad()
def build_weight_cache(params: Tree, cfg: ModelConfig
                       ) -> Optional[WeightCache]:
    """Quantize every dense-eligible weight of ``params`` once (per
    optimizer step), keyed by the tensors of ``params`` themselves. None
    when TimeFloats or its cache is off."""
    if cfg.quant != "timefloats" or not cfg.tf.cache:
        return None
    cache: WeightCache = {}
    for path, leaf in tree_lib.leaves_with_path(params):
        rule = _leaf_rule(path, leaf.ndim, leaf.dtype)
        if rule:
            cache[id(leaf)] = (leaf, _prepare_by_rule(leaf, rule, cfg))
    if cfg.tie_embeddings and "embed" in params:
        emb = params["embed"]
        cache[id(emb)] = (emb, timefloats.prepare_weight(emb.T, cfg.tf))
    return cache or None


@contextlib.contextmanager
def weight_cache_scope(cache: Optional[WeightCache]) -> Iterator[None]:
    """Install ``cache`` for dense()/dense_in() inside the block; entries
    merge over an enclosing scope's."""
    global _ACTIVE_WEIGHT_CACHE
    prev = _ACTIVE_WEIGHT_CACHE
    if cache:
        _ACTIVE_WEIGHT_CACHE = {**(prev or {}), **cache}
    try:
        yield
    finally:
        _ACTIVE_WEIGHT_CACHE = prev


def active_weight_cache() -> Optional[WeightCache]:
    """The installed table, for code that must reinstall it later (the
    recomputation of a checkpointed block runs outside the loss's scope)."""
    return _ACTIVE_WEIGHT_CACHE


def cached_weight(w: Tensor) -> Optional[timefloats.PreparedOperand]:
    """The installed entry for parameter ``w`` (by identity), or None.
    Callers consume it under the rule it was built with: dense() looks up
    the leaves it reshapes itself, dense_in() and the tied head look up
    their leaves before reshaping."""
    if _ACTIVE_WEIGHT_CACHE is None:
        return None
    ent = _ACTIVE_WEIGHT_CACHE.get(id(w))
    if ent is None or ent[0] is not w:
        return None
    return ent[1]


def dense(x: Tensor, w: Tensor, cfg: ModelConfig,
          pw: Optional[timefloats.PreparedOperand] = None) -> Tensor:
    """y[..., n] = x[..., k] @ w[k, n]; trailing dims of ``w`` are
    flattened into the output and restored (e.g. (d, H, hd)). ``pw`` is an
    explicit cache entry for callers that reshape ``w`` before this point;
    it must describe ``w.reshape(w.shape[0], -1)``."""
    k = w.shape[0]
    w2 = w.reshape(k, -1)
    out_shape = x.shape[:-1] + w.shape[1:]
    act = cfg.activation_dtype
    if cfg.quant == "timefloats":
        if pw is None:
            pw = cached_weight(w)
        if pw is not None:
            y = timefloats.linear_cached(x, w2, pw, cfg.tf)
        else:
            y = timefloats.linear(x, w2, cfg.tf)
    else:
        y = x.to(act) @ w2.to(act)
    return y.reshape(out_shape).to(act)


def dense_in(x: Tensor, w: Tensor, cfg: ModelConfig) -> Tensor:
    """Contraction over multiple leading dims of w (e.g. wo: (H, hd, d)).
    x (..., H, hd) @ w (H, hd, d) -> (..., d). The cache is consulted on
    the original leaf, before the reshape."""
    n_in = w.ndim - 1
    k = math.prod(w.shape[:n_in])
    x2 = x.reshape(*x.shape[: x.ndim - n_in], k)
    pw = cached_weight(w) if cfg.quant == "timefloats" else None
    return dense(x2, w.reshape(k, w.shape[-1]), cfg, pw=pw)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_specs(cfg: ModelConfig, d: int | None = None) -> Dict[str, ParamSpec]:
    d = d or cfg.d_model
    specs = {"scale": ParamSpec((d,), ("embed",), init="ones")}
    if cfg.norm_variant == "layernorm":
        specs["bias"] = ParamSpec((d,), ("embed",), init="zeros")
    return specs


def norm_apply(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig
               ) -> Tensor:
    xf = x.to(torch.float32)
    if cfg.norm_variant == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        y = y * params["scale"] + params["bias"]
    else:
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * params["scale"]
    return y.to(cfg.activation_dtype)


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S)."""
    d = x.shape[-1]
    idx = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / (theta ** idx)
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: int | None = None
              ) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_variant in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec((d, f), ("embed", "ffw")),
            "w_up": ParamSpec((d, f), ("embed", "ffw")),
            "w_down": ParamSpec((f, d), ("ffw", "embed")),
        }
    if cfg.mlp_variant == "gelu":
        return {
            "w_up": ParamSpec((d, f), ("embed", "ffw")),
            "w_down": ParamSpec((f, d), ("ffw", "embed")),
        }
    raise ValueError(cfg.mlp_variant)


def _gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def _silu(x: Tensor) -> Tensor:
    """``x * (1 / (1 + exp(-x)))`` op by op, as ``jax.nn.silu`` lowers: in
    bf16 each op rounds, so ``F.silu``'s single rounding would differ from
    the reference (tests/test_torch_train.py pins the bf16 MLP bitwise)."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp_apply(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig
              ) -> Tensor:
    if cfg.mlp_variant in ("swiglu", "geglu"):
        act = _silu if cfg.mlp_variant == "swiglu" else _gelu
        g = act(dense(x, params["w_gate"], cfg))
        u = dense(x, params["w_up"], cfg)
        return dense(g * u, params["w_down"], cfg)
    u = _gelu(dense(x, params["w_up"], cfg))
    return dense(u, params["w_down"], cfg)


def expert_dense(x: Tensor, w: Tensor, cfg: ModelConfig,
                 pw: Optional[timefloats.PreparedOperand] = None) -> Tensor:
    """The reference's ``dense`` vmapped over experts: x (E, C, K) @ w (E,
    K, N) -> (E, C, N) in the activation dtype, expert e exactly
    ``dense(x[e], w[e])``. ``pw`` is the stack's cache entry, looked up on
    the (E, K, N) leaf by the caller."""
    act = cfg.activation_dtype
    if cfg.quant == "timefloats":
        y = timefloats.expert_linear(x, w, pw, cfg.tf)
    else:
        y = x.to(act) @ w.to(act)
    return y.to(act)


def expert_mlp_apply(wg: Tensor, wu: Tensor, wd: Tensor, x: Tensor,
                     cfg: ModelConfig, pws=None) -> Tensor:
    """SwiGLU on explicit weights: the routed experts' (E, d, f) stacks on
    an (E, C, d) dispatch buffer (the reference vmaps it over E), or the
    shared expert's 2-D weights on (T, d) tokens. ``pws`` is an optional
    (pwg, pwu, pwd) triple of cache entries for the stacks."""
    pg, pu, pd = pws if pws is not None else (None, None, None)
    proj = expert_dense if wg.ndim == 3 else dense
    g = _silu(proj(x, wg, cfg, pw=pg))
    u = proj(x, wu, cfg, pw=pu)
    return proj(g * u, wd, cfg, pw=pd)
