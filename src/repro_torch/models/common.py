"""Shared model machinery (port of ``repro.models.common``, the parts the
dense serving path runs): parameter specs and their initialization, the
quantization-dispatched dense layer, norms, rotary embeddings and the MLP.

Weights keep the reference's layout: a projection weight is (K, ...) and is
contracted over its leading dim(s) exactly as ``dense``/``dense_in`` do
there, because ``quantize_weight`` chunks along K. There is no weight cache:
the reference's serving path quantizes every weight per call too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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
# ---------------------------------------------------------------------------


def dense(x: Tensor, w: Tensor, cfg: ModelConfig) -> Tensor:
    """y[..., n] = x[..., k] @ w[k, n]; trailing dims of ``w`` are
    flattened into the output and restored (e.g. (d, H, hd))."""
    k = w.shape[0]
    w2 = w.reshape(k, -1)
    out_shape = x.shape[:-1] + w.shape[1:]
    act = cfg.activation_dtype
    if cfg.quant == "timefloats":
        y = timefloats.linear(x, w2, cfg.tf)
    else:
        y = x.to(act) @ w2.to(act)
    return y.reshape(out_shape).to(act)


def dense_in(x: Tensor, w: Tensor, cfg: ModelConfig) -> Tensor:
    """Contraction over multiple leading dims of w (e.g. wo: (H, hd, d)).
    x (..., H, hd) @ w (H, hd, d) -> (..., d)."""
    n_in = w.ndim - 1
    k = math.prod(w.shape[:n_in])
    x2 = x.reshape(*x.shape[: x.ndim - n_in], k)
    return dense(x2, w.reshape(k, w.shape[-1]), cfg)


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


def mlp_apply(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig
              ) -> Tensor:
    if cfg.mlp_variant in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_variant == "swiglu" else _gelu
        g = act(dense(x, params["w_gate"], cfg))
        u = dense(x, params["w_up"], cfg)
        return dense(g * u, params["w_down"], cfg)
    u = _gelu(dense(x, params["w_up"], cfg))
    return dense(u, params["w_down"], cfg)
