"""Model / run configuration schema (port copy of ``repro.configs.base``).

One frozen ``ModelConfig`` describes an architecture; the field names and
defaults are the reference's, so a configuration maps one to one. The dtype
fields stay strings and resolve to ``torch.dtype`` through properties.
``quant="timefloats"`` routes every projection through TimeFloats
arithmetic (core.timefloats.linear).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

import torch

from repro_torch.core.timefloats import TFConfig


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    router_z_coef: float = 1e-4
    ep_mode: str = "auto"
    dispatch_chunk: int = 0
    shared_d_ff: int = 0
    dense_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Hymba-style parallel attention+SSM heads."""

    meta_tokens: int = 128
    sliding_window: int = 1024
    global_layers: Tuple[int, ...] = ()


Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // n_heads
    head_pad_to: int = 0                # 0 = no padding; else pad H up to it
    mlp_variant: Literal["swiglu", "gelu", "geglu", "none"] = "swiglu"
    norm_variant: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    pos_variant: Literal["rope", "sinusoidal", "none"] = "rope"
    rope_theta: float = 10000.0
    qk_norm: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    num_codebooks: int = 1
    num_prefix_tokens: int = 0
    prefix_bidirectional: bool = False
    quant: Literal["none", "timefloats"] = "timefloats"
    tf: TFConfig = TFConfig(mode="separable")
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: Literal["none", "full", "dots"] = "full"
    q_block: int = 1024
    kv_block: int = 1024
    sliding_window: Optional[int] = None

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        assert self.n_heads > 0
        return self.d_model // self.n_heads

    @property
    def padded_heads(self) -> int:
        """Computational head count (kv-group-aligned padding; see
        head_pad_to). Always a multiple of n_kv_heads."""
        if not self.head_pad_to or self.head_pad_to <= self.n_heads:
            return self.n_heads
        hkv = max(self.n_kv_heads, 1)
        g = -(-self.head_pad_to // hkv)
        return hkv * g

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer structural kind."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                kinds.append("ssm")
            elif self.family == "hybrid":
                glob = self.hybrid and i in self.hybrid.global_layers
                kinds.append("hybrid_global" if glob else "hybrid_swa")
            elif self.family == "moe":
                assert self.moe is not None
                kinds.append("dense" if i < self.moe.first_k_dense else "moe")
            else:
                kinds.append("dense")
        return tuple(kinds)


def reduced_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU tests: few layers, small width,
    few experts, tiny vocab — structure preserved."""
    changes: dict = dict(
        n_layers=min(cfg.n_layers, 2 + (cfg.moe.first_k_dense if cfg.moe else 0)),
        d_model=128,
        n_heads=max(min(cfg.n_heads, 4), 0),
        n_kv_heads=max(min(cfg.n_kv_heads, 2), 0),
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=32 if cfg.n_heads else 0,
        q_block=64,
        kv_block=64,
        remat="none",
    )
    if cfg.moe:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, d_expert=64,
            shared_d_ff=64 if cfg.moe.shared_d_ff else 0,
            first_k_dense=min(cfg.moe.first_k_dense, 1))
    if cfg.mla:
        changes["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                   qk_nope_head_dim=32, qk_rope_head_dim=16,
                                   v_head_dim=32)
    if cfg.ssm:
        changes["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                             chunk=32)
    if cfg.hybrid:
        changes["hybrid"] = dataclasses.replace(
            cfg.hybrid, meta_tokens=8, sliding_window=32,
            global_layers=(0,))
    if cfg.num_prefix_tokens:
        changes["num_prefix_tokens"] = 8
    return dataclasses.replace(cfg, **changes)
