"""Kimi K2, trillion-parameter MoE (384 routed experts, top-8, one shared):
61L d_model=7168 64H (GQA kv=8) head_dim 112 d_ff=2048 vocab=163840 (port
copy of repro.configs.kimi_k2_1t_a32b).

One leading dense layer of width 11264, then MoE layers with a 2048-wide
shared expert; GQA attention, not MLA.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163840,
    moe=MoEConfig(
        num_experts=384,
        top_k=8,
        d_expert=2048,
        num_shared=1,
        shared_d_ff=2048,
        first_k_dense=1,
        dense_d_ff=11264,
        capacity_factor=1.25,
    ),
)
