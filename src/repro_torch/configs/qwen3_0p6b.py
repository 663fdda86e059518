"""Qwen3-0.6B dense with qk_norm: 28L d_model=1024 16H (GQA kv=8)
d_ff=3072 vocab=151936, head_dim=128, tied embeddings (port copy of
repro.configs.qwen3_0p6b)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
