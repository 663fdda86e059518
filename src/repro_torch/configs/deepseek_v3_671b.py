"""DeepSeek-V3 671B, MLA + MoE (1 shared + 256 routed experts, top-8):
61L d_model=7168 128H d_ff=2048 vocab=129280 (port copy of
repro.configs.deepseek_v3_671b).

MLA dims: q_lora 1536, kv_lora 512, nope 128, rope 64, v 128. The first 3
layers are dense, of width 18432; the rest are MoE layers (models/moe.py).
The card runs it cut in depth: ``n_layers=3`` (the dense layers) or
``n_layers=4, param_dtype="bfloat16"`` (with the first MoE layer).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=2048,
    vocab_size=129280,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_expert=2048,
        num_shared=1,
        shared_d_ff=2048,
        first_k_dense=3,
        dense_d_ff=18432,
        capacity_factor=1.25,
    ),
)
