"""Snowflake Arctic (base) — 480B MoE: 128 experts top-2 + dense residual.

[hf:Snowflake/snowflake-arctic-base; hf]  35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000.  Arctic's signature is the *dense-MoE hybrid*: every
layer runs a small dense FFN residually in parallel with the 128-expert MoE.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,                      # dense residual branch width
    vocab_size=32000,
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        expert_d_ff=4864,
        dense_residual=True,
        capacity_factor=1.25,
    ),
    activation="swiglu",
    norm_type="rmsnorm",
    pos_embed="rope",
    rope_theta=10000.0,
)
