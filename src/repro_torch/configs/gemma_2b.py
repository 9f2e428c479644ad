"""Gemma-2B — dense LM with GeGLU, head_dim=256, MQA (kv=1).

[arXiv:2403.08295; hf]  18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000.  Embeddings are tied and scaled by sqrt(d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    norm_type="rmsnorm",
    pos_embed="rope",
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=True,
)
