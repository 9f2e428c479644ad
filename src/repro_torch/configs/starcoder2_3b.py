"""StarCoder2-3B — dense code LM, GQA + RoPE, sliding window 4096.

[arXiv:2402.19173; hf]  30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152.  Non-gated gelu MLP with LayerNorm (starcoder2 style).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    activation="gelu",
    norm_type="layernorm",
    pos_embed="rope",
    rope_theta=999999.4,
    sliding_window=4096,
    tie_embeddings=True,
)
