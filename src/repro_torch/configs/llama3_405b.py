"""Llama-3 405B — dense GQA LM, 128k vocab.

[arXiv:2407.21783; unverified]  126L d_model=16384 128H (GQA kv=8)
d_ff=53248 vocab=128256, rope theta 500000.  One layer is 3.19 B
parameters (6.375 GB in bf16), so one H100 holds a few of its 126 layers.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    activation="swiglu",
    norm_type="rmsnorm",
    pos_embed="rope",
    rope_theta=500000.0,
)
