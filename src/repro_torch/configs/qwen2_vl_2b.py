"""Qwen2-VL 2B — VLM backbone with M-RoPE and dynamic resolution.

[arXiv:2409.12191; hf]  28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936.  The vision frontend is a stub, as in the reference:
``models.frontends.input_specs`` provides precomputed patch embeddings
and 3D (t, h, w) M-RoPE position ids; tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    activation="swiglu",
    norm_type="rmsnorm",
    pos_embed="mrope",
    mrope_sections=(16, 24, 24),     # head_dim/2 = 64 = 16+24+24
    rope_theta=1000000.0,
    frontend="patch",
    tie_embeddings=True,
)
