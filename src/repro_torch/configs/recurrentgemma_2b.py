"""RecurrentGemma-2B — RG-LRU + local attention hybrid (Griffin), 1:2 ratio.

[arXiv:2402.19427; hf]  26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000.  Block pattern (rec, rec, attn) x 8 + 2 trailing recurrent
layers.  Sub-quadratic: decode state is the RG-LRU hidden + a 2048-token
local-attention window (a ring of bf16 keys and values per attention
layer), whatever the sequence length.
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    rglru=RGLRUConfig(
        lru_width=2560,
        conv_width=4,
        block_pattern=("rec", "rec", "attn"),
        window_size=2048,
        scan_chunk=256,
    ),
    activation="geglu",
    norm_type="rmsnorm",
    pos_embed="rope",
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=True,
)
