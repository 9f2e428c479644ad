"""MiniCPM-2B — llama-like dense LM trained with the WSD schedule.

[arXiv:2404.06395; hf]  40L d_model=2304 36H (MHA kv=36) d_ff=5760
vocab=122753.  Tied embeddings; the vocab is odd, so a bf16 logits row
(122,753 values) is not 16-byte aligned.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    activation="swiglu",
    norm_type="rmsnorm",
    pos_embed="rope",
    rope_theta=10000.0,
    tie_embeddings=True,
)
