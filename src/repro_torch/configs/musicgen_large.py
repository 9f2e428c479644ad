"""MusicGen-Large — decoder-only LM over EnCodec audio tokens.

[arXiv:2306.05284; hf]  48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048.  The EnCodec frontend is a stub, as in the reference:
``models.frontends.input_specs`` provides precomputed frame embeddings
(the sum of codebook embeddings after the delay pattern).  A standard
(non-gated) transformer: gelu MLP with biases, layernorm, sinusoidal
positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    activation="gelu",
    norm_type="layernorm",
    pos_embed="sinusoidal",
    frontend="frames",
)
