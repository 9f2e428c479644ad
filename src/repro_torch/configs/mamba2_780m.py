"""Mamba-2 780M — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060; unverified]  48L d_model=1536 (attn-free) vocab=50280,
ssm_state=128.  d_inner = 2*d_model = 3072, head_dim 64 => 48 SSD heads.
Sub-quadratic: decode state is (heads, head_dim, state) per layer.  The
chunked SSD scan runs through the hand-written CUDA kernel
(repro_torch.kernels.ssd_scan).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(
        d_inner=3072,
        head_dim=64,
        state_dim=128,
        num_groups=1,
        conv_width=4,
        chunk_size=256,
    ),
    norm_type="rmsnorm",
    pos_embed="none",
    tie_embeddings=True,
)
