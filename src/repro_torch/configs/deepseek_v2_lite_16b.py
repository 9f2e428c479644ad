"""DeepSeek-V2-Lite — 16B MoE with Multi-head Latent Attention.

[arXiv:2405.04434; hf]  27L d_model=2048 16H d_ff=1408(expert), vocab=102400.
MLA kv_lora_rank=512 (each token caches 512 latent + 64 RoPE-key values);
2 shared + 64 routed experts, top-6, capacity factor 1.25.  Layer 0 uses a
dense FFN (d_ff=10944) like the released checkpoint.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,                 # MLA: latent-shared; kept for bookkeeping
    head_dim=128,                    # v_head_dim
    d_ff=1408,                       # routed-expert intermediate
    vocab_size=102400,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        expert_d_ff=1408,
        num_shared_experts=2,
        shared_d_ff=2816,            # 2 shared experts fused: 2 x 1408
        capacity_factor=1.25,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        q_lora_rank=None,
    ),
    first_dense_layers=1,
    first_dense_d_ff=10944,
    activation="swiglu",
    norm_type="rmsnorm",
    pos_embed="rope",
    rope_theta=10000.0,
)
