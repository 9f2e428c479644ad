"""Unified model/run configuration (PyTorch port: a copy of
``repro.configs.base`` whose ``cache_dtype`` is a torch dtype).

One ``ModelConfig`` dataclass covers all 10 assigned architecture families
(dense / MoE / MLA / SSM / RG-LRU hybrid / VLM / audio).  Family-specific
sub-configs are ``None`` when unused.  ``ShapeConfig`` encodes the assigned
input-shape cells (train_4k / prefill_32k / decode_32k / long_500k).
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # arctic: dense FFN residual branch running in parallel with the MoE branch
    dense_residual: bool = False
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int | None = None   # v2-lite: no q compression
    # decode-time matrix absorption (W_uk folded into q, W_uv into W_o).
    # Beyond-paper optimization; see EXPERIMENTS.md §Perf.
    absorb: bool = False


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block config."""
    d_inner: int = 3072
    head_dim: int = 64           # SSD head dim (P)
    state_dim: int = 128         # N
    num_groups: int = 1          # B/C groups
    conv_width: int = 4
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma recurrent-block config."""
    lru_width: int = 2560
    conv_width: int = 4
    block_pattern: tuple[str, ...] = ("rec", "rec", "attn")  # repeating
    window_size: int = 2048      # local attention window
    scan_chunk: int = 256        # chunked linear-scan granularity


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None

    activation: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm_type: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    pos_embed: Literal["rope", "mrope", "sinusoidal", "none"] = "rope"
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # t/h/w pairs (qwen2-vl)
    sliding_window: int | None = None    # starcoder2 uses 4096
    tie_embeddings: bool = False
    embed_scale: bool = False            # gemma: x *= sqrt(d_model)
    logit_softcap: float | None = None
    # deepseek-v2: first k layers use a dense FFN instead of MoE
    first_dense_layers: int = 0
    first_dense_d_ff: int = 0
    # modality frontend stub: model consumes precomputed embeddings
    frontend: Literal["none", "patch", "frames"] = "none"
    dtype: str = "bfloat16"

    # -- derived -----------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True when decode state is O(1)/O(window) in sequence length."""
        return self.family in ("ssm", "hybrid")

    def cache_dtype(self):
        import torch
        return torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: Literal["train", "prefill", "decode"]
    # training only
    microbatch: int | None = None       # grad-accum microbatch (global); None = no accum
    remat: Literal["none", "full", "dots"] = "full"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256, mode="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, mode="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128, mode="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1, mode="decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch x shape) cell is runnable; reason if not.

    long_500k needs sub-quadratic attention (DESIGN.md §4): only SSM/hybrid
    archs keep O(1)/O(window) decode state at 524k context.
    """
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, ("full-attention arch: 524k-token dense KV decode is "
                       "skipped per assignment (sub-quadratic archs only)")
    return True, ""
