"""GEMM-reduced per-layer profiles of the LM architectures (a copy of
``repro.core.profiles`` for the families the port serves).

This is the bridge between the model substrate and the VELTAIR core: a
transformer block's GEMMs are aggregated into one effective GEMM (exact
FLOPs, representative dims), giving the scheduler/compiler the per-layer
workload profile it needs.

For MoE layers only the *active* expert FLOPs count (top-k + shared +
dense-residual); comm_bytes_per_unit carries the TP all-reduce payload
(activation bytes) for the cost model's collective term.

The functions carry port names and are bound to the reference's names
(``lm_layers = block_layers``, ...): the repository's static analyzer
resolves the reference's ``from repro.core.profiles import lm_layers`` by
the function name being unique.  The block decomposition comes from the
port's own ``plan_layers`` (``repro_torch.models.model``).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.cost_model import GemmLayer

IT = 2  # bf16 (the reference's itemsize, on either platform)


def layer_cost(cfg: ModelConfig, tokens: int, kv_len: int,
                 kind: str) -> tuple[float, float]:
    """-> (flops, weight_bytes) for one layer of ``kind``."""
    m = cfg.d_model
    fl = 0.0
    wb = 0.0
    if kind in ("dense", "moe_arctic", "attn_local"):
        h, k, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        qkvo = m * h * d * 2 + m * k * d * 2 * 2 + h * d * m * 2
        fl += tokens * qkvo
        wb += (m * h * d + 2 * m * k * d + h * d * m) * IT
        att_len = kv_len
        if kind == "attn_local" and cfg.rglru:
            att_len = min(kv_len, cfg.rglru.window_size)
        elif cfg.sliding_window:
            att_len = min(kv_len, cfg.sliding_window)
        fl += 2 * 2 * tokens * att_len * h * d       # qk^T + pv
    if kind in ("dense", "attn_local"):
        n_mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
        fl += tokens * n_mats * m * cfg.d_ff * 2
        wb += n_mats * m * cfg.d_ff * IT
    if kind == "moe_arctic":
        moe = cfg.moe
        fl += tokens * 3 * m * cfg.d_ff * 2                       # dense res
        fl += tokens * moe.top_k * 3 * m * moe.expert_d_ff * 2    # routed
        fl += tokens * m * moe.num_experts * 2                    # router
        wb += 3 * m * cfg.d_ff * IT
        wb += moe.num_experts * 3 * m * moe.expert_d_ff * IT
    if kind == "moe_ds":
        mla, moe = cfg.mla, cfg.moe
        h = cfg.num_heads
        dn, dr, dv = (mla.qk_nope_head_dim, mla.qk_rope_head_dim,
                      mla.v_head_dim)
        r = mla.kv_lora_rank
        proj = m * h * (dn + dr) + m * (r + dr) + r * h * (dn + dv) \
            + h * dv * m
        fl += tokens * proj * 2
        wb += proj * IT
        fl += 2 * 2 * tokens * kv_len * h * (dn + dr + dv) / 2
        fl += tokens * moe.top_k * 3 * m * moe.expert_d_ff * 2
        fl += tokens * 3 * m * moe.shared_d_ff * 2
        fl += tokens * m * moe.num_experts * 2
        wb += moe.num_experts * 3 * m * moe.expert_d_ff * IT
    if kind == "ssm":
        s = cfg.ssm
        d_in = 2 * s.d_inner + 2 * s.num_groups * s.state_dim + s.num_heads
        fl += tokens * m * d_in * 2 + tokens * s.d_inner * m * 2
        wb += (m * d_in + s.d_inner * m) * IT
        # SSD: intra-chunk (Q per token) + state updates
        q = s.chunk_size
        fl += tokens * s.num_heads * (2 * q * s.state_dim
                                      + 2 * q * s.head_dim
                                      + 4 * s.head_dim * s.state_dim)
    if kind == "rec":
        rg = cfg.rglru
        w = rg.lru_width
        bw_ = w // max(cfg.num_heads, 1)
        fl += tokens * (2 * m * w * 2 + 2 * w * bw_ * 2 + w * m * 2 + 8 * w)
        wb += (2 * m * w + w * m + 2 * w * bw_ * max(cfg.num_heads, 1)) * IT
        n_mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
        fl += tokens * n_mats * m * cfg.d_ff * 2
        wb += n_mats * m * cfg.d_ff * IT
    return fl, wb


def block_kinds(cfg: ModelConfig) -> list[str]:
    from repro_torch.models.model import plan_layers
    plan = plan_layers(cfg)
    kinds = list(plan.prologue)
    for _ in range(plan.n_groups):
        kinds.extend(plan.scan_kinds)
    kinds.extend(plan.epilogue)
    # normalize block kinds to profile kinds
    return ["dense" if k == "ds_dense0" else k for k in kinds]


def block_layers(cfg: ModelConfig, shape: ShapeConfig) -> list[GemmLayer]:
    """One effective GEMM per transformer block for (arch x shape)."""
    if shape.mode == "decode":
        tokens = shape.global_batch
        kv_len = shape.seq_len
    else:
        tokens = shape.global_batch * shape.seq_len
        kv_len = shape.seq_len
    out = []
    for i, kind in enumerate(block_kinds(cfg)):
        fl, wb = layer_cost(cfg, tokens, kv_len, kind)
        k_eff = cfg.d_model
        m_eff = max(tokens, 1)
        n_eff = max(int(fl / (2 * m_eff * k_eff)), 1)
        # TP all-reduce payload: one activation tensor per sharded matmul
        comm = 2 * tokens * cfg.d_model * IT
        out.append(GemmLayer(name=f"{cfg.name}.L{i}.{kind}", m=m_eff,
                             k=k_eff, n=n_eff, itemsize=IT, weight_bytes=wb,
                             comm_bytes_per_unit=float(comm)))
    return out


def step_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Active-parameter step FLOPs (MODEL_FLOPS for the roofline ratio)."""
    return sum(l.flops for l in block_layers(cfg, shape)) + \
        2 * (shape.global_batch if shape.mode == "decode"
             else shape.global_batch * shape.seq_len) \
        * cfg.d_model * cfg.vocab_size


_layer_flops = layer_cost
lm_layer_kinds = block_kinds
lm_layers = block_layers
model_flops = step_flops
