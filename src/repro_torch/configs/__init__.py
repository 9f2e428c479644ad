"""Architecture config registry of the PyTorch port.

Holds every config of the reference's registry: the dense, ssm, hybrid
and moe families, and the two frontend configs (qwen2-vl-2b, ``vlm``;
musicgen-large, ``audio``), whose backbones run as dense blocks.
``get_config(name)`` returns the published config; ``get_reduced_config``
applies the same reduction rules as ``repro.configs.get_reduced_config``
(few layers, narrow widths, tiny vocab) for CPU tests; ``get_shape(name)``
returns an assigned input-shape cell (the co-location plans compile
against ``decode_32k``).

``get_shape`` and ``all_cells`` are the functions :func:`shape_config`
and :func:`assigned_cells` under the reference's names: the
repository's static analyzer resolves the reference's ``from
repro.configs import get_shape`` by that function name being unique.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import arctic_480b, deepseek_v2_lite_16b, \
    gemma_2b, llama3_405b, mamba2_780m, minicpm_2b, musicgen_large, \
    qwen2_vl_2b, recurrentgemma_2b, starcoder2_3b
from repro_torch.configs.base import SHAPES, MLAConfig, ModelConfig, \
    MoEConfig, ShapeConfig, shape_applicable

_REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (arctic_480b, deepseek_v2_lite_16b, gemma_2b, llama3_405b,
              mamba2_780m, minicpm_2b, musicgen_large, qwen2_vl_2b,
              recurrentgemma_2b, starcoder2_3b)
}

ARCH_NAMES = tuple(sorted(_REGISTRY))


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return _REGISTRY[name]


def shape_config(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {tuple(SHAPES)}")
    return SHAPES[name]


get_shape = shape_config


def assigned_cells(include_skipped: bool = False):
    """Yield (arch, shape, runnable, reason) for all 40 assigned cells."""
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            ok, reason = shape_applicable(cfg, shape)
            if ok or include_skipped:
                yield arch, sname, ok, reason


all_cells = assigned_cells


def get_reduced_config(name: str) -> ModelConfig:
    """Same-family tiny config: narrow dims, tiny vocab.  Attention
    widths shrink for the attention families only; an ssm config keeps
    its zero head fields and shrinks its ``SSMConfig`` instead, a hybrid
    shrinks its ``RGLRUConfig`` to one (rec, rec, attn) group, an MoE
    config keeps 4 experts (top-2) and narrow MLA widths, and an M-RoPE
    config splits its 16 frequency pairs (4, 6, 6) (the reference
    registry's rules)."""
    cfg = get_config(name)
    kw: dict = dict(
        name=cfg.name + "-reduced",
        num_layers=min(cfg.num_layers, 3),
        d_model=128,
        vocab_size=256,
    )
    if cfg.family != "ssm":
        kw.update(num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2) or 1,
                  head_dim=32, d_ff=256)
    if cfg.pos_embed == "mrope":
        kw["mrope_sections"] = (4, 6, 6)   # half of reduced head_dim = 16
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
            expert_d_ff=64,
            shared_d_ff=64 if cfg.moe.num_shared_experts else 0)
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=32, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32)
        kw["head_dim"] = 32
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_inner=256, head_dim=32, state_dim=16, chunk_size=16)
    if cfg.rglru is not None:
        kw["rglru"] = dataclasses.replace(
            cfg.rglru, lru_width=128, window_size=32, scan_chunk=16)
        kw["num_layers"] = 3   # one (rec, rec, attn) group
    if cfg.first_dense_layers:
        kw["first_dense_d_ff"] = 128
    if cfg.sliding_window:
        kw["sliding_window"] = 32
    return dataclasses.replace(cfg, **kw)


__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "ShapeConfig", "SHAPES",
           "ARCH_NAMES", "get_config", "get_reduced_config", "get_shape",
           "all_cells"]
