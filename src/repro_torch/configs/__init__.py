"""Architecture config registry of the PyTorch port.

Holds the configs ported so far (the dense, ssm and hybrid families).
``get_config(name)`` returns the published config; ``get_reduced_config``
applies the same reduction rules as ``repro.configs.get_reduced_config``
(few layers, narrow widths, tiny vocab) for CPU tests; ``get_shape(name)``
returns an assigned input-shape cell (the co-location plans compile
against ``decode_32k``).

``get_shape`` is the function :func:`shape_config` under the reference's
name: the repository's static analyzer resolves the reference's ``from
repro.configs import get_shape`` by that function name being unique.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import gemma_2b, mamba2_780m, \
    recurrentgemma_2b, starcoder2_3b
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (gemma_2b, mamba2_780m, recurrentgemma_2b, starcoder2_3b)
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


def get_reduced_config(name: str) -> ModelConfig:
    """Same-family tiny config: narrow dims, tiny vocab.  Attention
    widths shrink for the attention families only; an ssm config keeps
    its zero head fields and shrinks its ``SSMConfig`` instead, and a
    hybrid shrinks its ``RGLRUConfig`` to one (rec, rec, attn) group (the
    reference registry's rules)."""
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
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_inner=256, head_dim=32, state_dim=16, chunk_size=16)
    if cfg.rglru is not None:
        kw["rglru"] = dataclasses.replace(
            cfg.rglru, lru_width=128, window_size=32, scan_chunk=16)
        kw["num_layers"] = 3   # one (rec, rec, attn) group
    if cfg.sliding_window:
        kw["sliding_window"] = 32
    return dataclasses.replace(cfg, **kw)


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCH_NAMES", "get_config",
           "get_reduced_config", "get_shape"]
