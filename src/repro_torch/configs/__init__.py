"""Architecture config registry of the PyTorch port.

Holds the configs ported so far (the dense and ssm families).
``get_config(name)`` returns the published config; ``get_reduced_config``
applies the same reduction rules as ``repro.configs.get_reduced_config``
(few layers, narrow widths, tiny vocab) for CPU tests.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import gemma_2b, mamba2_780m, starcoder2_3b
from repro_torch.configs.base import ModelConfig

_REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (gemma_2b, mamba2_780m, starcoder2_3b)
}

ARCH_NAMES = tuple(sorted(_REGISTRY))


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return _REGISTRY[name]


def get_reduced_config(name: str) -> ModelConfig:
    """Same-family tiny config: narrow dims, tiny vocab.  Attention
    widths shrink for the attention families only; an ssm config keeps
    its zero head fields and shrinks its ``SSMConfig`` instead (the
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
    if cfg.sliding_window:
        kw["sliding_window"] = 32
    return dataclasses.replace(cfg, **kw)


__all__ = ["ModelConfig", "ARCH_NAMES", "get_config", "get_reduced_config"]
