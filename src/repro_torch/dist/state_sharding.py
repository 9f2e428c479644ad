"""Optimizer-state ParamSpecs, for dry-run sharding without allocation
(``repro.dist.state_sharding``).

Mirrors ``training.optimizer.init_opt_state`` structurally: every state
tensor inherits its parameter's logical axes, so FSDP/TP rules apply
transparently.  Adafactor's factored statistics drop the reduced axis
(vr drops the last, vc the second-to-last)."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.params import ParamSpec, tree_map_with_path
from repro_torch.training.optimizer import OptimizerConfig, is_factored

PyTree = Any


def _fp32_like(spec: ParamSpec) -> ParamSpec:
    return ParamSpec(spec.shape, torch.float32, spec.axes, init="zeros")


def _each(specs: PyTree, fn) -> PyTree:
    return tree_map_with_path(lambda _, s: fn(s), specs)


def optimizer_state_specs(cfg: OptimizerConfig, param_specs: PyTree) -> dict:
    """ParamSpec tree matching ``init_opt_state(cfg, params)``."""
    master = _each(param_specs, _fp32_like)
    if cfg.name == "adafactor":
        def stat(sp: ParamSpec):
            if is_factored(sp.shape, cfg.min_dim_factored):
                return {
                    "vr": ParamSpec(sp.shape[:-1], torch.float32,
                                    sp.axes[:-1], init="zeros"),
                    "vc": ParamSpec(sp.shape[:-2] + sp.shape[-1:],
                                    torch.float32,
                                    sp.axes[:-2] + sp.axes[-1:],
                                    init="zeros"),
                }
            return {"v": _fp32_like(sp)}
        return {"stats": _each(param_specs, stat), "master": master}
    return {"mu": _each(param_specs, _fp32_like),
            "nu": _each(param_specs, _fp32_like), "master": master}


def full_state_specs(cfg: OptimizerConfig, param_specs: PyTree) -> dict:
    """ParamSpec tree matching ``init_train_state`` (sans error-feedback:
    the dry-run never traces int8 gradient compression)."""
    return {
        "opt": optimizer_state_specs(cfg, param_specs),
        "step": ParamSpec((), torch.int32, (), init="zeros"),
    }


# the reference's names, bound without a second ``def`` (see
# ``dist.sharding``)
opt_state_specs = optimizer_state_specs
train_state_specs = full_state_specs
