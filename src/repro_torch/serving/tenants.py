"""Tenant setup: compile the paper's MLPerf CNN suite into ModelPlans.

A copy of the part of ``repro.serving.tenants`` the single-engine online
runtime and the simulator use (``paper_plan``, ``build_paper_plans``).  A
*tenant* is a model with a QoS target; its :class:`ModelPlan` is the
compile-time artifact every scheduling policy works from (per-layer
version tables, QoS slices, ``Avg_C``).
"""
from __future__ import annotations

import functools

from repro_torch.configs.paper_suite import paper_models
from repro_torch.core import cost_model as cm
from repro_torch.core.layer_block import ModelPlan, make_model_plan
from repro_torch.core.multiversion import compile_model


@functools.lru_cache(maxsize=None)
def paper_plan(name: str, hw_name: str = "cpu") -> ModelPlan:
    hw = cm.CPU_3990X if hw_name == "cpu" else cm.TPU_V5E_POD
    pm = paper_models()[name]
    layers = list(pm.layers)
    qos_s = pm.qos_ms * 1e-3
    vsets = compile_model(layers, hw, qos_s)
    return make_model_plan(name, layers, vsets, qos_s, hw)


def build_paper_plans(names, hw: cm.HardwareSpec) -> dict[str, ModelPlan]:
    key = "cpu" if hw.cache_shared else "tpu"
    return {n: paper_plan(n, key) for n in names}
