"""Tenant setup: compile paper-suite / LM-arch models into ModelPlans.

A copy of ``repro.serving.tenants``.  A *tenant* is a model with a QoS
target; its :class:`ModelPlan` is the compile-time artifact every
scheduling policy works from (per-layer version tables, QoS slices,
``Avg_C``).  Three builders cover the three serving paths:

* :func:`build_paper_plans` — the paper's MLPerf CNN suite (simulator
  and single-engine online runtime);
* :func:`lm_serving_plans` — LM architectures on the TPU-pod hardware
  (analytic pod-scale scenarios);
* :func:`cluster_plan` — LM architectures on any platform (the CPU, the
  TPU pod, or the port's card, ``cost_model.H100_SXM``) with an
  auto-derived feasible QoS, used by ``repro_torch.serving.cluster`` to
  co-locate heterogeneous engines on one unit pool.

They read the port's full-width configs (``repro_torch.configs``) and
layer profiles (``repro_torch.core.profiles``).  The LM builders carry
port names bound to the reference's (``cluster_plans = plans_for_cluster``,
...): the repository's static analyzer resolves the reference's imports of
them by the function names being unique.
"""
from __future__ import annotations

import functools

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.paper_suite import paper_models
from repro_torch.core import cost_model as cm
from repro_torch.core.layer_block import ModelPlan, make_model_plan
from repro_torch.core.multiversion import compile_model
from repro_torch.core.profiles import lm_layers


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


@functools.lru_cache(maxsize=None)
def pod_plan(arch: str, shape_name: str, qos_ms: float) -> ModelPlan:
    """LM tenant on the TPU pod (serving shapes; decode/prefill)."""
    hw = cm.TPU_V5E_POD
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    layers = lm_layers(cfg, shape)
    qos_s = qos_ms * 1e-3
    vsets = compile_model(layers, hw, qos_s)
    return make_model_plan(f"{arch}:{shape_name}", layers, vsets, qos_s, hw)


def pod_serving_plans(specs: list[tuple[str, str, float]],
                      ) -> dict[str, ModelPlan]:
    """specs: [(arch, shape_name, qos_ms)] -> plans keyed arch:shape."""
    return {f"{a}:{s}": pod_plan(a, s, q) for a, s, q in specs}


@functools.lru_cache(maxsize=None)
def plan_for_cluster(arch: str, hw: cm.HardwareSpec = cm.CPU_3990X, *,
                     qos_scale: float = 3.0,
                     shape_name: str = "decode_32k") -> ModelPlan:
    """Analytic ModelPlan for one co-located LM engine tenant, compiled
    for exactly the hardware the cluster will partition (``hw`` is a
    frozen dataclass, so memoization keys on the actual spec).

    Works on any platform and derives a *feasible* QoS instead of taking
    one: the versions are compiled first, then ``qos_s = qos_scale x``
    the model's solo full-machine latency — so heterogeneous models
    (gemma_2b next to mamba2_780m) all get proportionate targets and the
    co-location comparison measures scheduling quality, not QoS
    mis-calibration."""
    cfg = get_config(arch)
    layers = lm_layers(cfg, get_shape(shape_name))
    vsets = compile_model(layers, hw)
    solo = sum(cm.latency(hw, vs.solo_version(), hw.n_units,
                          cm.Interference()) for vs in vsets)
    return make_model_plan(arch, layers, vsets, qos_scale * solo, hw)


def plans_for_cluster(archs: list[str], hw: cm.HardwareSpec, *,
                      qos_scale: float = 3.0) -> dict[str, ModelPlan]:
    """archs -> plans keyed by arch name (repro_torch.serving.cluster
    input)."""
    return {a: plan_for_cluster(a, hw, qos_scale=qos_scale) for a in archs}


def flat_version_sets(plans: dict[str, ModelPlan]) -> list:
    """Flatten a tenant mix's multi-version tables for the online engine:
    ServingEngine picks its tile source (the dominant layer) from these,
    so level switches install versions the adaptive compiler produced."""
    return [vs for plan in plans.values() for vs in plan.version_sets]


lm_plan = pod_plan
lm_serving_plans = pod_serving_plans
cluster_plan = plan_for_cluster
cluster_plans = plans_for_cluster
engine_version_sets = flat_version_sets
