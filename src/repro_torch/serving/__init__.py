"""serving layer of the PyTorch port (see the package docstring).

``repro_torch.serving.cluster`` runs N co-located engines of different
models over one unit pool (``ClusterRuntime``); ``tenants`` compiles
their plans (``cluster_plans``).  The other entry points are imported
from their modules (``engine``, ``runtime``, ``simulator``, ``slo``).
"""
from repro_torch.serving.cluster import (ClusterMetrics, ClusterRuntime,
                                         EngineTenant, build_cluster)
from repro_torch.serving.tenants import (build_paper_plans, cluster_plan,
                                         cluster_plans, engine_version_sets,
                                         lm_serving_plans)

__all__ = [
    "ClusterMetrics", "ClusterRuntime", "EngineTenant", "build_cluster",
    "build_paper_plans", "cluster_plan", "cluster_plans",
    "engine_version_sets", "lm_serving_plans",
]
