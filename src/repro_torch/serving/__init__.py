"""serving layer of the PyTorch port (see the package docstring): the
reference's exports (``repro.serving``), under the same names.

* ``simulator`` — discrete-event simulator (analytical latencies, real
  scheduling decisions);
* ``runtime`` — one shared engine on the card with the policy's
  proxy-driven level in the loop (``OnlineRuntime``);
* ``cluster`` — N co-located engines of different models over one unit
  pool, a CUDA stream each (``ClusterRuntime``); ``tenants`` compiles
  their plans (``cluster_plans``).
"""
from repro_torch.serving.simulator import SimConfig, Simulator, run_sweep
from repro_torch.serving.request import (diurnal_workload,
                                         gamma_poisson_workload,
                                         poisson_workload,
                                         qos_inverse_weights, synth_prompts,
                                         uniform_workload)
from repro_torch.serving.runtime import (OnlineRuntime, Workload,
                                         plan_demand,
                                         replay_through_simulator)
from repro_torch.serving.slo import (AdmissionController, DeadlineBook,
                                     SloEntry, pick_quantum)
from repro_torch.serving.cluster import (ClusterMetrics, ClusterRuntime,
                                         EngineTenant, build_cluster)
from repro_torch.serving.tenants import (build_paper_plans, cluster_plan,
                                         cluster_plans, engine_version_sets,
                                         lm_serving_plans)
from repro_torch.serving.engine import (PREFILL_CHUNK_LEN, QUANTUM_BUCKETS,
                                        PrefillQuantum, QuantumHandle,
                                        ServingEngine)
from repro_torch.serving.paging import TRASH_PAGE, PagePool
from repro_torch.serving.version_cache import (VersionCache, VersionEntry,
                                               tiles_key)
from repro_torch.core.counters import CounterBank, QuantumObservation

__all__ = [
    "SimConfig", "Simulator", "run_sweep", "poisson_workload",
    "gamma_poisson_workload", "diurnal_workload",
    "qos_inverse_weights", "uniform_workload", "synth_prompts",
    "OnlineRuntime", "Workload", "plan_demand", "replay_through_simulator",
    "AdmissionController", "DeadlineBook", "SloEntry", "pick_quantum",
    "ClusterMetrics", "ClusterRuntime", "EngineTenant", "build_cluster",
    "build_paper_plans", "cluster_plan", "cluster_plans",
    "engine_version_sets", "lm_serving_plans",
    "PREFILL_CHUNK_LEN", "QUANTUM_BUCKETS", "PrefillQuantum",
    "QuantumHandle", "ServingEngine",
    "TRASH_PAGE", "PagePool",
    "VersionCache", "VersionEntry", "tiles_key",
    "CounterBank", "QuantumObservation",
]
