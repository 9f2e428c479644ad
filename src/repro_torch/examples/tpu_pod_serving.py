"""TPU-pod multi-tenant serving: the paper's technique on the reference's
target hardware model.

    PYTHONPATH=src python -m repro_torch.examples.tpu_pod_serving \
        [--device cpu]

The shared resource is the ``TPU_V5E_POD`` cost model (a 256-chip v5e
pod, as in the reference): tenants are LM architectures at serving
shapes, per-layer profiles come from the real model configs
(``core/profiles.py``), versions trade sharding degree against HBM/ICI
pressure, and VELTAIR's scheduler allocates chips per layer-block.  The
three policies serve a Poisson stream at 20, 60 and 120 qps in the
simulator.  Host-only: ``--device`` is checked as every example checks
it, no kernel is built and nothing is placed on it.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core import cost_model as cm
from repro_torch.core.scheduler import (LayerWisePolicy, ModelWisePolicy,
                                        VeltairPolicy)
from repro_torch.examples import checked_device
from repro_torch.serving import Simulator, lm_serving_plans, \
    poisson_workload

# (arch, shape, qos_ms per decode batch)
POD_TENANTS = [
    ("gemma-2b", "decode_32k", 40.0),
    ("starcoder2-3b", "decode_32k", 60.0),
    ("mamba2-780m", "decode_32k", 25.0),
    ("deepseek-v2-lite-16b", "decode_32k", 120.0),
]
POD_QPS = (20, 60, 120)
POD_QUERIES = 300


def pod_policy_rates() -> dict:
    """The tenants' plans on the pod, then each policy's QoS rate at each
    offered load; -> {"plans": ..., "rates": {policy: [rate per qps]}}."""
    hw = cm.TPU_V5E_POD
    print("compiling multi-version plans for LM tenants on the v5e pod ...")
    t0 = time.time()
    plans = lm_serving_plans(POD_TENANTS)
    for name, p in plans.items():
        print(f"  {name:38s} layers={p.n_layers:3d} Avg_C={p.avg_units:3d}"
              f" chips, versions="
              f"{sum(len(v.versions) for v in p.version_sets)}")
    print(f"  ({time.time()-t0:.1f}s)")

    names = list(plans)
    weights = [1.0 / q for _, _, q in POD_TENANTS]
    print(f"\n{'policy':22s} " + " ".join(f"qps={q:<5d}" for q in POD_QPS))
    rates = {}
    for label, pf in [("model-wise", lambda: ModelWisePolicy(hw)),
                      ("layer-wise", lambda: LayerWisePolicy(hw)),
                      ("VELTAIR-FULL", lambda: VeltairPolicy(hw))]:
        rates[label] = []
        for qps in POD_QPS:
            wl = poisson_workload(names, qps, POD_QUERIES, seed=0,
                                  weights=weights)
            m = Simulator(hw, plans, pf()).run(wl)
            rates[label].append(m.qos_rate)
        print(f"{label:22s} " + " ".join(f"{r:.2f}    "
                                          for r in rates[label]))
    return {"plans": plans, "rates": rates}


def pod_main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    checked_device("tpu_pod_serving", args.device)
    return pod_policy_rates()


# the reference example's name, bound without a second ``def`` (``main``
# is defined in ``src/`` already)
main = pod_main


if __name__ == "__main__":
    main()
