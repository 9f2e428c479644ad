"""Flagship example: multi-tenant serving with VELTAIR vs baselines.

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving \
        [--no-online] [--no-colocate] [--no-spec] [--device cpu]

Part 1 (simulator, host-only): compiles multi-version plans for the
paper's MLPerf mix on ``CPU_3990X``, then serves a Poisson query stream
under every scheduling policy and prints the QoS table (Fig. 12-style).
Scheduling decisions run the port's ``core`` code; time advancement is
simulated.

Part 2 (online runtime): replays one tenant mix through a real engine
(reduced gemma-2b) with the VELTAIR policy in the loop — every quantum
the runtime polls the synthesized performance counters and the policy's
proxy maps them to the interference level that swaps the engine's code
version — and prints the engine-vs-simulator ServingMetrics side by side.

Part 3 (co-location cluster): three different real models share the
unit pool under one global scheduler, a CUDA stream each on the card.

Part 4 (speculative decode): the same engine serving the same prompts
twice — plain fused quanta vs draft -> batched-verify -> rollback — and
asserting the streams are token-identical.

Runs on the card unless ``--device cpu`` is passed.  The plans of parts
1-3 are the reference's, on ``CPU_3990X``; on the card two things differ,
because that spec's tiles are not tiles ``block_matmul`` is built for
(an engine given them refuses them): the online engine takes the card's
own level table (``H100_LEVEL_TILES``) while the runtime keeps the
``CPU_3990X`` plans, and the co-location cluster plans for the card's
spec (``hardware_spec_for``: 132 SMs).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.configs.paper_suite import WORKLOAD_CLASSES, paper_models
from repro_torch.core import cost_model as cm
from repro_torch.core.qos import compare_metrics
from repro_torch.core.scheduler import (LayerWisePolicy, ModelWisePolicy,
                                        PremaPolicy, VeltairPolicy)
from repro_torch.examples import example_device, seeded_params
from repro_torch.serving import (ClusterRuntime, OnlineRuntime, Simulator,
                                 Workload, build_cluster, build_paper_plans,
                                 cluster_plans, engine_version_sets,
                                 poisson_workload, replay_through_simulator)
from repro_torch.serving.engine import Request, ServingEngine

TABLE_QPS = (60, 140, 220)
TABLE_QUERIES = 400
ONLINE_TENANTS = ["resnet50", "googlenet"]
CL_ARCHS = ["gemma-2b", "starcoder2-3b", "mamba2-780m"]


def policy_table(hw, plans, models, weights) -> dict:
    """Every policy's QoS rate at each offered load; -> {policy: [rate
    per qps]}."""
    policies = [
        ("model-wise FCFS", lambda: ModelWisePolicy(hw)),
        ("layer-wise (Planaria-ported)", lambda: LayerWisePolicy(hw)),
        ("PREMA (temporal)", lambda: PremaPolicy(hw)),
        ("VELTAIR-AS", lambda: VeltairPolicy(hw, adaptive_compile=False)),
        ("VELTAIR-AC", lambda: VeltairPolicy(hw, adaptive_schedule=False)),
        ("VELTAIR-FULL", lambda: VeltairPolicy(hw)),
    ]
    print(f"\n{'policy':32s} " + " ".join(f"qps={q:<5d}" for q in TABLE_QPS))
    table = {}
    for name, pf in policies:
        rates = []
        for qps in TABLE_QPS:
            wl = poisson_workload(models, qps, TABLE_QUERIES, seed=1,
                                  weights=weights)
            m = Simulator(hw, plans, pf()).run(wl)
            rates.append(m.qos_rate)
        table[name] = rates
        print(f"{name:32s} " + " ".join(f"{r:.2f}    " for r in rates))
    return table


def online_runtime_demo(hw, cfg, params, device) -> dict:
    """A real engine under VeltairPolicy: one tenant mix replayed through
    simulator AND engine, metrics side by side."""
    dev = torch.device(device)
    plans = build_paper_plans(ONLINE_TENANTS, hw)
    # on the card the engine runs its own level table: the CPU plan's
    # tiles are not ones the kernels are built for
    engine = ServingEngine(cfg, params, batch_slots=2, max_len=32,
                           version_sets=(engine_version_sets(plans)
                                         if dev.type == "cpu" else None),
                           device=dev)
    # mixed-length prompts (spread > 0): slots decode at their own
    # positions, no alignment needed
    wl = Workload.poisson(ONLINE_TENANTS, 60, 24, prompt_len=4,
                          max_new_tokens=4, seed=1, prompt_len_spread=2)
    # build every interference level's code version ahead of time: each
    # switch during serve() is then a dictionary swap, never a build
    engine.warmup(prompt_lens=tuple(sorted(set(wl.prompt_lengths()))))
    t0 = time.time()
    runtime = OnlineRuntime(engine, VeltairPolicy(hw), plans, hw)
    m_eng = runtime.serve(wl)
    wall = time.time() - t0
    m_sim = replay_through_simulator(wl, hw, plans, VeltairPolicy(hw))

    lv = runtime.level_trace
    print(f"\nonline runtime: {m_eng.n_queries} queries through the real "
          f"engine in {wall:.1f}s wall ({runtime.steps} decode steps in "
          f"{runtime.quanta} fused dispatch quanta, "
          f"{engine.tokens_per_sync:.1f} tokens per host sync, "
          f"{engine.level_switches} version switches, "
          f"{1e3 * runtime.compile_time_s:.1f}ms in switches, "
          f"version cache {engine.version_cache.stats}, interference level "
          f"{min(lv):.2f}..{max(lv):.2f})")
    rows = compare_metrics(m_sim, m_eng)
    print(f"{'metric':18s} {'simulator':>12s} {'engine':>12s}")
    for field, (a, b) in rows.items():
        print(f"{field:18s} {a:12.4f} {b:12.4f}")
    return {"rows": rows, "wall_s": wall,
            "level_switches": engine.level_switches, "device": engine.device}


def colocation_walkthrough(hw, device) -> dict:
    """Co-location walkthrough: heterogeneous models, one unit pool.

    Each numbered step below is one knob of the co-location path."""
    # (1) Pick the tenants: three architectures with genuinely different
    #     layer profiles (dense attention, GQA code model, SSM).  Each
    #     gets an analytic ModelPlan on this hardware with a feasible
    #     auto-derived QoS (qos_scale x solo latency).
    archs = list(CL_ARCHS)
    plans = cluster_plans(archs, hw, qos_scale=3.0)

    # (2) Stand up one real engine per model.  Every engine owns its
    #     params, KV/SSM cache, version cache and (on the card) CUDA
    #     stream; its tile table comes from its OWN plan's multi-version
    #     compilation, so per-engine levels select per-model code.
    def cluster():
        return build_cluster(archs, hw, batch_slots=2, max_len=32,
                             plans=plans, device=device)
    tenants = cluster()

    # (3) One shared Poisson stream whose tenant names route queries to
    #     the matching engine.
    wl = Workload.poisson(archs, 90, 18, prompt_len=4, max_new_tokens=3,
                          seed=1)

    # (4) Serve under the global scheduler.  Per quantum and per engine:
    #     counters are synthesized from the live slot occupancy of the
    #     co-resident engines, the calibrated LinearProxy maps them to a
    #     pressure estimate, plan_chunk_at forms the next layer-block
    #     (its size = the engine's dispatch quantum, its unit need = the
    #     engine's share of hw.n_units), and set_interference_level swaps
    #     that engine to the matching precompiled code version.
    print(f"\nco-locating {len(archs)} heterogeneous real engines on "
          f"{hw.n_units} {hw.unit}s ...")
    rows, devices = [], set()
    for name, policy in (("veltair", VeltairPolicy(hw)),
                         ("model-wise", ModelWisePolicy(hw)),
                         ("prema", PremaPolicy(hw))):
        served = tenants if name == "veltair" else cluster()
        devices.update(t.engine.device for t in served)
        m = ClusterRuntime(served, policy, hw).serve(wl)
        lv = "/".join(f"{m.mean_levels[a]:.2f}" for a in archs)
        rows.append((name, m.aggregate.qos_rate,
                     1e3 * m.aggregate.p99_latency_s,
                     sum(m.quanta.values()), m.pool_peak_used, lv))
    print(f"{'policy':12s} {'qos':>5s} {'p99_ms':>7s} {'quanta':>7s} "
          f"{'peak_units':>10s}  mean levels ({'/'.join(archs)})")
    for name, qos, p99, quanta, peak, lv in rows:
        print(f"{name:12s} {qos:5.2f} {p99:7.2f} {quanta:7d} {peak:10d}  "
              f"{lv}")
    return {"rows": rows, "devices": sorted(str(d) for d in devices)}


def speculative_pair(cfg, params, device) -> dict:
    """Speculative decode quanta: the same prompts served twice through
    the same model — plain fused quanta, then draft -> batched verify ->
    rollback — with the streams asserted token-identical."""
    # repetitive continuations (the serving analogue of templated text)
    # are where prompt-lookup drafts land
    prompts = [np.full(n, 7 + n, np.int32) for n in (12, 9, 6)]

    def serve_once(speculative):
        eng = ServingEngine(cfg, params, batch_slots=2, max_len=160,
                            speculative=speculative, device=device)
        eng.warmup(prompt_lens=tuple(len(p) for p in prompts))
        reqs = [Request(rid=i, prompt=p, max_new_tokens=96)
                for i, p in enumerate(prompts)]
        pending = list(reqs)
        while pending and eng.admit_request(pending[0], drain=True):
            pending.pop(0)
        t0 = time.time()
        while pending or not all(r.done for r in reqs):
            eng.step_quantum(8)
            while pending and eng.admit_request(pending[0], drain=True):
                pending.pop(0)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        return eng, [list(r.output) for r in reqs], time.time() - t0

    plain_eng, plain, dt_p = serve_once(False)
    eng, spec, dt_s = serve_once(True)
    s = eng.spec_stats
    toks = sum(len(o) for o in spec)
    print(f"\nspeculative decode: {toks} tokens, token-identical="
          f"{plain == spec}, plain {toks/dt_p:.0f} tok/s -> spec "
          f"{toks/dt_s:.0f} tok/s ({s['spec_quanta']} spec quanta, "
          f"hit rate {s['draft_hit_rate']:.0%}, "
          f"{s['spec_rollbacks']} rollbacks, "
          f"{s['spec_fallbacks']} fallbacks)")
    assert plain == spec, "speculation must never change the tokens"
    return {"plain": plain, "spec": spec, "tokens": toks,
            "plain_tokens_per_s": toks / dt_p, "spec_tokens_per_s":
            toks / dt_s, "spec_stats": dict(s),
            "devices": sorted({str(plain_eng.device), str(eng.device)})}


def multi_tenant_main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-online", action="store_true",
                    help="skip the real-engine replay (simulator only)")
    ap.add_argument("--no-colocate", action="store_true",
                    help="skip the multi-engine co-location demo")
    ap.add_argument("--no-spec", action="store_true",
                    help="skip the speculative-decode demo")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = example_device("multi_tenant_serving", args.device)

    hw = cm.CPU_3990X
    pm = paper_models()
    models = list(WORKLOAD_CLASSES["mix"])
    print(f"compiling multi-version plans for {len(models)} tenants ...")
    t0 = time.time()
    plans = build_paper_plans(models, hw)
    print(f"  done in {time.time()-t0:.1f}s; per-model versions: "
          + ", ".join(
          f"{n}={sum(len(v.versions) for v in p.version_sets)}"
          for n, p in plans.items()))

    weights = [1.0 / pm[m].qos_ms for m in models]
    out = {"table": policy_table(hw, plans, models, weights)}
    cfg = get_reduced_config("gemma-2b")
    params = (seeded_params(cfg, dev)
              if not (args.no_online and args.no_spec) else None)
    if not args.no_online:
        out["online"] = online_runtime_demo(hw, cfg, params, dev)
    if not args.no_colocate:
        out["colocation"] = colocation_walkthrough(
            hw if dev.type == "cpu" else cm.hardware_spec_for(dev), dev)
    if not args.no_spec:
        out["speculative"] = speculative_pair(cfg, params, dev)
    return out


# the reference example's names, bound without a second ``def`` (``main``
# is defined in ``src/`` already)
sim_policy_table = policy_table
online_engine_demo = online_runtime_demo
colocation_demo = colocation_walkthrough
speculative_demo = speculative_pair
main = multi_tenant_main


if __name__ == "__main__":
    main()
