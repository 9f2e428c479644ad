"""The port's scheduling core against the JAX package's (pure Python and
numpy on both sides, so every comparison is exact, NaN-aware where a
metric is NaN by definition):

  * the cost model, the schedule space and Alg. 1: equal version
    tables, QoS slices and layer blocks for every paper model;
  * the five policies (and VELTAIR's two ablations): equal levels and
    ``plan_chunk`` / ``plan_chunk_at`` chunks on the same seeded demand
    and counter samples;
  * the linear proxy: calibration and online RLS refits give the same
    coefficients bit for bit;
  * the simulator and ``run_sweep``: equal ``ServingMetrics`` and records;
  * the arrival generators, the QoS reduction and the unit pool.
"""
import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import paper_suite as r_suite  # noqa: E402
from repro.core import allocator as r_alloc  # noqa: E402
from repro.core import cost_model as r_cm  # noqa: E402
from repro.core import interference as r_itf  # noqa: E402
from repro.core import layer_block as r_lb  # noqa: E402
from repro.core import multiversion as r_mv  # noqa: E402
from repro.core import qos as r_qos  # noqa: E402
from repro.core import schedule_space as r_ss  # noqa: E402
from repro.core import scheduler as r_sched  # noqa: E402
from repro.serving import request as r_req  # noqa: E402
from repro.serving import simulator as r_sim  # noqa: E402
from repro.serving import tenants as r_ten  # noqa: E402
from repro_torch.configs import paper_suite as t_suite  # noqa: E402
from repro_torch.core import allocator as t_alloc  # noqa: E402
from repro_torch.core import cost_model as t_cm  # noqa: E402
from repro_torch.core import interference as t_itf  # noqa: E402
from repro_torch.core import layer_block as t_lb  # noqa: E402
from repro_torch.core import multiversion as t_mv  # noqa: E402
from repro_torch.core import qos as t_qos  # noqa: E402
from repro_torch.core import schedule_space as t_ss  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.serving import request as t_req  # noqa: E402
from repro_torch.serving import simulator as t_sim  # noqa: E402
from repro_torch.serving import tenants as t_ten  # noqa: E402

SIDES = {"ref": (r_cm, r_sched, r_sim, r_ten),
         "port": (t_cm, t_sched, t_sim, t_ten)}
MODELS = sorted(r_suite.paper_models())
TENANTS = ["resnet50", "googlenet"]


def same(a, b) -> bool:
    """Equality that takes NaN == NaN (dataclasses, containers, arrays)."""
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        return type(a).__name__.removeprefix("Torch") == \
            type(b).__name__.removeprefix("Torch") and all(
                same(getattr(a, f.name), getattr(b, f.name))
                for f in dataclasses.fields(a))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and bool(
            np.all((a == b) | (np.isnan(a) & np.isnan(b))))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_same_is_nan_aware_and_strict():
    assert same(r_qos.ServingMetrics(1.0, float("nan"), 0.0, 0.0, 0.0, 0.0,
                                     0.0),
                t_qos.ServingMetrics(1.0, float("nan"), 0.0, 0.0, 0.0, 0.0,
                                     0.0))
    assert not same(r_qos.ServingMetrics(1.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0),
                    t_qos.ServingMetrics(1.0, 0.5, 0.0, 0.0, 0.0, 0.0,
                                         1e-12))


@pytest.fixture(scope="module")
def plans():
    return {side: ten.build_paper_plans(MODELS, cm.CPU_3990X)
            for side, (cm, _, _, ten) in SIDES.items()}


# ---------------------------------------------------------------------------
# cost model, schedule space, Alg. 1 and Alg. 2


def test_hardware_specs_and_level_grid_match():
    for name in ("CPU_3990X", "TPU_V5E_POD"):
        assert same(getattr(r_cm, name), getattr(t_cm, name))
    assert same(r_cm.level_grid(), t_cm.level_grid())
    for x in np.linspace(-0.2, 1.2, 57):
        assert same(r_cm.Interference.from_level(float(x)),
                    t_cm.level_interference(float(x)))
        assert r_cm.level_to_idx(float(x)) == t_cm.level_to_idx(float(x))


def _layers(suite, name):
    return list(suite.paper_models()[name].layers)


@pytest.mark.parametrize("model", MODELS)
def test_cost_model_terms_match_on_every_version(model):
    """latency, units_required and the three demand terms on every
    enumerated version of the model's first and last layers, at three
    unit counts and every grid pressure, on both platforms."""
    r_layers, t_layers = _layers(r_suite, model), _layers(t_suite, model)
    for hw_name in ("CPU_3990X", "TPU_V5E_POD"):
        rhw, thw = getattr(r_cm, hw_name), getattr(t_cm, hw_name)
        for rl, tl in ((r_layers[0], t_layers[0]),
                       (r_layers[-1], t_layers[-1])):
            assert same(rl, tl)
            rvs = r_ss.enumerate_versions(rl, rhw)
            tvs = t_ss.enumerate_versions(tl, thw)
            assert same(rvs, tvs)
            assert same(r_ss.default_version(rl, rhw),
                        t_ss.default_version(tl, thw))
            for rv, tv in list(zip(rvs, tvs))[::7]:
                for ri, ti in zip(r_cm.level_grid(), t_cm.level_grid()):
                    for u in (1, 17, rhw.n_units):
                        assert r_cm.latency(rhw, rv, u, ri) == \
                            t_cm.latency(thw, tv, u, ti)
                        assert r_cm.bw_demand(rhw, rv, u, ri) == \
                            t_cm.bw_demand(thw, tv, u, ti)
                        assert r_cm.cache_demand(rhw, rv, u) == \
                            t_cm.cache_demand(thw, tv, u)
                        assert r_cm.ici_demand(rhw, rv, u, ri) == \
                            t_cm.ici_demand(thw, tv, u, ti)
                    assert r_cm.units_required(rhw, rv, 1e-4, ri) == \
                        t_cm.units_required(thw, tv, 1e-4, ti)


@pytest.mark.parametrize("model", MODELS)
def test_paper_plans_match_reference(plans, model):
    """compile_model / build_paper_plans: equal version tables (every
    version's fields, the level tables, frontier and candidate counts),
    QoS, budgets, Avg_C, layer-wise and FCFS units."""
    assert same(plans["ref"][model], plans["port"][model])


def test_compile_model_without_qos_matches():
    for name in ("tiny_yolov2", "bert_large"):
        for hw_name in ("CPU_3990X", "TPU_V5E_POD"):
            assert same(
                r_mv.compile_model(_layers(r_suite, name),
                                   getattr(r_cm, hw_name)),
                t_mv.compile_model(_layers(t_suite, name),
                                   getattr(t_cm, hw_name)))


@pytest.mark.parametrize("model", ["resnet50", "bert_large", "ssd"])
def test_layer_blocks_match_at_every_level(plans, model):
    rp, tp = plans["ref"][model], plans["port"][model]
    for ri, ti in zip(r_cm.level_grid(), t_cm.level_grid()):
        for thres in (0.0, 3.0, 17.5, 64.0):
            for ac in (True, False):
                assert same(r_lb.form_blocks(rp, r_cm.CPU_3990X, ri, thres,
                                             adaptive_compile=ac),
                            t_lb.form_blocks(tp, t_cm.CPU_3990X, ti, thres,
                                             adaptive_compile=ac))


# ---------------------------------------------------------------------------
# the policies


POLICIES = {
    "veltair-full": lambda s, hw: s.VeltairPolicy(hw),
    "veltair-as": lambda s, hw: s.VeltairPolicy(hw, adaptive_compile=False),
    "veltair-ac": lambda s, hw: s.VeltairPolicy(hw, adaptive_schedule=False),
    "model-wise": lambda s, hw: s.ModelWisePolicy(hw),
    "layer-wise": lambda s, hw: s.LayerWisePolicy(hw),
    "block-6": lambda s, hw: s.FixedBlockPolicy(hw, 6),
    "prema": lambda s, hw: s.PremaPolicy(hw),
}


def _demands(itf, rng, n):
    return [itf.RunningDemand(tenant=int(rng.integers(0, 4)),
                              bw=float(rng.uniform(0, 0.9)),
                              cache=float(rng.uniform(0, 1.2)),
                              ici=float(rng.uniform(0, 0.5)),
                              start=float(rng.uniform(0, 1)),
                              finish=float(rng.uniform(1, 2)))
            for _ in range(n)]


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_policies_give_the_same_levels_and_chunks(plans, policy):
    """Seeded demand sets, seeded counter samples and tasks at every
    layer position of two tenants: the same level from the counters and
    from the demands, the same plan_chunk and plan_chunk_at chunks, the
    same dispatch orders, on both platforms."""
    for hw_name in ("CPU_3990X", "TPU_V5E_POD"):
        pols = {side: POLICIES[policy](sched, getattr(cm, hw_name))
                for side, (cm, sched, _, _) in SIDES.items()}
        rng = np.random.default_rng(17)
        for trial in range(12):
            seed = int(rng.integers(0, 2**31))
            now = 1.0 + 0.05 * trial
            out = {}
            for side, (cm, sched, _, _) in SIDES.items():
                itf_mod = r_itf if side == "ref" else t_itf
                drng = np.random.default_rng(seed)
                demands = _demands(itf_mod, drng, trial % 5)
                hw = getattr(cm, hw_name)
                sample = itf_mod.read_counters(hw, -1, demands, now, drng)
                pol = pols[side]
                tasks = [sched.TaskState(tid=i, tenant=n,
                                         plan=plans[side][n],
                                         arrival=0.01 * i,
                                         next_layer=(7 * trial + i)
                                         % plans[side][n].n_layers)
                         for i, n in enumerate(TENANTS)]
                row = [sample.values, pol.level_from_counters(sample),
                       pol.interference_from_counters(sample),
                       pol.online_level(demands, now)]
                itf = pol.interference_from_counters(sample)
                for task in tasks:
                    row.append(pol.plan_chunk(task, tasks, demands, now,
                                              hw.n_units // 2))
                    row.append(pol.plan_chunk_at(task, tasks, itf, now,
                                                 hw.n_units))
                row.append([t.tid for t in pol.order_pending(tasks, now)])
                row.append([t.tid for t in pol.order_by_slack(tasks, now)])
                out[side] = row
            assert same(out["ref"], out["port"]), (policy, hw_name, trial)


# ---------------------------------------------------------------------------
# the proxy


def test_proxy_calibration_is_bit_identical():
    for hw_name in ("CPU_3990X", "TPU_V5E_POD"):
        for seed in (0, 3):
            r = r_itf.calibrate_proxy(getattr(r_cm, hw_name), seed=seed)
            t = t_itf.calibrate_proxy(getattr(t_cm, hw_name), seed=seed)
            assert same(list(r[1:]), list(t[1:]))
            for f in ("w", "b", "r2", "base_rms"):
                assert same(getattr(r[0], f), getattr(t[0], f)), f


def test_rls_updates_and_drift_refits_are_bit_identical():
    """One stream of (counters, pressure) pairs whose counter->pressure
    gain changes twice: every step's residual, the coefficients, the
    window RMS and the drift refits agree exactly."""
    rp = r_itf.calibrate_proxy(r_cm.CPU_3990X)[0]
    tp = t_itf.calibrate_proxy(t_cm.CPU_3990X)[0]
    rng = np.random.default_rng(5)
    for step in range(240):
        gain = (1.0, 1.7, 0.6)[step // 80]
        lvl = float(rng.uniform())
        rtrue = r_cm.Interference.from_level(lvl)
        ttrue = t_cm.level_interference(lvl)
        c = r_itf.synthesize_counters(r_cm.CPU_3990X, rtrue, rng) * gain
        target = (rtrue, ttrue) if step % 2 else (
            np.array([rtrue.cache, rtrue.bw]),) * 2
        assert rp.rls_update(c, target[0]) == tp.rls_update(c, target[1])
        assert same(rp.w, tp.w) and same(rp.b, tp.b)
        assert same(rp.rms_error, tp.rms_error)
        assert same(rp.predict_interference(c), tp.predict_interference(c))
        assert rp.predict(c) == tp.predict(c)
    assert rp.refit_count == tp.refit_count >= 2
    assert rp.rls_updates == tp.rls_updates == 240


def test_read_counters_and_pressure_match():
    rng_r, rng_t = np.random.default_rng(9), np.random.default_rng(9)
    for n in range(8):
        for victim in (-1, 0, 2):
            dr = _demands(r_itf, np.random.default_rng(n), n)
            dt = _demands(t_itf, np.random.default_rng(n), n)
            assert same(r_itf.pressure_on(victim, dr, 1.3),
                        t_itf.pressure_on(victim, dt, 1.3))
            assert same(r_itf.pressure_on(victim, dr, 1.3,
                                          exclude_soon_done=False),
                        t_itf.pressure_on(victim, dt, 1.3,
                                          exclude_soon_done=False))
            assert same(r_itf.read_counters(r_cm.CPU_3990X, victim, dr,
                                            1.3, rng_r),
                        t_itf.read_counters(t_cm.CPU_3990X, victim, dt,
                                            1.3, rng_t))
            assert [d.soon_done(1.9) for d in dr] == \
                [d.soon_done(1.9) for d in dt]


# ---------------------------------------------------------------------------
# the simulator


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_simulator_matches_reference(plans, policy):
    """One Poisson mix over four tenants, with stragglers on: the same
    ServingMetrics, records, conflict and straggler counts and pool."""
    names = ["resnet50", "googlenet", "mobilenet_v2", "bert_large"]
    out = {}
    for side, (cm, sched, sim_mod, _) in SIDES.items():
        req = r_req if side == "ref" else t_req
        wl = req.poisson_workload(names, 150, 90, seed=4,
                                  weights=[4, 4, 6, 1])
        sim = sim_mod.Simulator(cm.CPU_3990X,
                                {n: plans[side][n] for n in names},
                                POLICIES[policy](sched, cm.CPU_3990X),
                                sim_mod.SimConfig(straggler_prob=0.05,
                                                  seed=2))
        m = sim.run(wl)
        out[side] = (m, sim.records, sim.conflicts, sim.requests,
                     sim.stragglers, sim.pool, sim.busy_unit_time,
                     sim.alloc_unit_time)
    assert same(out["ref"], out["port"])


def test_truncated_simulation_matches_reference(plans):
    out = {}
    for side, (cm, sched, sim_mod, _) in SIDES.items():
        req = r_req if side == "ref" else t_req
        sim = sim_mod.Simulator(cm.CPU_3990X, plans[side],
                                sched.VeltairPolicy(cm.CPU_3990X),
                                sim_mod.SimConfig(max_sim_time=0.05))
        m = sim.run(req.uniform_workload("ssd", 400, 60))
        out[side] = (m, sim.records, sim.alloc_unit_time)
    assert same(out["ref"], out["port"])


def test_run_sweep_and_qps_at_qos_match(plans):
    out = {}
    for side, (cm, sched, sim_mod, _) in SIDES.items():
        req = r_req if side == "ref" else t_req
        qos = r_qos if side == "ref" else t_qos
        sweep = sim_mod.run_sweep(
            cm.CPU_3990X, {n: plans[side][n] for n in TENANTS},
            lambda: sched.VeltairPolicy(cm.CPU_3990X),
            lambda q: req.gamma_poisson_workload(TENANTS, q, 60, seed=1),
            [40, 160, 400, 900])
        out[side] = (sweep, qos.qps_at_qos(sweep), qos.qps_at_qos(sweep,
                                                                  0.5))
    assert same(out["ref"], out["port"])


# ---------------------------------------------------------------------------
# arrivals, the QoS reduction, the unit pool


def test_arrival_generators_and_prompts_match():
    names = ["resnet50", "googlenet", "efficientnet"]
    for seed in (0, 7):
        for fn, kw in (("poisson_workload", {}),
                       ("poisson_workload", {"weights": [1, 2, 3]}),
                       ("gamma_poisson_workload", {"burstiness": 4.0}),
                       ("gamma_poisson_workload", {"burstiness": 0.0}),
                       ("diurnal_workload", {"floor": 0.3})):
            assert getattr(r_req, fn)(names, 300, 50, seed=seed, **kw) == \
                getattr(t_req, fn)(names, 300, 50, seed=seed, **kw)
        assert np.array_equal(r_req.synth_prompts(9, 13, 1000, seed),
                              t_req.synth_prompts(9, 13, 1000, seed))
    assert r_req.uniform_workload("ssd", 70, 9) == \
        t_req.uniform_workload("ssd", 70, 9)


def test_summarize_and_compare_metrics_match():
    rng = np.random.default_rng(3)
    for n in (0, 1, 40):
        recs = {}
        for side, qos in (("ref", r_qos), ("port", t_qos)):
            r2 = np.random.default_rng(n)
            recs[side] = [qos.QueryRecord(
                tenant=f"t{i % 3}", arrival=float(a), finish=float(a + d),
                qos_s=0.01, ttft_s=None if i % 4 == 0 else float(d / 3),
                tier=qos.TIER_ORDER[i % 3],
                deadline=None if i % 5 == 0 else float(a + 0.02))
                for i, (a, d) in enumerate(zip(r2.uniform(0, 1, n),
                                               r2.exponential(0.01, n)))]
        kw = dict(shed=2, deferred=3, peak_cache_tokens=11,
                  cache_utilization=0.4, proxy_rms_error=float("nan"),
                  refit_count=1)
        args = (float(rng.uniform(10, 90)), 0.1, 2.0, 3.0)
        mr = r_qos.summarize(recs["ref"], *args, **kw)
        mt = t_qos.summarize(recs["port"], *args, **kw)
        assert same(mr, mt)
        assert same(r_qos.compare_metrics(mr, mr),
                    t_qos.compare_metrics(mt, mt))
    for tier in (None, *r_qos.TIER_ORDER):
        assert same(r_qos.tier_spec(tier), t_qos.tier_spec(tier))
    with pytest.raises(ValueError):
        t_qos.tier_spec("gold")


def test_unit_pool_matches_reference_on_random_operations():
    rp, tp = r_alloc.UnitPool(64), t_alloc.UnitPool(64)
    rng = np.random.default_rng(1)
    held = []
    for _ in range(400):
        if held and rng.uniform() < 0.45:
            n = held.pop(int(rng.integers(0, len(held))))
            rp.release(n)
            tp.release(n)
        else:
            lo = int(rng.integers(1, 24))
            hi = lo + int(rng.integers(0, 24))
            g = rp.try_alloc_range(lo, hi)
            assert tp.try_alloc_range(lo, hi) == g
            held.append(g)
        assert same(rp, tp)
        assert rp.conflict_rate == tp.conflict_rate
    assert rp.try_alloc(5) == tp.try_alloc(5)
    assert same(rp, tp)
