"""The port's co-location cluster against the JAX package's, in virtual
time (``CPU_3990X`` plans, reduced configs, ``batch_slots=2``,
``max_len=32``; the JAX engines' parameters bridged over).

The scenarios of ``tests/test_cluster.py``,
``tests/test_prefill_chunking.py::test_cluster_tenant_prompts_differ_but_stay_deterministic``
and ``tests/test_slo_scheduling.py::test_metrics_schema_parity_online_vs_cluster``:
``build_cluster`` on both sides, ``ClusterRuntime`` under
``VeltairPolicy``, ``ModelWisePolicy`` and ``PremaPolicy``, the SLO and
FIFO schedulers, a tiered serve, explicit oracle counters, an admission
controller, three tenants with starcoder2-3b, and a paged two-tenant
cluster (gemma-2b + starcoder2-3b).  Each serve must give the
reference's ``partition_trace``, ``level_traces``, ``quanta``,
``sched_trace``, pool counters, host syncs, prefill quanta, page and
speculative stats, and aggregate and per-tenant ``ServingMetrics``,
exactly (NaN-aware: ``test_torch_core.same``).  Token streams are the
reference's, except where a stream parts at a position whose reference
logits have their top two within ``CLEAR_MARGIN`` (checked where it
happens; the reduced mamba2 has exact bf16 ties on these prompts).
Then the reference's cluster properties on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cost_model as r_cm  # noqa: E402
from repro.core import scheduler as r_sched  # noqa: E402
from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.serving import cluster as r_cl  # noqa: E402
from repro.serving import runtime as r_rt  # noqa: E402
from repro.serving import slo as r_slo  # noqa: E402
from repro.serving.tenants import cluster_plans as r_cluster_plans  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import cost_model as t_cm  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.serving import cluster as t_cl  # noqa: E402
from repro_torch.serving import runtime as t_rt  # noqa: E402
from repro_torch.serving import slo as t_slo  # noqa: E402
from repro_torch.serving.tenants import cluster_plans as t_cluster_plans  # noqa: E402
from test_torch_core import same, shared_executables  # noqa: E402

MAX_LEN = 32
CLEAR_MARGIN = 2e-2
PAIR = ["gemma-2b", "mamba2-780m"]
TRIO = ["gemma-2b", "starcoder2-3b", "mamba2-780m"]
PAGED = ["gemma-2b", "starcoder2-3b"]
TIERS = {"gemma-2b": "interactive", "mamba2-780m": "batch"}


def _poisson(archs, qps, n, **kw):
    return lambda rt: rt.Workload.poisson(archs, qps, n, **kw)


def _asymmetric(rt):
    """The heavy tenant's engine kept full, two light arrivals."""
    heavy, light = PAIR
    arrivals = [(i * 1e-3, heavy) for i in range(14)]
    arrivals += [(2e-3, light), (8e-3, light)]
    return rt.Workload(sorted(arrivals), prompt_len=4, max_new_tokens=4,
                       seed=0)


# case -> (archs, build_cluster kwargs, policy, runtime kwargs, workload)
CASES = {
    "veltair": (PAIR, {}, "VeltairPolicy", {},
                _poisson(PAIR, 120, 14, prompt_len=4, max_new_tokens=3,
                         seed=1)),
    "asymmetric": (PAIR, {"batch_slots": 4}, "VeltairPolicy", {},
                   _asymmetric),
    "model-wise": (PAIR, {}, "ModelWisePolicy", {},
                   _poisson(PAIR, 100, 8, prompt_len=4, max_new_tokens=2,
                            seed=2)),
    "prema": (PAIR, {}, "PremaPolicy", {},
              _poisson(PAIR, 100, 8, prompt_len=4, max_new_tokens=2,
                       seed=2)),
    "fifo": (PAIR, {}, "VeltairPolicy", {"scheduler": "fifo"},
             _poisson(PAIR, 150, 10, prompt_len=9, prompt_len_spread=6,
                      max_new_tokens=3, seed=3)),
    "tiered": (PAIR, {"tiers": TIERS}, "VeltairPolicy", {},
               lambda rt: rt.Workload.bursty(PAIR, 300, 12, prompt_len=4,
                                             max_new_tokens=2, seed=4)),
    "admission": (PAIR, {"tiers": TIERS}, "VeltairPolicy",
                  {"admission": True},
                  lambda rt: rt.Workload.bursty(PAIR, 900, 16, prompt_len=10,
                                                prompt_len_spread=8,
                                                max_new_tokens=6, seed=11)),
    "three-oracle": (TRIO, {}, "VeltairPolicy",
                     {"counter_source": "oracle"},
                     _poisson(TRIO, 200, 15, prompt_len=10,
                              prompt_len_spread=7, max_new_tokens=3,
                              seed=6)),
    "paged": (PAGED, {"page_size": 8, "n_pages": 8,
                      "page_reserve": "prompt"}, "VeltairPolicy",
              {"admission": True},
              lambda rt: rt.Workload.poisson(PAGED, 800, 14, prompt_len=12,
                                             prompt_len_spread=6,
                                             max_new_tokens=4, seed=7,
                                             shared_prefix_len=8)),
}


@pytest.fixture(scope="module")
def plans():
    archs = sorted(set(PAIR) | set(TRIO) | set(PAGED))
    return {"jax": r_cluster_plans(archs, r_cm.CPU_3990X),
            "torch": t_cluster_plans(archs, t_cm.CPU_3990X)}


@pytest.fixture(autouse=True)
def _clean_dispatch():
    yield
    for mod in (dispatch, jax_dispatch):
        mod.clear_tile_overrides()
        mod.install_ladder(None)


def _bridged(tenants) -> dict:
    return {t.name: params_from_numpy(
        jax.tree_util.tree_map(np.asarray, t.engine.params), device="cpu")
        for t in tenants}


def _clusters(plans, archs, build_kw):
    """The reference's ``build_cluster`` and the port's, on the JAX
    engines' weights."""
    kw = {"batch_slots": 2, "max_len": MAX_LEN, **build_kw}
    ref = r_cl.build_cluster(archs, r_cm.CPU_3990X, plans=plans["jax"], **kw)
    port = t_cl.build_cluster(archs, t_cm.CPU_3990X, plans=plans["torch"],
                              params=_bridged(ref), device="cpu", **kw)
    return ref, port


def _runtime(side, tenants, policy, runtime_kw):
    cm, sched, cl, slo = ((r_cm, r_sched, r_cl, r_slo) if side == "jax"
                          else (t_cm, t_sched, t_cl, t_slo))
    kw = dict(runtime_kw)
    if kw.pop("admission", False):
        kw["admission"] = slo.AdmissionController()
    return cl.ClusterRuntime(tenants, getattr(sched, policy)(cm.CPU_3990X),
                             cm.CPU_3990X, **kw)


@pytest.fixture(scope="module")
def served(plans):
    """case -> {side: (runtime, metrics, workload)}, built on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            archs, build_kw, policy, runtime_kw, workload = CASES[case]
            ref, port = _clusters(plans, archs, build_kw)
            out = {}
            for side, tenants, rt in (("jax", ref, r_rt),
                                      ("torch", port, t_rt)):
                runtime = _runtime(side, tenants, policy, runtime_kw)
                wl = workload(rt)
                out[side] = (runtime, runtime.serve(wl), wl)
            cache[case] = out
        return cache[case]
    return get


def parts_only_at_reference_near_ties(runtime, wl, got, want):
    """``got`` (rid -> tokens) equals ``want`` stream by stream, or parts
    where the reference engine's logits (a prefill of the tenant's prompt
    and the agreed tokens) have their top two within CLEAR_MARGIN and
    both streams' tokens among them.  Returns the number of partings."""
    assert got.keys() == want.keys()
    lens = wl.prompt_lengths()
    tenant_of = {rid: name for rid, (_, name)
                 in enumerate(sorted(wl.arrivals))}
    index = {t.name: i for i, t in enumerate(runtime.tenants)}
    parted = 0
    for rid, stream in got.items():
        if stream == want[rid]:
            continue
        parted += 1
        tenant = runtime.tenants[index[tenant_of[rid]]]
        eng = tenant.engine
        prompts = runtime.tenant_prompts(wl)[tenant.name]
        t = next(i for i, (a, b) in enumerate(zip(stream, want[rid]))
                 if a != b)
        toks = np.concatenate([prompts[rid, :lens[rid]],
                               np.asarray(want[rid][:t], np.int32)])
        logits, _ = eng.model.prefill(eng.params,
                                      {"tokens": jnp.asarray(toks)[None]},
                                      eng.model.init_cache(1, MAX_LEN))
        top = np.asarray(logits, np.float32)[0]
        lg = np.sort(top)
        assert lg[-1] - lg[-2] < CLEAR_MARGIN, (rid, t, lg[-2:])
        for tok in (stream[t], want[rid][t]):
            assert top[tok] >= lg[-1] - CLEAR_MARGIN, (rid, t, tok)
    return parted


@pytest.mark.parametrize("case", sorted(CASES))
def test_virtual_time_serve_matches_reference(served, case):
    (jr, jm, jwl), (tr, tm, twl) = served(case)["jax"], served(case)["torch"]
    assert jwl.arrivals == twl.arrivals
    assert tr.partition_trace == jr.partition_trace
    assert tr.sched_trace == jr.sched_trace
    assert same(tm.level_traces, jm.level_traces)
    for attr in ("quanta", "pool_conflicts", "pool_peak_used", "host_syncs",
                 "tokens_per_sync", "prefill_quanta", "page_stats",
                 "spec_stats"):
        assert same(getattr(tm, attr), getattr(jm, attr)), attr
    assert same(tm.aggregate, jm.aggregate)
    assert same(tm.per_tenant, jm.per_tenant)
    assert same(tm.mean_levels, jm.mean_levels)
    for attr in ("ticks", "conflicts", "shed", "deferred",
                 "tenant_conflicts", "tenant_shed", "tenant_deferred"):
        assert getattr(tr, attr) == getattr(jr, attr), attr
    assert dict(tr.counter_sources) == dict(jr.counter_sources)
    assert tr.pool.free == tr.pool.total
    parts_only_at_reference_near_ties(jr, jwl, tr.outputs, jr.outputs)


def test_partition_conserves_units(served):
    tr, m, wl = served("veltair")["torch"]
    hw = t_cm.CPU_3990X
    assert m.aggregate.n_queries == wl.n_queries
    sums = [sum(p.values()) for p in m.partition_trace]
    assert max(sums) <= hw.n_units and m.pool_peak_used <= hw.n_units
    assert max(sums) > hw.n_units // 2      # some tick saturated the pool
    assert tr.pool.free == tr.pool.total
    assert all(m.quanta[a] >= 1 for a in PAIR)
    assert all(len(m.level_traces[a]) == m.quanta[a] for a in PAIR)


def test_per_engine_levels_diverge_under_asymmetric_load(served):
    _, m, wl = served("asymmetric")["torch"]
    heavy, light = PAIR
    assert m.mean_levels[light] > m.mean_levels[heavy], m.mean_levels
    assert m.aggregate.n_queries == wl.n_queries


@pytest.mark.parametrize("case", ["model-wise", "prema"])
def test_baselines_share_loop_but_pin_solo_version(served, case):
    tr, m, wl = served(case)["torch"]
    assert m.aggregate.n_queries == wl.n_queries
    assert all(lv == 0.0 for tr_ in m.level_traces.values() for lv in tr_)
    if case == "prema":      # exclusive quanta: one engine granted a tick
        assert all(sum(1 for g in part.values() if g > 0) <= 1
                   for part in tr.partition_trace)


def test_the_cases_exercise_what_they_claim(served):
    _, tiered, _ = served("tiered")["torch"]
    assert tiered.aggregate.per_tier and tiered.aggregate.qps_at_qos > 0.0
    adm, m, _ = served("admission")["torch"]
    assert adm.deferred + adm.shed > 0
    _, three, _ = served("three-oracle")["torch"]
    assert all(three.quanta[a] >= 1 for a in TRIO)
    paged, pm, _ = served("paged")["torch"]
    assert paged.deferred > 0
    assert sum(s["shared_hits"] for s in pm.page_stats.values()) > 0
    for t in paged.tenants:
        assert t.engine.pool.used_pages == 0
    fifo, _, _ = served("fifo")["torch"]
    slo, _, _ = served("veltair")["torch"]
    assert fifo.scheduler == "fifo" and slo.scheduler == "slo"


def test_cluster_tenant_prompts_differ_but_stay_deterministic(plans):
    ref, port = _clusters(plans, PAIR, {})
    wl_r = r_rt.Workload.poisson(PAIR, 100, 6, prompt_len=6,
                                 max_new_tokens=2, seed=4)
    wl_t = t_rt.Workload.poisson(PAIR, 100, 6, prompt_len=6,
                                 max_new_tokens=2, seed=4)
    rr = _runtime("jax", ref, "VeltairPolicy", {})
    rt = _runtime("torch", port, "VeltairPolicy", {})
    tables = rt.tenant_prompts(wl_t)
    want = rr.tenant_prompts(wl_r)
    assert not np.array_equal(tables[PAIR[0]], tables[PAIR[1]])
    for a in PAIR:
        np.testing.assert_array_equal(tables[a], want[a])
        np.testing.assert_array_equal(tables[a], rt.tenant_prompts(wl_t)[a])
    m = rt.serve(wl_t)
    assert m.aggregate.n_queries == wl_t.n_queries
    assert sum(m.prefill_quanta.values()) >= wl_t.n_queries
    assert m.aggregate.avg_ttft_s > 0.0


def test_cluster_rejects_unknown_tenant_and_bad_options(plans):
    _, port = _clusters(plans, PAIR, {})
    rt = _runtime("torch", port, "VeltairPolicy", {})
    with pytest.raises(KeyError):
        rt.serve(t_rt.Workload([(0.0, "not-a-model")]))
    for bad in ({"scheduler": "lifo"}, {"counter_source": "pmu"}):
        with pytest.raises(ValueError):
            _runtime("torch", port, "VeltairPolicy", bad)
    with pytest.raises(ValueError):
        t_cl.ClusterRuntime(port + port[:1],
                            t_sched.VeltairPolicy(t_cm.CPU_3990X),
                            t_cm.CPU_3990X)


def test_build_cluster_draws_seeded_weights_and_warms_distinct_versions(
        plans):
    """Without ``params`` each engine draws its weights from a generator
    seeded ``seed + i`` (equal per seed); an engine given version sets
    starts on its level-0 version, ``warmup`` builds each engine's
    distinct versions once and no other, and a serve after it builds
    nothing."""
    kw = dict(batch_slots=2, max_len=MAX_LEN, plans=plans["torch"],
              device="cpu")
    a = t_cl.build_cluster(PAIR, t_cm.CPU_3990X, seed=3, **kw)
    b = t_cl.build_cluster(PAIR, t_cm.CPU_3990X, seed=3, **kw)
    for x, y in zip(a, b):
        wx = x.engine.params["embed"]["embedding"]
        assert torch.equal(wx, y.engine.params["embed"]["embedding"])
        assert x.engine.stream is None and x.engine.version_sets is not None
    assert not torch.equal(a[0].engine.params["embed"]["embedding"],
                           a[1].engine.params["embed"]["embedding"])
    rt = _runtime("torch", a, "VeltairPolicy", {})
    stats = rt.warmup()
    for t in a:
        distinct = {str(t.engine.tiles_for_level(t_cm.grid_point(i)))
                    for i in range(t_cm.NUM_LEVELS)}
        assert stats[t.name]["entries"] == len(distinct)
        assert t.engine._entry_tiles == t.engine.tiles_for_level(0.0)
    builds = {t.name: t.engine.version_cache.traces for t in a}
    rt.serve(t_rt.Workload.poisson(PAIR, 120, 6, prompt_len=5,
                                   max_new_tokens=2, seed=8))
    assert {t.name: t.engine.version_cache.traces for t in a} == builds


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: as fast
    alone, and the test runner's workers share the cores (with a thread
    per core in each worker, the suite's runs took tens of times their
    solo time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _shared_executables():
    """The JAX engines of this module share their compiled executables
    (``test_torch_core.SharedXla``): each case builds new engines, which
    would compile the same modules again."""
    yield from shared_executables()
