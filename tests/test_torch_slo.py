"""The SLO scheduler's page dimension and the measured-counter path of the
port, against the JAX package:

  * ``tests/test_paged_cache.py``'s two scheduler scenarios, on both
    packages: ``pick_quantum`` consults a paged engine's headroom hook
    (and passes k through without one), and the admission controller
    defers on a page shortage with a slot free;
  * the same clamp on the port's real paged engine: free pages cut a
    decode quantum, exactly as on the JAX engine in the same state;
  * measured counters: the same injected ``observe(...)`` calls on a
    reference and a port ``CounterBank`` give the same ``sample()``, the
    same policy level and the same cold-bank fall back to the oracle; and
    a virtual-time serve with ``counter_source="measured"``, whose
    engines' banks are fed the same injected walls in place of host wall
    times, gives identical traces, counter sources and metrics (the proxy
    refits included).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.core import cost_model as r_cm  # noqa: E402
from repro.core import counters as r_counters  # noqa: E402
from repro.core import interference as r_itf  # noqa: E402
from repro.core import qos as r_qos  # noqa: E402
from repro.core import scheduler as r_sched  # noqa: E402
from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import runtime as r_rt  # noqa: E402
from repro.serving import slo as r_slo  # noqa: E402
from repro.serving.tenants import build_paper_plans as r_plans  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import cost_model as t_cm  # noqa: E402
from repro_torch.core import counters as t_counters  # noqa: E402
from repro_torch.core import interference as t_itf  # noqa: E402
from repro_torch.core import qos as t_qos  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving import runtime as t_rt  # noqa: E402
from repro_torch.serving import slo as t_slo  # noqa: E402
from repro_torch.serving.tenants import build_paper_plans as t_plans  # noqa: E402
from test_torch_core import same, shared_executables  # noqa: E402

MAX_LEN = 32
TENANTS = ["resnet50", "googlenet"]
SIDES = {"jax": (r_cm, r_counters, r_itf, r_qos, r_sched, r_slo, r_rt),
         "torch": (t_cm, t_counters, t_itf, t_qos, t_sched, t_slo, t_rt)}


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced_config("gemma-2b")
    jparams = build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return {"jax": (jcfg, jparams), "torch":
            (get_reduced_config("gemma-2b"), tparams)}


@pytest.fixture(scope="module")
def plans():
    return {"jax": r_plans(TENANTS, r_cm.CPU_3990X),
            "torch": t_plans(TENANTS, t_cm.CPU_3990X)}


@pytest.fixture(autouse=True)
def _clean_dispatch():
    yield
    for mod in (dispatch, jax_dispatch):
        mod.clear_tile_overrides()
        mod.install_ladder(None)


def _engine(setup, side, **kw):
    cfg, params = setup[side]
    if side == "jax":
        return jax_engine.ServingEngine(cfg, params, max_len=MAX_LEN, **kw)
    return torch_engine.ServingEngine(cfg, params, max_len=MAX_LEN,
                                      device="cpu", **kw)


# ---------------------------------------------------------------------------
# tests/test_paged_cache.py's scheduler scenarios, on both packages


@pytest.mark.parametrize("side", sorted(SIDES))
def test_pick_quantum_consults_page_headroom(side):
    slo = SIDES[side][5]

    class _Book:
        def get(self, rid):
            return None

    class _Paged:
        def prefill_queue(self):
            return []

        def decode_backlog(self):
            return [(0, 0, 5)]

        def decode_k_headroom(self, k):
            return min(k, 3)

    class _Dense(_Paged):
        decode_k_headroom = None          # not callable -> no clamp

    assert slo.pick_quantum(_Paged(), _Book(), 0.0, 1e-3, 16) == \
        ("decode", 3)
    assert slo.pick_quantum(_Dense(), _Book(), 0.0, 1e-3, 16) == \
        ("decode", 16)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_admission_controller_defers_on_page_shortage(side):
    _, _, _, qos, _, slo, _ = SIDES[side]
    ac = slo.AdmissionController()
    spec = qos.DEFAULT_TIERS["standard"]
    entry = slo.SloEntry(rid=0, tenant="t", tier="standard", arrival=0.0,
                         qos_s=1.0, deadline=2.5, ttft_deadline=1.5)
    kw = dict(now=0.0, entry=entry, spec=spec, step_dt=1e-3, own_chunks=1,
              own_decode_steps=4, backlog_chunks=0, slot_free=True)
    assert ac.decide(**kw, pages_needed=3, pages_free=2) == "defer"
    assert ac.decide(**kw, pages_needed=2, pages_free=2) == "admit"
    assert ac.decide(**kw, pages_needed=3, pages_free=None) == "admit"
    assert ac.decide(**{**kw, "slot_free": False}, pages_needed=0,
                     pages_free=None) == "defer"
    late = dict(kw, now=3.0)
    assert ac.decide(**late, pages_needed=0, pages_free=None) == "shed"
    batch = dict(late, spec=qos.DEFAULT_TIERS["batch"])
    assert ac.decide(**batch, pages_needed=0, pages_free=None) == "admit"


def test_deadline_book_matches_reference():
    books = {s: SIDES[s][5].DeadlineBook() for s in SIDES}
    for rid, tier in enumerate((None, "interactive", "standard", "batch")):
        es = [books[s].register(rid, "t", tier, 0.01 * rid, 0.015)
              for s in SIDES]
        assert same(*es)
        assert es[0].slack(0.02) == es[1].slack(0.02)
    for s in SIDES:
        books[s].drop(1)
    assert books["jax"].get(1) is books["torch"].get(1) is None
    with pytest.raises(ValueError):
        books["torch"].spec("gold")


def _clamp_state(setup, side, paged):
    """A one-slot engine, one 7-token prompt prefilled: the row decodes at
    position 7, the last slot of its only page.  Paged: one page of eight
    tokens in all, so any quantum past one step needs a page the pool
    does not have."""
    mod = jax_engine if side == "jax" else torch_engine
    kw = dict(page_size=8, n_pages=1, page_reserve="prompt") if paged \
        else {}
    eng = _engine(setup, side, batch_slots=1, **kw)
    p = np.random.default_rng(3).integers(
        0, setup[side][0].vocab_size, 7).astype(np.int32)
    assert eng.admit_request(mod.Request(rid=0, prompt=p,
                                         max_new_tokens=10), drain=True)
    return eng


def test_quantum_clamped_by_free_pages_on_the_paged_engine(setup):
    """On the port's real paged engine the EDF pick shrinks a decode
    quantum to what the free pages can hold (the reference reads the hook
    with ``getattr(..., None)`` and would pass k through without a
    word); the same state on the JAX engine gives the same pick, and a
    dense engine passes k through."""
    for k_max in (1, 4, 16):
        picks = {}
        for side in SIDES:
            slo = SIDES[side][5]
            eng = _clamp_state(setup, side, paged=True)
            assert eng.pool.free_pages == 0
            assert eng.decode_k_headroom(k_max) == 1
            picks[side] = slo.pick_quantum(eng, slo.DeadlineBook(), 0.0,
                                           1e-3, k_max)
            dense = _clamp_state(setup, side, paged=False)
            assert slo.pick_quantum(dense, slo.DeadlineBook(), 0.0, 1e-3,
                                    k_max) == ("decode", k_max)
        assert picks["torch"] == picks["jax"] == ("decode", 1)
    # the clamp is real: the engine then runs that one step and stalls
    # nothing
    eng = _clamp_state(setup, "torch", paged=True)
    handle = eng.begin_quantum(eng.decode_k_headroom(16))
    assert handle.steps == 1
    eng.finish_quantum(handle)
    assert eng.page_stats["stalls"] == 0


# ---------------------------------------------------------------------------
# measured counters


OBS = [("decode", 8, ("a",), 2.0e-3), ("decode", 8, ("a",), 2.2e-3),
       ("prefill", 16, ("a",), 5.0e-3), ("decode", 8, ("a",), 3.1e-3),
       ("decode", 4, ("b",), 1.0e-3), ("decode", 4, ("b",), 0.0),
       ("prefill", 16, ("a",), 6.5e-3), ("decode", 4, ("b",), 1.4e-3),
       ("decode", 8, ("a",), 4.4e-3), ("decode", 8, ("a",), 2.05e-3)]


def test_counter_banks_match_on_injected_observations():
    banks = {s: SIDES[s][1].CounterBank(window=6) for s in SIDES}
    for s, (cm, _, _, _, _, _, _) in SIDES.items():
        assert banks[s].sample(cm.CPU_3990X, 0.0) is None     # cold
    for i, (kind, bucket, tiles, wall) in enumerate(OBS):
        got = {}
        for s, (cm, _, itf, _, sched, _, _) in SIDES.items():
            b = banks[s]
            obs = b.observe(kind, bucket, tiles, wall, tokens=bucket,
                            co_runners=i % 3, t=0.1 * i)
            sample = b.sample(cm.CPU_3990X, 0.1 * i)
            pol = sched.VeltairPolicy(cm.CPU_3990X)
            got[s] = [obs, b.slowdown(), b.level(), b.pressure(), b.last,
                      b.observations,
                      None if sample is None else
                      (sample.values, sample.t, sample.truth, sample.source),
                      None if sample is None else
                      pol.level_from_counters(sample)]
        assert same(got["jax"], got["torch"]), i
    assert got["torch"][-2][3] == "measured"


def test_cold_bank_falls_back_to_the_oracle_alike():
    demands = {s: [SIDES[s][2].RunningDemand(tenant=0, bw=0.7, cache=0.9,
                                             ici=0.0, start=0.0, finish=9.0)]
               for s in SIDES}
    got = {}
    for s, (cm, counters, itf, _, _, _, _) in SIDES.items():
        bank = counters.CounterBank()
        rng = np.random.default_rng(4)
        cold = itf.read_counters(cm.CPU_3990X, -1, demands[s], 1.0, rng,
                                 source="measured", bank=bank)
        for wall in (1e-3, 1e-3, 1.6e-3):
            bank.observe("decode", 8, ("t",), wall)
        warm = itf.read_counters(cm.CPU_3990X, -1, demands[s], 1.0, rng,
                                 source="measured", bank=bank)
        got[s] = [(cold.values, cold.truth, cold.source),
                  (warm.values, warm.truth, warm.source)]
        with pytest.raises(ValueError):
            itf.read_counters(cm.CPU_3990X, -1, [], 0.0, rng,
                              source="measured")
        with pytest.raises(ValueError):
            itf.read_counters(cm.CPU_3990X, -1, [], 0.0, rng, source="pmu")
    assert same(got["jax"], got["torch"])
    assert got["torch"][0][2] == "oracle" and got["torch"][1][2] == \
        "measured"


def _inject_walls(engine):
    """Replace the engine's wall-time observations with deterministic
    walls from the quantum's kind, bucket and the order of observations,
    under one tiles key: both engines' banks then see the same stream.
    (The JAX engine on the CPU keys every level alike, its executables
    being shared across levels; the port keys each level's own.)"""
    bank = engine.counter_bank
    observe = bank.observe
    seen = [0]

    def injected(kind, bucket, tiles, wall_s, **kw):
        seen[0] += 1
        base = 1e-3 * bucket * (2.0 if kind == "prefill" else 1.0)
        return observe(kind, bucket, (),
                       base * (1.0 + 0.45 * ((seen[0] * 7) % 5) / 4), **kw)
    bank.observe = injected


def test_measured_serve_matches_reference_on_injected_walls(setup, plans):
    wl_kw = dict(prompt_len=10, prompt_len_spread=8, max_new_tokens=6,
                 seed=5, tiers={"resnet50": "interactive",
                                "googlenet": "batch"})
    runs, traces = {}, {}
    for side, (cm, _, _, _, sched, slo, rt_mod) in SIDES.items():
        eng = _engine(setup, side, batch_slots=2, prefill_chunk_len=4)
        # a build in a quantum drops its observation, and the JAX engine
        # on the CPU shares one executable across levels where the port
        # builds one per level: warm both, so neither builds in the serve
        eng.warmup()
        traces[side] = eng.version_cache.traces
        _inject_walls(eng)
        rt = rt_mod.OnlineRuntime(eng, sched.VeltairPolicy(cm.CPU_3990X),
                                  plans[side], cm.CPU_3990X,
                                  counter_source="measured",
                                  admission=slo.AdmissionController())
        m = rt.serve(rt_mod.Workload.bursty(TENANTS, 700, 24, **wl_kw))
        runs[side] = (rt, m)
    (jr, jm), (tr, tm) = runs["jax"], runs["torch"]
    assert tr.sched_trace == jr.sched_trace
    assert tr.level_trace == jr.level_trace
    assert dict(tr.counter_sources) == dict(jr.counter_sources)
    assert set(tr.counter_sources) == {"oracle", "measured"}
    assert tr.refit_proxy and tm.refit_count == jm.refit_count
    assert same(tm, jm) and same(tr.records, jr.records)
    assert tr.engine.counter_bank.observations == \
        jr.engine.counter_bank.observations > 0
    assert tr.engine.version_cache.traces == traces["torch"]


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
