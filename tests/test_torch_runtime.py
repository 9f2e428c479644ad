"""The port's online runtime against the JAX package's, in virtual time,
on reduced gemma-2b (dense and paged) and reduced mamba2-780m with the
JAX parameters bridged over (``batch_slots=2, max_len=32``, as in
``tests/test_online_runtime.py``).

The same ``Workload`` through ``repro.serving.OnlineRuntime`` on the JAX
engine and ``TorchOnlineRuntime`` on the port's engine, with
``VeltairPolicy`` in the loop, under ``scheduler="slo"`` and ``"fifo"``,
with and without an ``AdmissionController``: identical schedule and level
traces, counter sources, conflict / shed / deferred counts, records and
``ServingMetrics`` (exact; NaN-aware where a metric is NaN by
definition), and the same host syncs and page counters.  The token
streams are the JAX runtime's token for token, except where a stream
parts at a position whose reference logits have their top two within
``CLEAR_MARGIN`` (the port's logits differ from the reference's by a few
bf16 ulps; ``tests/test_torch_model.py``), which the helper checks where
it happens.

Then the reference's runtime properties on the port alone: SLO and FIFO
serve identical tokens through different traces, an interactive prefill
preempts a batch decode, levels respond to load, a bad scheduler name
raises, admission control accounts for every arrival.
"""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.core import cost_model as r_cm  # noqa: E402
from repro.core import scheduler as r_sched  # noqa: E402
from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import runtime as r_rt  # noqa: E402
from repro.serving import slo as r_slo  # noqa: E402
from repro.serving.request import synth_prompts  # noqa: E402
from repro.serving.tenants import build_paper_plans as r_plans  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import cost_model as t_cm  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving import runtime as t_rt  # noqa: E402
from repro_torch.serving import slo as t_slo  # noqa: E402
from repro_torch.serving.tenants import build_paper_plans as t_plans  # noqa: E402
from test_torch_core import same  # noqa: E402

MAX_LEN = 32
TENANTS = ["resnet50", "googlenet"]
TIERS = {"resnet50": "interactive", "googlenet": "batch"}
# twice the largest logit difference measured between the port and the
# reference (tests/test_torch_model.py)
CLEAR_MARGIN = 2e-2
# engine options per case: a short prefill chunk so prompts run several
# chunk quanta; the paged pool is three pages of eight tokens with
# prompt-only reservation, so page commitments defer admissions and free
# pages clamp decode quanta (every request fits two pages, so two rows can
# never both wait on a third: prompt-only reservation deadlocks a pool
# smaller than that, in the reference as in the port)
CASES = {
    "gemma-2b": ("gemma-2b", {"prefill_chunk_len": 4}),
    "gemma-2b-paged": ("gemma-2b", {"prefill_chunk_len": 4, "page_size": 8,
                                    "n_pages": 3,
                                    "page_reserve": "prompt"}),
    "mamba2-780m": ("mamba2-780m", {"prefill_chunk_len": 4}),
}
SCHEDULES = {"slo": ("slo", False), "slo-admission": ("slo", True),
             "fifo": ("fifo", False), "fifo-admission": ("fifo", True)}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in ("gemma-2b", "mamba2-780m"):
        jcfg = jax_reduced_config(name)
        jmodel = build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        tparams = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        out[name] = (jcfg, jmodel, jparams, get_reduced_config(name),
                     tparams)
    return out


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


def _engine(models, side, name, **kw):
    jcfg, _, jparams, tcfg, tparams = models[name]
    kw.setdefault("batch_slots", 2)
    if side == "jax":
        return jax_engine.ServingEngine(jcfg, jparams, max_len=MAX_LEN, **kw)
    return torch_engine.ServingEngine(tcfg, tparams, max_len=MAX_LEN,
                                      device="cpu", **kw)


def _runtime(side, engine, plans, policy=None, **kw):
    cm, sched, rt = ((r_cm, r_sched, r_rt) if side == "jax"
                     else (t_cm, t_sched, t_rt))
    pol = (policy or sched.VeltairPolicy)(cm.CPU_3990X)
    return rt.OnlineRuntime(engine, pol, plans[side], cm.CPU_3990X, **kw)


def _workload(side, **kw):
    rt = r_rt if side == "jax" else t_rt
    return rt.Workload.bursty(TENANTS, 900, 24, burstiness=4.0,
                              prompt_len=10, prompt_len_spread=8,
                              max_new_tokens=6, seed=11, tiers=TIERS, **kw)


def _serve(models, plans, case, schedule):
    """Serve the case's workload on both sides; returns side -> (runtime,
    metrics, workload)."""
    name, engine_kw = CASES[case]
    scheduler, admission = SCHEDULES[schedule]
    out = {}
    for side in ("jax", "torch"):
        slo = r_slo if side == "jax" else t_slo
        rt = _runtime(side, _engine(models, side, name, **engine_kw), plans,
                      scheduler=scheduler,
                      admission=slo.AdmissionController() if admission
                      else None)
        wl = _workload(side)
        out[side] = (rt, rt.serve(wl), wl)
    return out


def parts_only_at_reference_near_ties(models, name, wl, got, want):
    """``got`` (rid -> tokens) equals ``want`` stream by stream, or parts
    at a position where the reference's logits (a prefill of the prompt
    and the agreed tokens) have their top two within CLEAR_MARGIN and
    both streams' tokens among them.  Returns the number of partings."""
    _, jmodel, jparams, _, _ = models[name]
    prompts = synth_prompts(wl.n_queries, wl.prompt_len,
                            models[name][0].vocab_size, wl.seed)
    lens = wl.prompt_lengths()
    assert got.keys() == want.keys()
    parted = 0
    for rid, stream in got.items():
        if stream == want[rid]:
            continue
        parted += 1
        t = next(i for i, (a, b) in enumerate(zip(stream, want[rid]))
                 if a != b)
        toks = np.concatenate([prompts[rid, :lens[rid]],
                               np.asarray(stream[:t], np.int32)])
        logits, _ = jmodel.prefill(jparams,
                                   {"tokens": jnp.asarray(toks)[None]},
                                   jmodel.init_cache(1, MAX_LEN))
        lg = np.sort(np.asarray(logits, np.float32)[0])
        top = np.asarray(logits, np.float32)[0]
        assert lg[-1] - lg[-2] < CLEAR_MARGIN, (rid, t, lg[-2:])
        for tok in (stream[t], want[rid][t]):
            assert top[tok] >= lg[-1] - CLEAR_MARGIN, (rid, t, tok)
    return parted


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_virtual_time_serve_matches_reference(models, plans, case,
                                              schedule):
    runs = _serve(models, plans, case, schedule)
    (jr, jm, jwl), (tr, tm, twl) = runs["jax"], runs["torch"]
    assert jwl.arrivals == twl.arrivals
    assert tr.sched_trace == jr.sched_trace
    assert tr.level_trace == jr.level_trace
    assert dict(tr.counter_sources) == dict(jr.counter_sources)
    for attr in ("conflicts", "shed", "deferred", "steps", "quanta",
                 "prefill_quanta"):
        assert getattr(tr, attr) == getattr(jr, attr), attr
    assert same(tr.records, jr.records)
    assert same(tm, jm)
    je, te = jr.engine, tr.engine
    for attr in ("host_syncs", "tokens_decoded", "prefill_chunks",
                 "prefill_pad_tokens", "level_switches", "peak_cache_tokens",
                 "peak_active_slots", "cache_utilization"):
        assert getattr(te, attr) == getattr(je, attr), attr
    assert te.page_stats == je.page_stats
    assert tm.n_queries + tm.shed_queries == twl.n_queries
    parts_only_at_reference_near_ties(models, CASES[case][0], jwl,
                                      tr.outputs, jr.outputs)
    if case == "gemma-2b-paged":
        assert te.pool.used_pages == 0 and te.pool.committed == 0
    if schedule == "slo-admission":
        assert tm.shed_queries + tm.deferred_queries > 0


def test_the_cases_exercise_what_they_claim(models, plans):
    """The parity cases are not vacuous: more than one level, prefill
    chunks preempting decodes, admission deferrals on a full engine, and
    on the paged engine page-deferred admissions and quanta clamped by
    free pages (counted on the port)."""
    runs = _serve(models, plans, "gemma-2b-paged", "slo-admission")
    tr, tm, _ = runs["torch"]
    assert len({t_cm.level_to_idx(x) for x in tr.level_trace}) > 1
    kinds = [ev[0] for ev in tr.sched_trace]
    assert "prefill" in kinds and "decode" in kinds
    assert tm.deferred_queries > 0

    engine = _engine(models, "torch", "gemma-2b", **CASES["gemma-2b-paged"][1])
    clamps, page_defers = [], []
    headroom = engine.decode_k_headroom

    def clamp(k):
        got = headroom(k)
        clamps.append(got < k)
        return got
    engine.decode_k_headroom = clamp
    adm = t_slo.AdmissionController()
    decide = adm.decide

    def counted(**kw):
        d = decide(**kw)
        page_defers.append(d == "defer" and kw["slot_free"]
                           and kw["pages_needed"] > kw["pages_free"])
        return d
    adm.decide = counted
    rt = _runtime("torch", engine, plans, admission=adm)
    rt.serve(_workload("torch"))
    assert any(clamps) and any(page_defers)
    assert rt.sched_trace == tr.sched_trace


# ---------------------------------------------------------------------------
# the reference's runtime properties, on the port


def test_slo_and_fifo_schedules_are_token_identical(models, plans):
    wl = t_rt.Workload.bursty(TENANTS, 400, 16, prompt_len=6,
                              max_new_tokens=3, seed=6, prompt_len_spread=3,
                              tiers=TIERS)
    rts = {s: _runtime("torch", _engine(models, "torch", "gemma-2b"),
                       plans, scheduler=s) for s in ("slo", "fifo")}
    ms = {s: rt.serve(wl) for s, rt in rts.items()}
    assert ms["slo"].n_queries == ms["fifo"].n_queries == wl.n_queries
    assert rts["slo"].outputs == rts["fifo"].outputs
    assert rts["slo"].sched_trace != rts["fifo"].sched_trace


def test_interactive_prefill_preempts_batch_decode(models, plans):
    wl = t_rt.Workload([(0.0, "googlenet"), (0.004, "resnet50")],
                       prompt_len=12, max_new_tokens=8, tiers=TIERS)
    rt = _runtime("torch", _engine(models, "torch", "gemma-2b",
                                   prefill_chunk_len=4), plans,
                  policy=lambda hw: t_sched.FixedBlockPolicy(hw, 1))
    rt.serve(wl)
    after = [ev for ev in rt.sched_trace if ev[-1] >= 0.004]
    assert after and after[0][0] == "prefill" and \
        after[0][2] == "interactive", after[:5]
    assert any(ev[0] == "decode" for ev in rt.sched_trace)


def test_runtime_levels_respond_to_load(models, plans):
    wl = t_rt.Workload.poisson(TENANTS, 200, 10, prompt_len=4,
                               max_new_tokens=3, seed=3)
    engine = _engine(models, "torch", "gemma-2b")
    rt = _runtime("torch", engine, plans)
    rt.serve(wl)
    assert len({t_cm.level_to_idx(x) for x in rt.level_trace}) > 1
    assert engine.level_switches >= 1


def test_bad_scheduler_or_counter_source_rejected(models, plans):
    engine = _engine(models, "torch", "gemma-2b")
    with pytest.raises(ValueError):
        _runtime("torch", engine, plans, scheduler="lifo")
    with pytest.raises(ValueError):
        _runtime("torch", engine, plans, counter_source="pmu")


def test_admission_control_accounts_for_every_arrival(models, plans):
    wl = t_rt.Workload([(i * 1e-4, "resnet50") for i in range(12)],
                       prompt_len=8, max_new_tokens=4,
                       tiers={"resnet50": "interactive"})
    rt = _runtime("torch", _engine(models, "torch", "gemma-2b",
                                   batch_slots=1), plans,
                  admission=t_slo.AdmissionController())
    m = rt.serve(wl)
    assert m.shed_queries == rt.shed > 0
    assert m.deferred_queries == rt.deferred > 0
    assert m.n_queries + m.shed_queries == wl.n_queries
    assert len(rt.records) == m.n_queries
    # per tier and per quantum kind, the record layout the reference emits
    assert set(m.per_tier) == {"interactive"}
    kinds = collections.Counter(k for k, *_ in rt.quantum_log)
    assert kinds["decode"] == rt.quanta
    assert kinds["prefill"] == rt.prefill_quanta


def test_simulator_replays_the_same_workload(models, plans):
    wl = t_rt.Workload.poisson(TENANTS, 60, 10, prompt_len=4,
                               max_new_tokens=3, seed=2)
    rt = _runtime("torch", _engine(models, "torch", "gemma-2b"), plans)
    m_eng = rt.serve(wl)
    m_sim = t_rt.replay_through_simulator(
        wl, t_cm.CPU_3990X, plans["torch"],
        t_sched.VeltairPolicy(t_cm.CPU_3990X))
    assert m_eng.n_queries == m_sim.n_queries == wl.n_queries
    ref = r_rt.replay_through_simulator(
        r_rt.Workload.poisson(TENANTS, 60, 10, prompt_len=4,
                              max_new_tokens=3, seed=2),
        r_cm.CPU_3990X, plans["jax"], r_sched.VeltairPolicy(r_cm.CPU_3990X))
    assert same(m_sim, ref)
    assert dataclasses.asdict(m_eng).keys() == dataclasses.asdict(
        m_sim).keys()


def test_workload_constructors_match_reference():
    for kind, args, kw in (
            ("poisson", (TENANTS, 300, 20), {"prompt_len_spread": 5}),
            ("bursty", (TENANTS, 300, 20), {"tiers": TIERS}),
            ("diurnal", (TENANTS, 300, 20), {"floor": 0.4,
                                             "shared_prefix_len": 3})):
        a = getattr(r_rt.Workload, kind)(*args, seed=4, prompt_len=9, **kw)
        b = getattr(t_rt.Workload, kind)(*args, seed=4, prompt_len=9, **kw)
        assert same(a, b)
        assert a.prompt_lengths() == b.prompt_lengths()
        assert a.qps == b.qps and a.n_queries == b.n_queries
        assert [a.tier_of(n) for n in TENANTS] == \
            [b.tier_of(n) for n in TENANTS]
    arr = [(0.3, "googlenet"), (0.1, "resnet50")]
    assert same(r_rt.Workload.replay(arr, prompt_len=5),
                t_rt.Workload.replay(arr, prompt_len=5))
