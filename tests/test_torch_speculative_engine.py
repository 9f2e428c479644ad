"""The port's speculative engine against its plain engine and the JAX
package's speculative engine on the CPU (reduced gemma-2b, dense and
paged with pages of 8 and 24 pages, and reduced mamba2-780m; the JAX
parameters bridged over; ``batch_slots`` 2, ``MAX_LEN`` 64; the
scenarios of ``tests/test_speculative_decode.py``).

  * staggered admissions, mixed prompt lengths, mid-quantum completions
    and level switches at quantum boundaries: the speculative streams
    equal the port's plain streams token for token, and speculation ran
    (spec quanta, drafts; acceptance and rollback on gemma-2b);
  * the same serve at one level against the JAX speculative engine on
    gemma-2b (built and served once per module; one level, so the JAX
    engine compiles one version): the same streams, ``spec_stats``, host
    syncs and decoded tokens; the paged engine is held to the dense one
    on the port, mamba2's verify to the reference's at the model level;
  * the rollback-only stream (``spec_ngram=1, spec_depth=3``);
  * the paged engine's preflight of the d+1 write span, and an empty pool
    after;
  * ``spec_recurrent=False`` turns speculation off for mamba2 only;
  * counter consistency, and one host sync per speculative quantum;
  * no build and no miss after ``warmup()``, with ``ReplayOnCPU``
    standing in for CUDA graphs, and spec replays adding the launches
    their capture recorded.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.kernels import block_matmul as bm  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from test_torch_graphs import ReplayOnCPU  # noqa: E402
from test_torch_core import shared_executables  # noqa: E402

MAX_LEN = 64
# twice the largest logit difference measured between the port and the
# reference (tests/test_torch_model.py)
CLEAR_MARGIN = 2e-2
PAGED = {"page_size": 8, "n_pages": 24}
CASES = {"gemma-2b": ("gemma-2b", {}),
         "gemma-2b-paged": ("gemma-2b", PAGED),
         "mamba2-780m": ("mamba2-780m", {})}
LEVELS = (0.0, 1.0, 0.3)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in ("gemma-2b", "mamba2-780m"):
        jcfg = jax_reduced_config(name)
        jmodel = build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        tparams = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
                   for n in (10, 7, 4)]
        out[name] = (jcfg, jmodel, jparams, get_reduced_config(name),
                     tparams, prompts)
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: as fast
    alone, and the test runner's workers share the cores (idle pool
    threads of a multi-threaded process spin on them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_dispatch():
    yield
    dispatch.clear_tile_overrides()
    dispatch.install_ladder(None)


def _engine(models, side, case, **kw):
    arch, engine_kw = CASES[case]
    jcfg, _, jparams, tcfg, tparams, _ = models[arch]
    kw = {**engine_kw, **kw}
    if side == "jax":
        return jax_engine.ServingEngine(jcfg, jparams, batch_slots=2,
                                        max_len=MAX_LEN, **kw)
    return torch_engine.ServingEngine(tcfg, tparams, batch_slots=2,
                                      max_len=MAX_LEN, device="cpu", **kw)


def _serve(models, side, case, *, n_new=(40, 36, 20), k=4, levels=LEVELS,
           engine=None, **kw):
    """The reference test's schedule: an admission (drained) every third
    iteration, a level per quantum, ``k``-step quanta until every request
    is done."""
    arch = CASES[case][0]
    prompts = models[arch][5]
    eng = engine if engine is not None else _engine(models, side, case, **kw)
    mod = jax_engine if side == "jax" else torch_engine
    reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    pending = list(reqs)
    for i in range(400):
        if all(r.done for r in reqs):
            break
        if pending and i % 3 == 0 and eng.admit_request(pending[0],
                                                        drain=True):
            pending.pop(0)
        if levels:
            eng.set_interference_level(levels[i % len(levels)])
        eng.step_quantum(k)
    assert all(r.done for r in reqs), "the schedule drains every request"
    return eng, [list(r.output) for r in reqs]


@pytest.fixture(scope="module")
def runs(models):
    """Per case: the port's plain and speculative serves with level
    switches, and the port's and the JAX package's speculative serves at
    one level (each JAX engine built once here)."""
    out = {}
    for case in CASES:
        out[case] = {("torch", spec): _serve(models, "torch", case,
                                             speculative=spec)
                     for spec in (False, True)}
        for side in ("torch", "jax"):
            if side == "jax" and case != "gemma-2b":
                continue          # see test_spec_streams_match_jax
            out[case][side, "one level"] = _serve(
                models, side, case, speculative=True, levels=())
    return out


def parts_only_at_reference_near_ties(models, arch, got, want):
    """``got`` equals ``want`` stream by stream, or parts where the
    reference's logits (a prefill of the prompt and the agreed tokens)
    have their top two within CLEAR_MARGIN and both tokens among them.
    Returns the number of partings."""
    _, jmodel, jparams, _, _, prompts = models[arch]
    parted = 0
    for rid, (stream, ref) in enumerate(zip(got, want)):
        if stream == ref:
            continue
        parted += 1
        t = next(i for i, (a, b) in enumerate(zip(stream, ref)) if a != b)
        toks = np.concatenate([prompts[rid], np.asarray(stream[:t],
                                                        np.int32)])
        logits, _ = jmodel.prefill(jparams,
                                   {"tokens": jnp.asarray(toks)[None]},
                                   jmodel.init_cache(1, MAX_LEN))
        top = np.asarray(logits, np.float32)[0]
        srt = np.sort(top)
        assert srt[-1] - srt[-2] < CLEAR_MARGIN, (rid, t, srt[-2:])
        for tok in (stream[t], ref[t]):
            assert top[tok] >= srt[-1] - CLEAR_MARGIN, (rid, t, tok)
    return parted


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_streams_equal_plain_streams(runs, case):
    (plain, want), (eng, got) = runs[case]["torch", False], \
        runs[case]["torch", True]
    assert got == want
    assert eng.spec_quanta > 0 and eng.tokens_drafted > 0
    assert plain.spec_quanta == 0 and plain.spec_stats["tokens_drafted"] == 0
    if CASES[case][0] == "gemma-2b":
        # both the acceptance and the rollback path ran
        assert eng.tokens_accepted > 0 and eng.spec_rollbacks > 0


def test_spec_streams_match_jax(models, runs):
    """gemma-2b: the port's speculative streams are the JAX engine's (no
    parting; the helper would accept one only at a reference near-tie)
    with equal counters.  The paged engine is held to the dense one on
    the port (``test_paged_preflight_and_empty_pool``); mamba2's verify
    to the reference's at the model level
    (``tests/test_torch_speculative.py``), since its random reduced
    weights sit on near-ties in this schedule's streams."""
    te, got = runs["gemma-2b"]["torch", "one level"]
    je, want = runs["gemma-2b"]["jax", "one level"]
    assert parts_only_at_reference_near_ties(models, "gemma-2b", got,
                                             want) == 0
    assert te.spec_stats == je.spec_stats
    for attr in ("host_syncs", "tokens_decoded", "quantum_calls",
                 "prefill_chunks"):
        assert getattr(te, attr) == getattr(je, attr), attr
    assert te.expected_accept_per_step() == pytest.approx(
        je.expected_accept_per_step(), rel=1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rollback_only_stream_is_exact(models, runs, case):
    """Unigram drafts of depth 3 are mostly rejected: the rollback path
    (one corrected token, the rest rewound) carries the stream."""
    want = runs[case]["torch", False][1]
    eng, got = _serve(models, "torch", case, speculative=True, spec_ngram=1,
                      spec_depth=3)
    assert got == want
    assert eng.spec_quanta > 0 and eng.spec_rollbacks > 0


def test_paged_preflight_and_empty_pool(runs):
    """The paged engine preflights the d+1 write span of every row and
    emits no token whose KV would sit on the trash page: its streams equal
    the dense engine's, and every page is back in the pool after."""
    eng, got = runs["gemma-2b-paged"]["torch", True]
    assert got == runs["gemma-2b"]["torch", True][1]
    one, one_dense = (runs[c]["torch", "one level"]
                      for c in ("gemma-2b-paged", "gemma-2b"))
    assert one[1] == one_dense[1]
    assert one[0].spec_stats == one_dense[0].spec_stats
    assert eng.spec_quanta > 0
    assert eng.pool.used_pages == 0 and eng.pool.committed == 0


def test_small_pool_degrades_to_fallbacks(models, runs):
    """Five pages for two slots of up to eight pages each: the verify's
    span often cannot be mapped, so the engine falls back to plain quanta
    (or stalls a row), never to other tokens."""
    eng, got = _serve(models, "torch", "gemma-2b-paged", speculative=True,
                      n_pages=5, page_reserve="prompt", n_new=(12, 10, 8))
    _, want = _serve(models, "torch", "gemma-2b", speculative=False,
                     n_new=(12, 10, 8))
    assert got == want
    assert eng.spec_fallbacks > 0
    assert eng.pool.used_pages == 0 and eng.pool.committed == 0


@pytest.mark.parametrize("case", ("gemma-2b", "mamba2-780m"))
def test_spec_recurrent_opt_out(models, runs, case):
    eng, got = _serve(models, "torch", case, speculative=True,
                      spec_recurrent=False)
    assert got == runs[case]["torch", False][1]
    if case == "mamba2-780m":
        assert eng.model._has_nonseq_cache_leaves()
        assert not eng._spec_enabled and eng.spec_quanta == 0
        assert eng.expected_accept_per_step() == 1.0
    else:
        assert not eng.model._has_nonseq_cache_leaves()
        assert eng._spec_enabled and eng.spec_quanta > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_counters_are_consistent(runs, case):
    eng, _ = runs[case]["torch", True]
    s = eng.spec_stats
    assert 0 <= s["tokens_accepted"] <= s["tokens_drafted"]
    assert s["draft_hit_rate"] == pytest.approx(
        s["tokens_accepted"] / max(s["tokens_drafted"], 1))
    assert s["spec_quanta"] > 0
    assert eng.expected_accept_per_step() >= 1.0
    assert eng.draft_hit_rate == s["draft_hit_rate"]
    # every decode dispatch is a spec quantum or a plain fused quantum
    assert eng.quantum_calls >= s["spec_quanta"]
    kinds = {obs.kind for obs in eng.counter_bank._recent}
    assert "spec" in kinds


def test_one_host_sync_per_spec_quantum(models):
    """A spec quantum's block, emission and acceptance come back in ONE
    device->host copy of one packed (d+3, B) tensor."""
    eng = _engine(models, "torch", "gemma-2b", speculative=True)
    eng.admit_request(torch_engine.Request(
        rid=0, prompt=models["gemma-2b"][5][0], max_new_tokens=40),
        drain=True)
    cpu = torch.Tensor.cpu
    calls = []

    def counted(t, *a, **kw):
        calls.append(tuple(t.shape))
        return cpu(t, *a, **kw)
    for _ in range(40):
        syncs, calls[:] = eng.host_syncs, []
        torch.Tensor.cpu = counted
        try:
            handle = eng.begin_quantum(8)
            eng.finish_quantum(handle)
        finally:
            torch.Tensor.cpu = cpu
        assert eng.host_syncs == syncs + 1
        if handle.kind == "spec":
            break
    assert handle.kind == "spec" and handle.drafted == eng.spec_depth
    assert calls == [(eng.spec_depth + 3, eng.slots)]
    assert handle.n_left[0] >= 1 and handle.n_left[1] == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_build_after_warmup_and_replays_count_launches(models, case,
                                                          monkeypatch):
    """warmup() builds every reachable (K-bucket, depth) verify beside the
    quanta: a level-sweeping speculative serve afterwards builds nothing
    and misses nothing, and each spec replay adds the B1 launches its
    capture recorded (on the CPU, B1 calls through ``ops.block_matmul``
    are counted here as the kernel's wrapper counts them on the card)."""
    real_mm = ops.block_matmul

    def counting_mm(x, w, **kw):
        bm.LAUNCHES[("counted",)] += 1
        return real_mm(x, w, **kw)
    monkeypatch.setattr(ops, "block_matmul", counting_mm)
    before = dict(bm.LAUNCHES)
    try:
        eng = _engine(models, "torch", case, speculative=True)
        eng.version_cache.graphs = ReplayOnCPU()
        eng.warmup(levels=[cm.grid_point(i) for i in (0, 5, 9)])
        for entry in eng.version_cache._entries.values():
            assert sorted(entry.spec) == [(1, 4), (2, 4), (4, 4), (8, 4)]
        vc = eng.version_cache
        traces, misses = vc.traces, vc.misses
        spec_calls = [c for key, c in vc._calls.items() if key[1] == "spec"]
        assert all(c.graph is not None for c in spec_calls)
        bm.LAUNCHES.clear()
        replays = 0
        arch = CASES[case][0]
        for i, p in enumerate(models[arch][5][:2]):
            eng.admit_request(torch_engine.Request(rid=i, prompt=p,
                                                   max_new_tokens=30),
                              drain=True)
        i = 0
        while eng.active_slots:
            eng.set_interference_level(cm.grid_point((0, 5, 9)[i % 3]))
            spec0 = sum(c.replays for c in spec_calls)
            launches0 = sum(bm.LAUNCHES.values())
            handle = eng.begin_quantum(4)
            eng.finish_quantum(handle)
            added = sum(bm.LAUNCHES.values()) - launches0
            if handle is not None and handle.kind == "spec":
                assert sum(c.replays for c in spec_calls) == spec0 + 1
                replays += 1
                per_pass = 3 * eng.cfg.num_layers if arch == "gemma-2b" \
                    else 0
                assert added == per_pass
            i += 1
            assert i < 400
        assert vc.traces == traces and vc.misses == misses
        assert replays > 0 and replays == eng.spec_quanta
    finally:
        bm.LAUNCHES.clear()
        bm.LAUNCHES.update(before)


@pytest.fixture(scope="module", autouse=True)
def _shared_executables():
    """The JAX engines of this module share their compiled executables
    (``test_torch_core.SharedXla``): each case builds new engines, which
    would compile the same modules again."""
    yield from shared_executables()
