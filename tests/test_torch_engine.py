"""The port's serving engine against the JAX engine on the CPU (reduced
gemma-2b and reduced mamba2-780m, the JAX parameters bridged over).

Both engines serve the same schedules; the port must emit identical
greedy tokens with the same number of host syncs.  Logits differ between
the two by a few bf16 ulps (``tests/test_torch_model.py`` measures it),
so token identity holds as long as no top-2 logit margin falls below
that — a token that differs only at such a measured near-tie is a
finding for ROADMAP queue C, not a port fault.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving.engine import H100_LEVEL_TILES  # noqa: E402
from test_torch_model import MAMBA_STREAM_LEN, mamba_prompt  # noqa: E402
from test_torch_core import shared_executables  # noqa: E402

PROMPT_LENS = (3, 7, 5)          # deliberately misaligned
N_NEW = 4
MAX_LEN = 32


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced_config("gemma-2b")
    jparams = build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    sides = {"jax": (jax_engine, jcfg, jparams, {}),
             "torch": (torch_engine, get_reduced_config("gemma-2b"), tparams,
                       {"device": "cpu"})}
    return sides, prompts


@pytest.fixture(autouse=True)
def _clean_dispatch():
    yield
    for mod in (dispatch, jax_dispatch):
        mod.clear_tile_overrides()
        mod.install_ladder(None)


def _engine(side, **kw):
    mod, cfg, params, extra = side
    return mod.ServingEngine(cfg, params, max_len=MAX_LEN, **extra, **kw)


def _staggered_run(side, prompts):
    """The ``tests/test_engine_batching.py`` schedule: admissions at
    different steps into a 2-slot engine, a slot reused by the third."""
    mod = side[0]
    engine = _engine(side, batch_slots=2)
    reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=N_NEW)
            for i, p in enumerate(prompts)]
    assert engine.admit_request(reqs[0], drain=True)
    engine.step()
    assert engine.admit_request(reqs[1], drain=True)
    engine.step()
    engine.step()
    engine.run_to_completion([reqs[2]])
    assert all(r.done for r in reqs)
    return engine, reqs


def test_staggered_batching_token_identical_to_jax_engine(setup):
    sides, prompts = setup
    (je, jreqs), (te, treqs) = (_staggered_run(sides[s], prompts)
                                for s in ("jax", "torch"))
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert te.host_syncs == je.host_syncs
    assert te.tokens_decoded == je.tokens_decoded
    assert te.prefill_chunks == je.prefill_chunks
    assert te.prefill_pad_tokens == je.prefill_pad_tokens


# (quantum, level, admit_next): the ``tests/test_quantum_decode.py``
# schedule, rows completing mid-quantum
SCHEDULE = [(2, 0.0, True), (3, 1.0, True), (4, 0.3, False),
            (2, 1.0, True), (4, 0.0, False), (8, 0.6, False),
            (8, 0.6, False), (8, 0.0, False)]
MAX_NEW = (6, 3, 5)


@pytest.mark.parametrize("fused", [True, False])
def test_quantum_schedule_token_identical_to_jax_engine(setup, fused):
    sides, prompts = setup
    runs = {}
    for name, side in sides.items():
        mod = side[0]
        engine = _engine(side, batch_slots=2, quantum_buckets=(2, 4))
        reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, MAX_NEW))]
        pending = list(reqs)
        for k, level, admit in SCHEDULE:
            if admit and pending and engine.admit_request(pending[0],
                                                          drain=True):
                pending.pop(0)
            engine.set_interference_level(level)
            if fused:
                engine.step_quantum(k)
            else:
                for _ in range(k):
                    engine.step()
        assert all(r.done for r in reqs)
        runs[name] = (engine, [r.output for r in reqs])
    assert runs["torch"][1] == runs["jax"][1]
    je, te = runs["jax"][0], runs["torch"][0]
    assert te.host_syncs == je.host_syncs
    assert te.quantum_calls == je.quantum_calls
    assert te.tokens_per_sync == je.tokens_per_sync
    assert te.level_switches == je.level_switches


def test_slot_reuse_cannot_leak_previous_request(setup):
    sides, _ = setup
    rng = np.random.default_rng(11)
    long_p = rng.integers(0, 256, 9).astype(np.int32)
    short_p = rng.integers(0, 256, 2).astype(np.int32)
    solo = _engine(sides["torch"], batch_slots=1)
    want = torch_engine.Request(rid=0, prompt=short_p, max_new_tokens=N_NEW)
    solo.run_to_completion([want])
    engine = _engine(sides["torch"], batch_slots=1)
    engine.run_to_completion([torch_engine.Request(
        rid=0, prompt=long_p, max_new_tokens=N_NEW)])
    req = torch_engine.Request(rid=1, prompt=short_p, max_new_tokens=N_NEW)
    engine.run_to_completion([req])
    assert req.output == want.output


def test_full_level_sweep_after_warmup_builds_nothing(setup):
    sides, prompts = setup
    engine = _engine(sides["torch"], batch_slots=2)
    stats = engine.warmup(prompt_lens=tuple(len(p) for p in prompts))
    vc = engine.version_cache
    assert stats["entries"] == len({str(t) for t in H100_LEVEL_TILES}) + 1
    traces0, misses0 = vc.traces, vc.misses
    switches0 = engine.level_switches
    engine.admit_request(torch_engine.Request(
        rid=0, prompt=prompts[0], max_new_tokens=64), drain=True)
    for i in range(cm.NUM_LEVELS):
        engine.set_interference_level(cm.grid_point(i))
        engine.step()
        engine.step_quantum(4)
    for i in range(4):
        engine.set_interference_level(float(i % 2))
        engine.step_quantum(2)
    assert engine.level_switches > switches0
    assert vc.misses == misses0, "every switch must be a cache hit"
    assert vc.traces == traces0, "no new builds after warmup"


def test_level_tiles_reach_the_kernel_wrappers(setup, monkeypatch):
    """The tiles of the selected level are what every MLP GEMM and
    attention call of the entry passes to the kernel wrappers."""
    sides, prompts = setup
    seen = []
    real_mm, real_fa = ops.block_matmul, ops.flash_attention
    monkeypatch.setattr(ops, "block_matmul", lambda x, w, **kw: (
        seen.append(("matmul", kw)), real_mm(x, w, **kw))[1])
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: (
        seen.append(("attention", {k: kw[k] for k in ("bq", "bkv")
                                   if k in kw})),
        real_fa(*a, **kw))[1])
    engine = _engine(sides["torch"], batch_slots=2)
    engine.admit_request(torch_engine.Request(
        rid=0, prompt=prompts[1], max_new_tokens=8), drain=True)
    for idx in (0, 5, 9):
        seen.clear()
        engine.set_interference_level(cm.grid_point(idx))
        engine.step_quantum(2)
        want = H100_LEVEL_TILES[idx]
        assert seen and all(kw == want[op] for op, kw in seen)
        assert dispatch.all_tile_overrides() == want


def test_prompt_outside_vocab_or_length_is_refused(setup):
    sides, _ = setup
    engine = _engine(sides["torch"], batch_slots=1)
    for bad in (np.array([1, 256], np.int32), np.array([], np.int32),
                np.arange(MAX_LEN, dtype=np.int32) % 7):
        with pytest.raises(ValueError):
            engine.admit_request(torch_engine.Request(rid=0, prompt=bad))
    assert engine.rejected_invalid == 3


# ---------------------------------------------------------------------------
# the ssm family: reduced mamba2-780m
# ---------------------------------------------------------------------------
# The port's logits differ from the reference's by 1-2 bf16 ulps
# (``tests/test_torch_model.py``), so the prompts are those whose reference
# streams stay clear of near-ties there (``mamba_prompt``): every request
# must give the reference's tokens, and everything the scheduler decides
# (host syncs, chunks, padding, tokens decoded) must be equal.
MAMBA_PROMPT_LENS = (3, 7, 5, 17, 13)       # 17: a 1-token tail chunk


@pytest.fixture(scope="module")
def mamba_setup():
    jcfg = jax_reduced_config("mamba2-780m")
    jparams = build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    tcfg = get_reduced_config("mamba2-780m")
    prompts = [mamba_prompt(n) for n in MAMBA_PROMPT_LENS]
    assert max(MAX_NEW + (N_NEW,)) <= MAMBA_STREAM_LEN
    sides = {"jax": (jax_engine, jcfg, jparams, {}),
             "torch": (torch_engine, tcfg, tparams, {"device": "cpu"})}
    return sides, prompts


def test_mamba2_staggered_batching_matches_jax_engine(mamba_setup):
    sides, prompts = mamba_setup
    (je, jreqs), (te, treqs) = (_staggered_run(sides[s], prompts[:3])
                                for s in ("jax", "torch"))
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert te.host_syncs == je.host_syncs
    assert te.tokens_decoded == je.tokens_decoded
    assert te.prefill_chunks == je.prefill_chunks
    assert te.prefill_pad_tokens == je.prefill_pad_tokens


def test_mamba2_quantum_schedule_matches_jax_engine(mamba_setup):
    sides, prompts = mamba_setup
    runs = {}
    for name, side in sides.items():
        mod = side[0]
        engine = _engine(side, batch_slots=2, quantum_buckets=(2, 4))
        reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts[2:], MAX_NEW))]
        pending = list(reqs)
        for k, level, admit in SCHEDULE:
            if admit and pending and engine.admit_request(pending[0],
                                                          drain=True):
                pending.pop(0)
            engine.set_interference_level(level)
            engine.step_quantum(k)
        assert all(r.done for r in reqs)
        runs[name] = (engine, reqs)
    (je, jreqs), (te, treqs) = runs["jax"], runs["torch"]
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert te.host_syncs == je.host_syncs
    assert te.quantum_calls == je.quantum_calls
    assert te.tokens_per_sync == je.tokens_per_sync
    assert te.level_switches == je.level_switches
    assert te.prefill_chunks == je.prefill_chunks


def test_mamba2_chunked_prefill_equals_monolithic(mamba_setup):
    """``tests/test_prefill_chunking.py``'s identity on the port: chunked,
    padded admission (8-token chunks) gives the tokens of monolithic
    admission under staggered admissions and mixed lengths."""
    sides, prompts = mamba_setup
    side = sides["torch"]
    mono = _engine(side, batch_slots=2, chunked_prefill=False)
    reqs_m = _staggered_reqs(mono, prompts)
    chunk = _engine(side, batch_slots=2, prefill_chunk_len=8)
    reqs_c = _staggered_reqs(chunk, prompts)
    assert [r.output for r in reqs_c] == [r.output for r in reqs_m]
    assert chunk.prefill_chunks > len(prompts)
    assert chunk.prefill_pad_tokens > 0
    assert chunk.prefill_tokens == sum(MAMBA_PROMPT_LENS)


def _staggered_reqs(engine, prompts):
    reqs = [torch_engine.Request(rid=i, prompt=p, max_new_tokens=N_NEW)
            for i, p in enumerate(prompts)]
    pending = list(reqs)
    assert engine.admit_request(pending.pop(0), drain=True)
    engine.step()
    assert engine.admit_request(pending.pop(0), drain=True)
    engine.step()
    engine.step()
    engine.run_to_completion(pending)
    assert all(r.done for r in reqs)
    return reqs


def test_mamba2_warmup_builds_everything_the_serve_uses(mamba_setup):
    """Warmup builds the chunk buckets, the fused quanta and the
    monolithic prefill of each listed length; a level sweep afterwards
    builds nothing (the level table has no "ssd" entry, so a switch
    changes no kernel on this path)."""
    sides, prompts = mamba_setup
    engine = _engine(sides["torch"], batch_slots=2, chunked_prefill=False)
    engine.warmup(prompt_lens=tuple(len(p) for p in prompts))
    vc = engine.version_cache
    traces0 = vc.traces
    reqs = [torch_engine.Request(rid=i, prompt=p, max_new_tokens=N_NEW)
            for i, p in enumerate(prompts)]
    pending = list(reqs)
    for i in range(3 * cm.NUM_LEVELS):
        while pending and engine.admit_request(pending[0]):
            pending.pop(0)
        engine.set_interference_level(cm.grid_point(i % cm.NUM_LEVELS))
        engine.step_quantum(4)
    engine.run_to_completion(pending)
    assert all(r.done for r in reqs)
    assert vc.traces == traces0, "no new builds after warmup"
    assert all("ssd" not in t for t in H100_LEVEL_TILES)


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
