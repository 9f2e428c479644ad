"""The port's serving engine on the hybrid family against its own
monolithic and plain serves and the JAX package's engine on the CPU
(reduced recurrentgemma-2b: one (rec, rec, attn) group, window 32; the
JAX parameters bridged over; ``batch_slots`` 2, ``MAX_LEN`` 64; a
40-token prompt wraps the ring).

  * chunked prefill (16-token chunks, padded buckets) equals monolithic
    prefill stream for stream, with staggered admissions, mid-quantum
    completions and level switches;
  * the same serve against the JAX engine's streams, parting only at a
    reference near-tie (two tokens within ``CLEAR_MARGIN`` at the top);
  * the speculative engine (depth 4) equals the port's plain streams, ran
    verifies with acceptances and rollbacks, and at one level gives the
    JAX speculative engine's streams and ``spec_stats``;
    ``spec_recurrent=False`` turns speculation off;
  * a paged engine on the hybrid raises ``ValueError`` in both packages:
    the ring and the RG-LRU state have no ``"seq"`` axis, so nothing
    pages;
  * no build and no miss after ``warmup()``, with ``ReplayOnCPU``
    standing in for CUDA graphs; each replay adds the launches its
    capture recorded: ``block_matmul`` 3 per layer per decode step and
    chunk, twice that per verify, ``flash_attention`` only in a
    monolithic prefill (once per attention layer);
  * the warm decodes write position 0 of every slot; an admission after
    them leaves the slot's cache bit for bit as on an engine never
    warmed, with no stale ring entry.
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
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models.model import cache_batch_axis  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from test_torch_graphs import ReplayOnCPU  # noqa: E402
from test_torch_core import shared_executables  # noqa: E402

ARCH = "recurrentgemma-2b"
MAX_LEN = 64
CLEAR_MARGIN = 2e-2
PROMPT_LENS = (40, 7, 19)
N_NEW = (20, 30, 16)
LEVELS = (0.0, 1.0, 0.3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: as fast
    alone, and the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_dispatch():
    yield
    dispatch.clear_tile_overrides()
    dispatch.install_ladder(None)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduced_config(ARCH)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    return jcfg, jmodel, jparams, get_reduced_config(ARCH), tparams, prompts


def _engine(models, side, **kw):
    jcfg, _, jparams, tcfg, tparams, _ = models
    if side == "jax":
        return jax_engine.ServingEngine(jcfg, jparams, batch_slots=2,
                                        max_len=MAX_LEN, **kw)
    return torch_engine.ServingEngine(tcfg, tparams, batch_slots=2,
                                      max_len=MAX_LEN, device="cpu", **kw)


def _serve(models, side, *, k=4, levels=LEVELS, engine=None, **kw):
    """An admission (drained) every third iteration, a level per
    quantum, ``k``-step quanta until every request is done."""
    eng = engine if engine is not None else _engine(models, side, **kw)
    mod = jax_engine if side == "jax" else torch_engine
    reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(models[5], N_NEW))]
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
    """The port's chunked, monolithic and speculative serves with level
    switches; the port's and the JAX package's speculative serves at one
    level (the JAX engines built once here)."""
    out = {"chunked": _serve(models, "torch"),
           "monolithic": _serve(models, "torch", chunked_prefill=False),
           "spec": _serve(models, "torch", speculative=True),
           "jax": _serve(models, "jax")}
    for side in ("torch", "jax"):
        out[side, "spec one level"] = _serve(models, side, speculative=True,
                                             levels=())
    return out


def parts_only_at_reference_near_ties(models, got, want):
    """``got`` equals ``want`` stream by stream, or parts where the
    reference's logits (a prefill of the prompt and the agreed tokens)
    have their top two within CLEAR_MARGIN and both tokens among them.
    Returns the number of partings."""
    _, jmodel, jparams, _, _, prompts = models
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


def test_chunked_equals_monolithic(runs):
    (chunk, got), (mono, want) = runs["chunked"], runs["monolithic"]
    assert got == want
    assert chunk.prefill_chunks > len(PROMPT_LENS)    # 40 and 19 split
    assert chunk.prefill_pad_tokens > 0
    assert mono.prefill_chunks == 0
    assert chunk.prefill_tokens == mono.prefill_tokens == sum(PROMPT_LENS)
    assert chunk.level_switches > 0


def test_streams_match_jax(models, runs):
    (te, got), (je, want) = runs["chunked"], runs["jax"]
    parts_only_at_reference_near_ties(models, got, want)
    for attr in ("host_syncs", "tokens_decoded", "prefill_chunks",
                 "prefill_tokens", "prefill_pad_tokens"):
        assert getattr(te, attr) == getattr(je, attr), attr


def test_spec_streams_equal_plain_streams(runs):
    (plain, want), (eng, got) = runs["chunked"], runs["spec"]
    assert got == want
    assert eng.spec_quanta > 0 and eng.tokens_drafted > 0
    assert eng.tokens_accepted > 0 and eng.spec_rollbacks > 0
    assert plain.spec_quanta == 0


def test_spec_matches_jax_spec_engine(models, runs):
    (te, got), (je, want) = runs["torch", "spec one level"], \
        runs["jax", "spec one level"]
    assert parts_only_at_reference_near_ties(models, got, want) == 0
    assert te.spec_stats == je.spec_stats
    for attr in ("host_syncs", "tokens_decoded", "quantum_calls",
                 "prefill_chunks"):
        assert getattr(te, attr) == getattr(je, attr), attr


def test_spec_recurrent_opt_out(models, runs):
    eng, got = _serve(models, "torch", speculative=True,
                      spec_recurrent=False)
    assert got == runs["chunked"][1]
    assert eng.model.has_recurrent_leaves()
    assert not eng._spec_enabled and eng.spec_quanta == 0


@pytest.mark.parametrize("side", ["torch", "jax"])
def test_paged_engine_refuses_the_hybrid(models, side):
    with pytest.raises(ValueError, match="pageable"):
        _engine(models, side, page_size=8, n_pages=16)


def _counting(monkeypatch):
    """Count B1 and B2 calls on the CPU as their wrappers count launches
    on the card."""
    real_mm, real_fa = ops.block_matmul, ops.flash_attention

    def mm(x, w, **kw):
        bm.LAUNCHES[("counted",)] += 1
        return real_mm(x, w, **kw)

    def att(*a, **kw):
        fa.LAUNCHES[("counted",)] += 1
        return real_fa(*a, **kw)
    monkeypatch.setattr(ops, "block_matmul", mm)
    monkeypatch.setattr(ops, "flash_attention", att)


@pytest.mark.parametrize("speculative", [False, True])
def test_no_build_after_warmup_and_exact_launches(models, monkeypatch,
                                                  speculative):
    """warmup() builds every call a level-sweeping serve reaches; the
    serve then builds and misses nothing, and every replay adds exactly
    its kind's launches."""
    _counting(monkeypatch)
    saved = [dict(bm.LAUNCHES), dict(fa.LAUNCHES)]
    layers = models[3].num_layers
    try:
        eng = _engine(models, "torch", speculative=speculative)
        eng.version_cache.graphs = ReplayOnCPU()
        eng.warmup(levels=[cm.grid_point(i) for i in (0, 5, 9)])
        vc = eng.version_cache
        traces, misses = vc.traces, vc.misses
        for c in (bm.LAUNCHES, fa.LAUNCHES):
            c.clear()
        kinds = set()
        for i, p in enumerate(models[5][:2]):
            for counter in (bm.LAUNCHES, fa.LAUNCHES):
                counter.clear()
            eng.admit_request(torch_engine.Request(
                rid=i, prompt=p, max_new_tokens=24), drain=True)
            chunks = -(-len(p) // eng.prefill_chunk_len)
            assert sum(bm.LAUNCHES.values()) == 3 * layers * chunks
            assert sum(fa.LAUNCHES.values()) == 0
        step = 0
        while eng.active_slots:
            eng.set_interference_level(cm.grid_point((0, 5, 9)[step % 3]))
            b1 = sum(bm.LAUNCHES.values())
            handle = eng.begin_quantum(4)
            eng.finish_quantum(handle)
            kinds.add(handle.kind)
            per_step = 3 * layers
            want = 2 * per_step if handle.kind == "spec" \
                else per_step * handle.bucket
            assert sum(bm.LAUNCHES.values()) - b1 == want, handle.kind
            assert sum(fa.LAUNCHES.values()) == 0
            step += 1
            assert step < 400
        assert vc.traces == traces and vc.misses == misses
        assert ("spec" in kinds) == speculative
    finally:
        bm.LAUNCHES.clear()
        bm.LAUNCHES.update(saved[0])
        fa.LAUNCHES.clear()
        fa.LAUNCHES.update(saved[1])


def test_monolithic_prefill_runs_flash_attention(models, monkeypatch):
    """A monolithic admission runs B2 once per attention layer (the
    chunk attends itself under the window, then fills the ring) and B1
    three times per layer."""
    _counting(monkeypatch)
    saved = [dict(bm.LAUNCHES), dict(fa.LAUNCHES)]
    try:
        eng = _engine(models, "torch", chunked_prefill=False)
        for c in (bm.LAUNCHES, fa.LAUNCHES):
            c.clear()
        eng.admit_request(torch_engine.Request(rid=0, prompt=models[5][0],
                                               max_new_tokens=4))
        assert sum(fa.LAUNCHES.values()) == eng.model.plan.scan_kinds.count(
            "attn_local") * eng.model.plan.n_groups
        assert sum(bm.LAUNCHES.values()) == 3 * models[3].num_layers
    finally:
        bm.LAUNCHES.clear()
        bm.LAUNCHES.update(saved[0])
        fa.LAUNCHES.clear()
        fa.LAUNCHES.update(saved[1])


def _slot_leaves(eng, slot):
    return {path: leaf.select(cache_batch_axis(path), slot).clone()
            for path, leaf in tree_leaves_with_path(eng.cache)}


@pytest.mark.parametrize("chunked", [True, False])
def test_warm_decode_then_admission_leaves_no_stale_ring(models, chunked):
    """The warm decodes write position 0 of every slot (the ring's slot 0,
    the RG-LRU and conv state); admission writes a whole fresh row over
    the slot, so the slot ends bit for bit as on an engine never warmed,
    and its ring holds only the prompt's positions."""
    prompt = models[5][1]                    # 7 tokens
    warmed = _engine(models, "torch", chunked_prefill=chunked)
    warmed.warmup(levels=[0.0], prompt_lens=(len(prompt),))
    before = _slot_leaves(warmed, 1)
    assert before[("blocks", "attn_local_2", "pos")][0, 0] == 0
    cold = _engine(models, "torch", chunked_prefill=chunked)
    for eng in (warmed, cold):
        eng.admit_request(torch_engine.Request(rid=0, prompt=prompt,
                                               max_new_tokens=4),
                          drain=True)
    got, want = _slot_leaves(warmed, 0), _slot_leaves(cold, 0)
    for path in want:
        assert torch.equal(got[path], want[path]), path
    pos = got[("blocks", "attn_local_2", "pos")]
    assert sorted(pos[pos >= 0].tolist()) == list(range(len(prompt)))


@pytest.fixture(scope="module", autouse=True)
def _shared_executables():
    """The JAX engines of this module share their compiled executables
    (``test_torch_core.SharedXla``): each case builds new engines, which
    would compile the same modules again."""
    yield from shared_executables()
