"""The static-buffer path of the port's CUDA graphs, on the CPU (reduced
gemma-2b and reduced mamba2-780m, the JAX parameters bridged over).

Nothing is captured on the CPU: the version cache runs each call eagerly,
bound to the same static tensors a graph would bake in, so these tests
cover everything but capture and replay (``tests/test_torch_cuda.py``
holds those on the card).

  * ``prefill_chunk`` with device-scalar ``t0`` / ``valid_len`` (0-d and
    (B,) tensors) against the host-int call: logits and cache bit-equal,
    chunk by chunk over a prompt with a padded tail; and against the JAX
    ``Model.prefill_chunk`` with traced scalars at 2e-2 on logits, the
    port's tolerance against the reference as it compiles by default
    (``tests/test_torch_model.py``).
  * the page table keeps its tensor (identity and address) through
    ``_sync_table``, ``warmup``, admissions, copy-on-write and release.
  * the engine's static-buffer path (interleaved chunked prefills of two
    slots, the one-step decode, fused quanta, monolithic prefills) gives
    the JAX engine's tokens on the same schedule, and interleaved chunks
    give what the same chunks give in turn.
  * launch accounting, with :class:`ReplayOnCPU` standing in for
    ``CudaGraphs``: a replay adds what its capture recorded, once, and a
    capture adds nothing; the stand-in's replays run the model and write
    the results into the captured outputs, so an engine served through it
    gives the eager engine's tokens and launch counts.
  * a capture that fails raises; nothing falls back to the eager call.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro_torch.bridge import cache_to_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.kernels import block_matmul as bm  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving.version_cache import StaticArgError, \
    VersionCache  # noqa: E402
from test_torch_model import mamba_prompt  # noqa: E402

MAX_LEN = 32
LOGIT_TOL = 2e-2
ARCHS = ("gemma-2b", "mamba2-780m")


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = jax_reduced_config(request.param)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return (request.param, jmodel, jparams,
            Model(get_reduced_config(request.param)), tparams)


@pytest.fixture(autouse=True)
def _clean_dispatch():
    yield
    dispatch.clear_tile_overrides()
    dispatch.install_ladder(None)


def _leaves(cache):
    return [a for _, a in tree_leaves_with_path(cache)]


# ---------------------------------------------------------------------------
# prefill_chunk with device scalars
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("form", ["0-d", "(B,)"])
def test_prefill_chunk_device_scalars_bit_equal_host_ints(arch, form):
    """An 11-token prompt as the engine schedules it with chunks of 4
    (4, 4, then 3 real tokens padded to 4), two rows: every chunk's
    logits and the cache after it are bit-equal between host ints and
    device scalars."""
    _, _, _, tmodel, tp = arch
    prompt = np.random.default_rng(5).integers(0, 256, (2, 11))
    caches = [tmodel.init_cache(2, MAX_LEN, "cpu") for _ in range(2)]
    t0 = 0
    while t0 < 11:
        valid = min(4, 11 - t0)
        toks = np.zeros((2, 4), np.int64)
        toks[:, :valid] = prompt[:, t0:t0 + valid]
        x = torch.from_numpy(toks)
        want, caches[0] = tmodel.prefill_chunk(tp, {"tokens": x}, caches[0],
                                               t0, valid)
        if form == "0-d":
            dt0, dvl = torch.tensor(t0), torch.tensor(valid)
        else:
            dt0, dvl = torch.tensor([t0, t0]), torch.tensor([valid, valid])
        got, caches[1] = tmodel.prefill_chunk(tp, {"tokens": x}, caches[1],
                                              dt0, dvl)
        assert torch.equal(got, want), t0
        for a, b in zip(_leaves(caches[1]), _leaves(caches[0])):
            assert torch.equal(a, b), t0
        t0 += 4


def test_prefill_chunk_device_scalars_match_jax_traced_scalars(arch):
    """The same chunks through the JAX ``prefill_chunk`` jitted with
    ``t0`` and ``valid_len`` as traced arguments: logits within 2e-2,
    chunk by chunk, and the same argmax."""
    name, jmodel, jp, tmodel, tp = arch
    prompt = (mamba_prompt(13) if name == "mamba2-780m" else
              np.random.default_rng(6).integers(0, 256, 13))[None]
    jchunk = jax.jit(lambda p, x, c, t0, vl: jmodel.prefill_chunk(
        p, {"tokens": x}, c, t0, vl))
    jc = jmodel.init_cache(1, MAX_LEN)
    tc = tmodel.init_cache(1, MAX_LEN, "cpu")
    t0 = 0
    for c in (8, 4, 4):               # 13 tokens: the last chunk padded
        valid = min(c, 13 - t0)
        toks = np.zeros((1, c), np.int64)
        toks[:, :valid] = prompt[:, t0:t0 + valid]
        jl, jc = jchunk(jp, jnp.asarray(toks, jnp.int32), jc,
                        jnp.int32(t0), jnp.int32(valid))
        tl, tc = tmodel.prefill_chunk(tp, {"tokens": torch.from_numpy(toks)},
                                      tc, torch.tensor(t0),
                                      torch.tensor(valid))
        want = np.asarray(jl, np.float32)
        np.testing.assert_allclose(tl.numpy(), want, rtol=0, atol=LOGIT_TOL)
        assert int(tl.argmax()) == int(want.argmax())
        t0 += valid
    ref = cache_to_numpy(tc)
    assert all(np.isfinite(a).all() for a in jax.tree_util.tree_leaves(ref))


# ---------------------------------------------------------------------------
# the engine's static buffers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def gemma():
    jcfg = jax_reduced_config("gemma-2b")
    jparams = build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, get_reduced_config("gemma-2b"), tparams


def _port(gemma, **kw):
    return torch_engine.ServingEngine(gemma[2], gemma[3], max_len=MAX_LEN,
                                      device="cpu", **kw)


def _prompts(vocab):
    rng = np.random.default_rng(11)
    shared = rng.integers(0, vocab, 10).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, vocab, 9)]).astype(
                np.int32),
            rng.integers(0, vocab, 13).astype(np.int32),
            shared[:9].copy(), rng.integers(0, vocab, 6).astype(np.int32)]


def test_page_table_keeps_its_tensor(gemma):
    """Every paged graph reads the one table tensor: ``_sync_table``,
    ``warmup``, admissions (with a shared prefix), copy-on-write and
    release write into it and never rebind it."""
    eng = _port(gemma, batch_slots=2, page_size=8)
    table = eng.cache["page_table"]
    ptr = table.data_ptr()

    def same():
        assert eng.cache["page_table"] is table
        assert table.data_ptr() == ptr
    eng.warmup(levels=[0.0, 1.0])
    same()
    prompts = _prompts(gemma[2].vocab_size)
    reqs = [torch_engine.Request(rid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts)]
    assert eng.admit_request(reqs[0], drain=True)
    same()
    assert eng.admit_request(reqs[2], drain=True)     # borrows its pages
    same()
    eng.step_quantum(2)                               # copy-on-write
    same()
    assert eng.page_stats["cow_copies"] >= 1
    eng.warmup(levels=[0.5])
    same()
    assert torch.equal(table, torch.from_numpy(eng._page_table))
    eng.run_to_completion(reqs[1:2] + reqs[3:])
    eng._sync_table()
    same()
    assert torch.all(table == 0)


def _interleaved(mod, eng, prompts, interleave=True):
    """Two slots' chunked prefills interleaved chunk by chunk (or one
    after the other), a one-step decode, fused quanta at two levels, then
    the rest."""
    reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    assert eng.admit_request(reqs[0]) and eng.admit_request(reqs[1])
    while eng.prefill_pending:
        for slot in sorted(eng._prefill)[:None if interleave else 1]:
            eng.prefill_step(slot)
    eng.step()
    eng.set_interference_level(cm.grid_point(9))
    eng.step_quantum(2)
    eng.set_interference_level(cm.grid_point(0))
    eng.run_to_completion(reqs[2:])
    assert all(r.done for r in reqs)
    return [list(r.output) for r in reqs], eng.host_syncs


def test_interleaved_chunks_equal_chunks_in_turn(gemma):
    """Two slots' chunks interleaved share the one static prefill row
    (each chunk copies its slot's row in and out): the same tokens, bit
    for bit, as each slot's chunks run in turn."""
    prompts = _prompts(gemma[2].vocab_size)
    outs = [_interleaved(torch_engine, _port(gemma, batch_slots=2), prompts,
                         interleave=flag) for flag in (True, False)]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("chunked", [True, False])
def test_static_buffer_path_gives_the_jax_engines_tokens(gemma, chunked):
    """The engine's static inputs and static prefill row serve the JAX
    engine's tokens with the same host syncs on the interleaved schedule;
    ``chunked=False`` runs the monolithic prefill through the static row.
    The prompts are ``tests/test_torch_engine.py``'s (its JAX engine's
    streams there keep clear of the near-ties of ROADMAP queue C) and one
    more of its generator's."""
    jcfg, jparams = gemma[0], gemma[1]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (3, 7, 5, 9)]
    jeng = jax_engine.ServingEngine(jcfg, jparams, batch_slots=2,
                                    max_len=MAX_LEN, chunked_prefill=chunked)
    teng = _port(gemma, batch_slots=2, chunked_prefill=chunked)
    want = _interleaved(jax_engine, jeng, prompts)
    got = _interleaved(torch_engine, teng, prompts)
    assert got == want


def test_rebinding_a_static_tensor_raises(gemma):
    """A built call is bound to its tensors: handing it another tensor in
    a bound place raises instead of computing on stale addresses."""
    eng = _port(gemma, batch_slots=2)
    eng.warmup(levels=[0.0])
    qfn = eng.version_cache.quantum(eng._entry, 2, eng.slots)
    inp = eng._inputs
    qfn(eng.params, inp.tokens, eng.cache, inp.pos, inp.n_left)
    with pytest.raises(StaticArgError, match="rebound"):
        qfn(eng.params, inp.tokens.clone(), eng.cache, inp.pos, inp.n_left)


# ---------------------------------------------------------------------------
# launch accounting and capture errors, with a stand-in for CudaGraphs
# ---------------------------------------------------------------------------
class _StandInGraph:
    """A replay runs the captured call again and writes its results into
    the captured outputs; like a CUDA graph's replay it runs none of the
    wrappers' counting (the counters are put back after)."""

    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out
        self.replays = 0

    def replay(self):
        counters = dispatch.launch_counters()
        saved = [collections.Counter(c) for c in counters]
        new = self.fn(*self.args)
        for c, s in zip(counters, saved):
            c.clear()
            c.update(s)
        for dst, src in zip(_flat(self.out), _flat(new)):
            if dst is not src:
                dst.copy_(src)
        self.replays += 1


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    return [t for v in tree for t in _flat(v)]


class ReplayOnCPU:
    """Stands in for ``CudaGraphs`` on the CPU."""

    def __init__(self, fail: bool = False):
        self.fail = fail
        self.captures = 0

    def run(self, fn, args):
        return fn(*args)

    def capture(self, fn, args):
        self.captures += 1
        out = fn(*args)
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return _StandInGraph(fn, args, out), out


class _CountingModel:
    """A model whose fused quantum 'launches' three B1 kernels."""

    def __init__(self):
        self.calls = 0

    def decode_quantum(self, params, tokens, cache, pos, n_left, k):
        self.calls += 1
        bm.LAUNCHES[("stand-in",)] += 3
        return tokens[None].repeat(k, 1) + 1, cache, pos


def test_replay_adds_the_captured_launches_once():
    before = dict(bm.LAUNCHES)
    try:
        bm.LAUNCHES.clear()
        model = _CountingModel()
        vc = VersionCache(model, graphs=ReplayOnCPU())
        entry = vc.get({})
        qfn = vc.quantum(entry, 4, 2)
        args = ({}, torch.zeros(2, dtype=torch.int64), {},
                torch.zeros(2, dtype=torch.int64),
                torch.zeros(2, dtype=torch.int64))
        qfn(*args)                      # eager first use, then capture
        assert model.calls == 2
        assert bm.LAUNCHES[("stand-in",)] == 3      # the capture's undone
        assert vc.traces == 1 and vc.graphs.captures == 1
        for i in range(5):
            block = qfn(*args)[0]
            assert bm.LAUNCHES[("stand-in",)] == 3 * (i + 2)
        assert qfn.graph.replays == 5 and qfn.replays == 5
        assert torch.equal(block, torch.ones(4, 2, dtype=torch.int64))
        assert vc.traces == 1
    finally:
        bm.LAUNCHES.clear()
        bm.LAUNCHES.update(before)


def test_stand_in_graphs_serve_the_eager_engines_tokens_and_launches(
        gemma, monkeypatch):
    """Every B1 call through ``ops.block_matmul`` counts a launch (as the
    kernel's wrapper does on the card).  An engine whose calls are
    'captured' and 'replayed' by the stand-in serves the eager engine's
    tokens, with the same launch count once warm."""
    real_mm = ops.block_matmul

    def counting_mm(x, w, **kw):
        bm.LAUNCHES[("counted",)] += 1
        return real_mm(x, w, **kw)
    monkeypatch.setattr(ops, "block_matmul", counting_mm)
    prompts = _prompts(gemma[2].vocab_size)
    results = []
    for graphs in (None, ReplayOnCPU()):
        eng = _port(gemma, batch_slots=2, page_size=8)
        if graphs is not None:
            eng.version_cache.graphs = graphs
        eng.warmup(levels=[cm.grid_point(0), cm.grid_point(9)])
        traces = eng.version_cache.traces
        bm.LAUNCHES.clear()
        results.append((_interleaved(torch_engine, eng, prompts),
                        sum(bm.LAUNCHES.values())))
        assert eng.version_cache.traces == traces
    assert results[0] == results[1]
    assert results[1][1] > 0
    calls = eng.version_cache._calls.values()
    assert all(c.graph is not None for c in calls)
    assert sum(c.replays for c in calls) > 0


def test_a_failed_capture_raises():
    before = dict(bm.LAUNCHES)
    vc = VersionCache(_CountingModel(), graphs=ReplayOnCPU(fail=True))
    qfn = vc.quantum(vc.get({}), 2, 1)
    z = torch.zeros(1, dtype=torch.int64)
    try:
        for attempt in (1, 2):        # a failed build is retried, never
            with pytest.raises(RuntimeError, match="capturing"):
                qfn({}, z, {}, z, z)  # run eagerly in its place
            assert vc.traces == vc.graphs.captures == attempt
    finally:
        bm.LAUNCHES.clear()
        bm.LAUNCHES.update(before)
    assert qfn.graph is None


def test_engine_warmup_raises_when_a_capture_fails(gemma):
    eng = _port(gemma, batch_slots=2)
    eng.version_cache.graphs = ReplayOnCPU(fail=True)
    with pytest.raises(RuntimeError, match="capturing"):
        eng.warmup(levels=[0.0])
