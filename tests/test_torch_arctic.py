"""The port's dense-residual MoE (arctic-480b's ``moe_arctic`` block:
standard attention, a dense MLP beside capacity-routed experts) against
the JAX package on the CPU: the reduced config (three stacked
``moe_arctic`` blocks; d_model 128, 4 heads over 2 KV heads, a dense
residual of 256, 4 experts of 64, top-2, capacity factor 1.25), the JAX
initializer's weights bridged over, ``MAX_LEN`` 64.

Tolerances and why:
  * logits within 2e-2 absolute of the reference compiled without XLA's
    excess precision (the port rounds every op to bf16, as that compile
    does; the default one skips intermediate roundings and moves the
    routers' inputs);
  * greedy tokens, acceptances and positions equal the exact reference's;
  * KV cache entries: layer 0's (fed by the embeddings alone) within one
    bf16 ulp at each vector's scale, later layers' within 2e-2 of each
    vector's largest entry (a batched call sums its expert products in
    another order than XLA, and a later layer's input carries that);
  * rows that are not live keep their cache bit for bit;
  * engines: the JAX engine compiles without excess precision (its
    version cache's ``jax.jit`` swapped, as in
    ``tests/test_torch_deepseek_engine.py``); then dense, paged,
    speculative and paged speculative serves give its streams, counters,
    page counters and ``spec_stats`` exactly, and the port's paged and
    speculative streams equal its dense ones.
The trees equal the reference's in paths, shapes, axes and dtypes at
full width, built from specs alone, and the weight bridge carries the
arctic tree exactly (the router in fp32).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.model import make_plan as jax_make_plan  # noqa: E402
from repro.serving import version_cache as jax_version_cache  # noqa: E402
from repro_torch.bridge import cache_from_numpy, cache_to_numpy, \
    params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.kernels import block_matmul as bm  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_paged as fap  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.model import Model, cache_batch_axis, \
    plan_layers  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from test_torch_deepseek import _compiled_once, _exact, _f32, _leaf, _np, \
    _same_specs, _set_row, _tokens, _tt, _ulp  # noqa: E402
from test_torch_deepseek_engine import _counting, _engine, _ExactJax, \
    _serve  # noqa: E402
from test_torch_graphs import ReplayOnCPU  # noqa: E402

ARCH = "arctic-480b"
MAX_LEN = 64
LOGIT_TOL = 2e-2
KV_TOL = 2e-2
D = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: as fast
    alone, and the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _exact_jax_engine():
    saved = jax_version_cache.jax
    jax_version_cache.jax = _ExactJax()
    yield
    jax_version_cache.jax = saved


@pytest.fixture(autouse=True)
def _clean_dispatch():
    yield
    dispatch.clear_tile_overrides()
    dispatch.install_ladder(None)


@pytest.fixture(scope="module")
def pair():
    """The JAX model with its own initializer's weights, and the port's
    model with the same weights bridged over."""
    jmodel = build_model(jax_reduced_config(ARCH))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jmodel, jparams, Model(get_reduced_config(ARCH)), tparams


def _assert_cache(got, want):
    """Layer 0's keys and values within one bf16 ulp at each vector's
    scale, the later layers' within KV_TOL of each vector's largest
    entry."""
    for path, t in tree_leaves_with_path(got):
        j = _leaf(want, path)
        assert t.shape == j.shape, path
        scale = np.abs(j).max(axis=-1, keepdims=True)
        tol = KV_TOL * scale
        tol[0] = _ulp(j[0])
        assert np.all(np.abs(t - j) <= tol), path


# --------------------------------------------------------------------------
# plan, trees, bridge
# --------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_plan_matches_reference(which):
    if which == "full":
        jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    else:
        jcfg, tcfg = jax_reduced_config(ARCH), get_reduced_config(ARCH)
    got, want = plan_layers(tcfg), jax_make_plan(jcfg)
    assert (got.prologue, got.scan_kinds, got.n_groups, got.epilogue) == \
        (want.prologue, want.scan_kinds, want.n_groups, want.epilogue)
    assert got.scan_kinds == ("moe_arctic",)
    assert got.n_groups == (35 if which == "full" else 3)


def test_trees_match_reference():
    """Parameter, cache and paged-cache specs at full width under the same
    paths, shapes, axes and dtypes (specs only: nothing is allocated);
    the KV leaves page, as a dense block's do."""
    jmodel, tmodel = build_model(jax_config(ARCH)), Model(get_config(ARCH))
    params = _same_specs(tmodel.param_specs(), jmodel.param_specs())
    _same_specs(tmodel.cache_specs(3, 512), jmodel.cache_specs(3, 512))
    _same_specs(tmodel.paged_cache_specs(3, 512, 40, 16),
                jmodel.paged_cache_specs(3, 512, 40, 16))
    assert tmodel.all_cache_leaves_paged()
    assert not tmodel.has_recurrent_leaves()
    assert tmodel.paged_leaf_paths() == jmodel.paged_leaf_paths()
    blk = ("blocks", "moe_arctic")
    assert params[blk + ("moe", "w_gate")].shape == (35, 128, 7168, 4864)
    assert params[blk + ("moe", "router")].dtype == torch.float32
    assert params[blk + ("mlp", "w_up")].shape == (35, 7168, 4864)
    assert params[blk + ("attn", "wk")].shape == (35, 7168, 8, 128)
    assert 476e9 < sum(s.size for s in params.values()) < 478e9


def test_bridge_round_trip_of_the_arctic_tree(pair):
    """Every leaf crosses exactly: the router stays fp32, the expert
    stacks and the dense residual bf16, values unchanged."""
    _, jparams, _, tparams = pair
    back = cache_to_numpy(tparams)
    for path, leaf in tree_leaves_with_path(tparams):
        j = np.asarray(_leaf(jparams, path), np.float32)
        np.testing.assert_array_equal(_leaf(back, path), j,
                                      err_msg=str(path))
        want = "float32" if path[-1] in ("router", "scale") else "bfloat16"
        assert str(leaf.dtype) == f"torch.{want}", path
    blk = tparams["blocks"]["moe_arctic"]
    assert set(blk) == {"ln1", "attn", "ln2", "mlp", "moe"}
    assert tuple(blk["moe"]["w_gate"].shape) == (3, 4, 128, 64)
    assert tuple(blk["mlp"]["w_gate"].shape) == (3, 128, 256)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def test_entry_points_match_reference(pair):
    """Prefill 12 tokens on two rows, a decode step, a padded 16-token
    chunk holding 11 real tokens at a device-scalar start, one more decode
    step; logits and every cache leaf against the exact reference."""
    jmodel, jp, tmodel, tp = pair
    toks = np.stack([_tokens(1, 12), _tokens(2, 12)])
    jl1, jc = _exact(lambda p, x, c: jmodel.prefill(p, {"tokens": x}, c),
                     jp, jnp.asarray(toks), jmodel.init_cache(2, MAX_LEN))
    tl1, tc = tmodel.prefill(tp, {"tokens": _tt(toks)},
                             tmodel.init_cache(2, MAX_LEN, "cpu"))
    out = [(tl1, jl1)]
    step = (lambda p, x, c, t: jmodel.decode_step(p, {"tokens": x}, c, t))
    nxt = np.argmax(_np(jl1), -1).astype(np.int32)
    jl2, jc = _exact(step, jp, jnp.asarray(nxt), jc,
                     jnp.asarray([12, 12], jnp.int32))
    tl2, tc = tmodel.decode_step(tp, {"tokens": _tt(nxt)}, tc, _tt([12, 12]))
    out.append((tl2, jl2))
    chunk = np.stack([_tokens(3, 16), _tokens(4, 16)])
    jl3, jc = _exact(lambda p, x, c: jmodel.prefill_chunk(
        p, {"tokens": x}, c, jnp.int32(13), jnp.int32(11)),
        jp, jnp.asarray(chunk), jc)
    tl3, tc = tmodel.prefill_chunk(tp, {"tokens": _tt(chunk)}, tc,
                                   torch.tensor(13), torch.tensor(11))
    out.append((tl3, jl3))
    nxt = np.argmax(_np(jl3), -1).astype(np.int32)
    jl4, jc = _exact(step, jp, jnp.asarray(nxt), jc,
                     jnp.asarray([24, 24], jnp.int32))
    tl4, tc = tmodel.decode_step(tp, {"tokens": _tt(nxt)}, tc, _tt([24, 24]))
    out.append((tl4, jl4))
    for got, want in out:
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                                   atol=LOGIT_TOL)
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      _np(want).argmax(-1))
    _assert_cache(cache_to_numpy(tc), _f32(jc))


def test_binding_capacity_drops_tokens_as_reference(pair):
    """Capacity factor 0.5 on both sides (one slot an expert for a
    12-token group): the prefill drops tokens (counted from the port's
    routing) and its logits and cache still match the exact
    reference's."""
    _, jp, _, tp = pair
    jcfg, tcfg = jax_reduced_config(ARCH), get_reduced_config(ARCH)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=0.5))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.5))
    jmodel, tmodel = build_model(jcfg), Model(tcfg)
    toks = _tokens(7, 12)[None]
    jl, jc = _exact(lambda p, x, c: jmodel.prefill(p, {"tokens": x}, c),
                    jp, jnp.asarray(toks), jmodel.init_cache(1, MAX_LEN))
    real, dropped = moe_mod.route_tokens, []

    def counting(params, xg, moe):
        out = real(params, xg, moe)
        dropped.append(int(out[1].sum() - out[2].sum()))
        return out
    moe_mod.route_tokens = counting
    try:
        tl, tc = tmodel.prefill(tp, {"tokens": _tt(toks)},
                                tmodel.init_cache(1, MAX_LEN, "cpu"))
    finally:
        moe_mod.route_tokens = real
    assert len(dropped) == 3 and min(dropped) > 0, dropped
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                  _np(jl).argmax(-1))
    _assert_cache(cache_to_numpy(tc), _f32(jc))


# prompt lengths of the batched quantum and verify rows
LENS = (3, 10, 21)
STREAM_LEN = D + 2


@pytest.fixture(scope="module")
def streams(pair):
    """For each prompt length: the exact reference's batch-1 cache row
    after the prompt (one padded 32-token chunk, so one compile serves
    every length) and its greedy stream of STREAM_LEN decode steps."""
    jmodel, jp = pair[:2]
    chunk = _compiled_once(lambda p, x, c, t0, vl: jmodel.prefill_chunk(
        p, {"tokens": x}, c, t0, vl))
    step = _compiled_once(lambda p, x, c, t: jmodel.decode_step(
        p, {"tokens": x}, c, t))
    out = {}
    for n in LENS:
        toks = np.zeros(32, np.int32)
        toks[:n] = _tokens(100 + n, n)
        lg, row = chunk(jp, jnp.asarray(toks)[None],
                        jmodel.init_cache(1, MAX_LEN), jnp.int32(0),
                        jnp.int32(n))
        c, stream = row, []
        for i in range(STREAM_LEN):
            stream.append(int(np.argmax(_np(lg[0]))))
            lg, c = step(jp, jnp.asarray(stream[-1:], jnp.int32), c,
                         jnp.asarray([n + i], jnp.int32))
        out[n] = (row, np.array(stream, np.int32))
    return out


def _batched(pair, streams):
    jc = pair[0].init_cache(len(LENS), MAX_LEN)
    for i, n in enumerate(LENS):
        jc = _set_row(jc, streams[n][0], i)
    tc = cache_from_numpy(jax.tree_util.tree_map(np.asarray, jc),
                          device="cpu")
    first = np.array([streams[n][1][0] for n in LENS], np.int32)
    return jc, tc, first, np.asarray(LENS, np.int32)


def test_decode_quantum_matches_jax(pair, streams):
    """A 4-step quantum with budgets 4, 0 and 2: tokens, positions and
    cache equal the exact reference's; the row with no budget keeps every
    key and value bit for bit, written in place."""
    jmodel, jp, tmodel, tp = pair
    jc, tc, first, pos = _batched(pair, streams)
    n_left = np.asarray((4, 0, 2), np.int32)
    jblock, jc, jpos = _exact(
        lambda p, t, c, q, n: jmodel.decode_quantum(p, t, c, q, n, 4),
        jp, jnp.asarray(first), jc, jnp.asarray(pos), jnp.asarray(n_left))
    before = cache_to_numpy(tc)
    tblock, tc2, tpos = tmodel.decode_quantum(tp, _tt(first), tc, _tt(pos),
                                              _tt(n_left), 4)
    assert tc2 is tc
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    jblock = np.asarray(jblock)
    for i in range(len(LENS)):
        np.testing.assert_array_equal(tblock[:n_left[i], i].numpy(),
                                      jblock[:n_left[i], i])
    after = cache_to_numpy(tc)
    _assert_cache(after, _f32(jc))
    for path, leaf in tree_leaves_with_path(after):
        ax = cache_batch_axis(path)
        np.testing.assert_array_equal(np.take(leaf, 1, axis=ax),
                                      np.take(_leaf(before, path), 1,
                                              axis=ax))


def test_verify_quantum_matches_jax(pair, streams):
    """Acceptance 0, 2 and d on the three rows; row 2's budget (3) caps
    its emission.  Block, ``n_emit``, ``accepted``, positions and the
    cache equal the exact reference's.  The drafts are the exact
    reference verify's own argmax with row 0's first and row 1's third
    draft replaced, iterated to a fixed point (the verify routes all
    rows' drafts together)."""
    jmodel, jp, tmodel, tp = pair
    jc, tc, first, pos = _batched(pair, streams)
    drafts = np.stack([streams[n][1][1:D + 1] for n in LENS])
    full = np.full(len(LENS), D + 1, np.int32)
    verify = _compiled_once(jmodel.verify_quantum)

    def run(n_left):
        return verify(jp, jnp.asarray(first), jnp.asarray(drafts), jc,
                      jnp.asarray(pos), jnp.asarray(n_left))
    for _ in range(8):
        g = np.asarray(run(full)[0]).T[:, :D]
        drafts = g.copy()
        drafts[0, 0] = (g[0, 0] + 1) % 256
        drafts[1, 2] = (g[1, 2] + 1) % 256
        if np.asarray(run(full)[2]).tolist() == [0, 2, D]:
            break
    n_left = np.asarray((D + 1, D + 1, 3), np.int32)
    jblock, jn, ja, jc2, jpos = run(n_left)
    tblock, tn, ta, tc2, tpos = tmodel.verify_quantum(
        tp, _tt(first), _tt(drafts), tc, _tt(pos), _tt(n_left))
    assert tc2 is tc
    np.testing.assert_array_equal(np.asarray(ja), [0, 2, D])
    np.testing.assert_array_equal(np.asarray(jn), [1, 3, 3])
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tblock.numpy(), np.asarray(jblock))
    _assert_cache(cache_to_numpy(tc), _f32(jc2))


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------
# the deepseek engine test's schedule (``_serve``: staggered admissions,
# mid-quantum completions, level switches, 4-step quanta) and prompts
PROMPT_LENS = (10, 13, 15)
PAGED = {"page_size": 8, "n_pages": 24}
# the serves held against the JAX engine
KINDS = {"dense": {}, "paged": PAGED, "spec": {"speculative": True},
         "paged spec": {**PAGED, "speculative": True}}
COUNTERS = ("host_syncs", "tokens_decoded", "prefill_chunks",
            "prefill_tokens", "prefill_pad_tokens", "quantum_calls")


@pytest.fixture(scope="module")
def sides(pair):
    jmodel, jparams, tmodel, tparams = pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in PROMPT_LENS]
    return {"jax": (jmodel.cfg, jparams), "torch": (tmodel.cfg, tparams),
            "prompts": prompts}


@pytest.fixture(scope="module")
def runs(sides):
    return {(side, kind): _serve(sides, side, **kw)
            for side in ("torch", "jax") for kind, kw in KINDS.items()}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_engine_streams_and_counters_equal_jax(runs, kind):
    (te, got), (je, want) = runs["torch", kind], runs["jax", kind]
    assert got == want
    for attr in COUNTERS:
        assert getattr(te, attr) == getattr(je, attr), attr
    if "paged" in kind:
        assert te.page_stats == je.page_stats
        assert te.peak_cache_tokens == je.peak_cache_tokens
        assert te.pool.used_pages == 0 and te.pool.committed == 0
        assert te.page_stats["peak_used"] > 0
    if "spec" in kind:
        assert te.spec_stats == je.spec_stats
        assert te.spec_quanta > 0 and te.spec_rollbacks > 0


@pytest.mark.parametrize("kind", ["paged", "spec", "paged spec"])
def test_paged_and_spec_streams_equal_dense(runs, kind):
    assert runs["torch", kind][1] == runs["torch", "dense"][1]


def test_no_build_after_warmup_and_exact_launches(sides, monkeypatch):
    """A paged speculative engine under ``ReplayOnCPU``: nothing built
    after ``warmup()``; each forward pass launches B1 3 times a layer
    (the dense residual), B2 once a layer per prefill chunk, B3 once a
    layer per decode step and per verify (no restore pass: every leaf
    pages)."""
    _counting(monkeypatch)
    counters = (bm.LAUNCHES, fa.LAUNCHES, fap.LAUNCHES)
    saved = [dict(c) for c in counters]
    n = sides["torch"][0].num_layers
    try:
        eng = _engine(sides, "torch", **PAGED, speculative=True)
        eng.version_cache.graphs = ReplayOnCPU()
        eng.warmup(levels=[cm.grid_point(i) for i in (0, 9)])
        vc = eng.version_cache
        traces, misses = vc.traces, vc.misses
        kinds = set()
        for i, p in enumerate(sides["prompts"][:2]):
            for c in counters:
                c.clear()
            eng.admit_request(torch_engine.Request(
                rid=i, prompt=p, max_new_tokens=24), drain=True)
            chunks = -(-len(p) // eng.prefill_chunk_len)
            assert sum(bm.LAUNCHES.values()) == 3 * n * chunks
            assert sum(fa.LAUNCHES.values()) == n * chunks
            assert sum(fap.LAUNCHES.values()) == 0
        step = 0
        while eng.active_slots:
            eng.set_interference_level(cm.grid_point((0, 9)[step % 2]))
            before = [sum(c.values()) for c in counters]
            handle = eng.begin_quantum(4)
            eng.finish_quantum(handle)
            kinds.add(handle.kind)
            passes = 1 if handle.kind == "spec" else handle.bucket
            got = [sum(c.values()) - b for c, b in zip(counters, before)]
            assert got == [3 * n * passes, 0, n * passes], handle.kind
            step += 1
            assert step < 400
        assert vc.traces == traces and vc.misses == misses
        assert "spec" in kinds
    finally:
        for c, s in zip(counters, saved):
            c.clear()
            c.update(s)
