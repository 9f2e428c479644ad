"""The port's hybrid family (RG-LRU + local attention) against the JAX
model on the CPU, at the model level: reduced recurrentgemma-2b (one
(rec, rec, attn) group) and a 5-layer clone of it (one group plus the
two-layer epilogue ``epi_0``, ``epi_1``); the JAX parameters bridged
over; window 32 and ``MAX_LEN`` 64, so prompts of 40 tokens wrap the
ring.

Tolerances and why (those of ``tests/test_torch_model.py``):
  * logits within 2e-2 absolute of the reference, compiled with and
    without XLA's excess precision: the RG-LRU scan sums in another
    order (a log-step scan against ``associative_scan``) and bf16
    roundings may flip by an ulp;
  * greedy tokens equal wherever the reference's top two logits are more
    than ``CLEAR_MARGIN`` apart (the prompts below are chosen so they
    are, and the tests hold that);
  * cache state: ring positions exact.  The first layer's state (fed by
    the embeddings alone) against the reference compiled without excess
    precision: the bf16 conv within one bf16 flip (2**-6 of its largest
    entry), the fp32 RG-LRU state within 1e-4 of its largest entry (the
    scan's order; ``exp``/``sigmoid`` may differ by an ulp).  Every other
    leaf, and the first layer's against the default compile, within 5e-2
    of its largest entry (the ssm family's bound): later states are
    computed from bf16 activations that each rounding flip upstream moves
    by an ulp, and the RG-LRU carries such a move across steps;
  * rows that are not live keep every leaf bit for bit.
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
from repro.models.model import cache_batch_axis as jax_batch_axis  # noqa: E402
from repro.models.model import make_plan as jax_make_plan  # noqa: E402
from repro.models.params import ParamSpec as JaxParamSpec  # noqa: E402
from repro_torch.bridge import cache_from_numpy, cache_to_numpy, \
    params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.models.model import Model, cache_batch_axis, \
    plan_layers  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402

ARCH = "recurrentgemma-2b"
MAX_LEN = 64
LOGIT_TOL = 2e-2
CLEAR_MARGIN = 2e-2
STATE_TOL = 1e-4
BF16_FLIP = 2.0 ** -6
DEFAULT_STATE_TOL = 5e-2
D = 4
LAYERS = (3, 5)


def _cfgs(n_layers):
    return (dataclasses.replace(jax_reduced_config(ARCH),
                                num_layers=n_layers),
            dataclasses.replace(get_reduced_config(ARCH),
                                num_layers=n_layers))


def _tokens(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


def _tt(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _np(x):
    return np.asarray(x, np.float32)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _exact(fn, *args):
    """A reference function compiled without XLA's excess precision."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _default(fn, *args):
    return jax.jit(fn)(*args)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: as fast
    alone, and the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    out = {}
    for n in LAYERS:
        jcfg, tcfg = _cfgs(n)
        jmodel = build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        tparams = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        out[n] = (jmodel, jparams, Model(tcfg), tparams)
    return out


def _set_row(cache, row, i):
    """The reference's batched cache with batch-1 ``row`` in row ``i``
    (batch axis 1 under ``blocks``, 0 elsewhere)."""
    def put(path, c, r):
        ax = jax_batch_axis(path)
        idx = (slice(None),) * ax + (i,)
        return c.at[idx].set(r[(slice(None),) * ax + (0,)])
    return jax.tree_util.tree_map_with_path(put, cache, row)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assert_state(got, want, exact):
    """The port's cache leaves (numpy, float32) against ``want``'s at the
    module's tolerances: every leaf when ``want`` rounds as the port does
    (``exact``), else the first layer's."""
    for path, t in tree_leaves_with_path(got):
        j = _leaf(want, path)
        if path[-1] == "pos":
            np.testing.assert_array_equal(t, j, err_msg=str(path))
            continue
        first = path[:2] == ("blocks", "rec_0")
        if first:
            t, j = t[0], j[0]
        if exact and first:
            tol = STATE_TOL if path[-1] == "h" else BF16_FLIP
        elif exact or first:
            tol = DEFAULT_STATE_TOL
        else:
            continue
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=tol * max(np.abs(j).max(), 1.0),
                                   err_msg=str(path))


def _assert_logits(got, want):
    """Within LOGIT_TOL, and the same argmax where the reference's top
    two are clear."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > CLEAR_MARGIN
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


# --------------------------------------------------------------------------
# plan and trees
# --------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["full", "reduced", "epilogue"])
def test_plan_matches_reference(which):
    if which == "full":
        jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    else:
        jcfg, tcfg = _cfgs(3 if which == "reduced" else 5)
    got, want = plan_layers(tcfg), jax_make_plan(jcfg)
    assert (got.prologue, got.scan_kinds, got.n_groups, got.epilogue) == \
        (want.prologue, want.scan_kinds, want.n_groups, want.epilogue)
    if which == "full":
        assert got.scan_kinds == ("rec", "rec", "attn_local")
        assert (got.n_groups, got.epilogue) == (8, ("rec", "rec"))


def _spec_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxParamSpec))
    return {tuple(p.key for p in path): s for path, s in flat}


@pytest.mark.parametrize("which", ["full", "epilogue"])
def test_trees_match_reference(which):
    """Parameter and cache specs under the same paths, shapes, axes and
    dtypes; a fresh cache's ring positions are -1, every other leaf 0."""
    jcfg, tcfg = ((jax_config(ARCH), get_config(ARCH)) if which == "full"
                  else _cfgs(5))
    jmodel, tmodel = build_model(jcfg), Model(tcfg)
    for got, want in ((tmodel.param_specs(), jmodel.param_specs()),
                      (tmodel.cache_specs(3, MAX_LEN),
                       jmodel.cache_specs(3, MAX_LEN))):
        want = _spec_leaves(want)
        got = dict(tree_leaves_with_path(got))
        assert set(got) == set(want)
        for path, spec in got.items():
            assert spec.shape == want[path].shape, path
            assert spec.axes == want[path].axes, path
            assert str(spec.dtype).rsplit(".", 1)[-1] == \
                np.dtype(want[path].dtype).name, path
    if which == "full":
        return
    cache = tmodel.init_cache(3, MAX_LEN, "cpu")
    jcache = _f32(jmodel.init_cache(3, MAX_LEN))
    for path, leaf in tree_leaves_with_path(cache):
        assert torch.all(leaf == (-1 if path[-1] == "pos" else 0)), path
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      _leaf(jcache, path))
        assert cache_batch_axis(path) == (1 if path[0] == "blocks" else 0)
    assert {p[0] for p, _ in tree_leaves_with_path(cache)} == \
        {"blocks", "epi_0", "epi_1"}
    assert not tmodel.paged_leaf_paths()
    assert tmodel.has_recurrent_leaves()
    assert not tmodel.all_cache_leaves_paged()


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def _run_both(pair, seed, run):
    """Prefill 40 tokens (the ring wraps), one decode step, a padded
    16-token chunk holding 11 real tokens, then one more decode step."""
    jmodel, jp, tmodel, tp = pair
    toks = np.stack([_tokens(seed, 40), _tokens(seed + 1, 40)])
    jl1, jc = run(lambda p, x, c: jmodel.prefill(p, {"tokens": x}, c),
                  jp, jnp.asarray(toks), jmodel.init_cache(2, MAX_LEN))
    tl1, tc = tmodel.prefill(tp, {"tokens": _tt(toks)},
                             tmodel.init_cache(2, MAX_LEN, "cpu"))
    out = [(tl1, jl1)]
    nxt = np.argmax(_np(jl1), -1).astype(np.int32)
    step = (lambda p, x, c, t: jmodel.decode_step(p, {"tokens": x}, c, t))
    jl2, jc = run(step, jp, jnp.asarray(nxt), jc,
                  jnp.asarray([40, 40], jnp.int32))
    tl2, tc = tmodel.decode_step(tp, {"tokens": _tt(nxt)}, tc, _tt([40, 40]))
    out.append((tl2, jl2))
    chunk = np.stack([_tokens(seed + 2, 16), _tokens(seed + 3, 16)])
    jl3, jc = run(lambda p, x, c: jmodel.prefill_chunk(
        p, {"tokens": x}, c, jnp.int32(41), jnp.int32(11)),
        jp, jnp.asarray(chunk), jc)
    tl3, tc = tmodel.prefill_chunk(tp, {"tokens": _tt(chunk)}, tc, 41, 11)
    out.append((tl3, jl3))
    nxt = np.argmax(_np(jl3), -1).astype(np.int32)
    jl4, jc = run(step, jp, jnp.asarray(nxt), jc,
                  jnp.asarray([52, 52], jnp.int32))
    tl4, tc = tmodel.decode_step(tp, {"tokens": _tt(nxt)}, tc, _tt([52, 52]))
    out.append((tl4, jl4))
    return out, cache_to_numpy(tc), _f32(jc)


@pytest.mark.parametrize("n_layers", LAYERS)
@pytest.mark.parametrize("exact", [True, False])
def test_entry_points_match_reference(models, n_layers, exact):
    logits, tcache, jcache = _run_both(models[n_layers], seed=30 + n_layers,
                                       run=_exact if exact else _default)
    for got, want in logits:
        _assert_logits(got.numpy(), want)
    _assert_state(tcache, jcache, exact)


def test_chunk_takes_the_device_scalars(models):
    """``t0`` and ``valid_len`` as 0-d tensors (the engine's static
    inputs) give what host ints give, bit for bit."""
    _, _, tmodel, tp = models[5]
    prompt = _tt(_tokens(7, 16))[None]
    outs = []
    for t0, vl in ((0, 13), (torch.tensor(0), torch.tensor(13))):
        cache = tmodel.init_cache(1, MAX_LEN, "cpu")
        logits, cache = tmodel.prefill_chunk(tp, {"tokens": prompt}, cache,
                                             t0, vl)
        outs.append((logits, cache_to_numpy(cache)))
    assert torch.equal(outs[0][0], outs[1][0])
    for path, leaf in tree_leaves_with_path(outs[0][1]):
        np.testing.assert_array_equal(leaf, _leaf(outs[1][1], path))


# prompt length -> token seed: the reference's greedy continuation from
# these prompts stays clear of near ties for STREAM_LEN steps on both
# the 3- and the 5-layer model (``test_prompts_are_clear_of_ties``)
PROMPT_SEEDS = {3: 128, 7: 118, 10: 126, 21: 122}
STREAM_LEN = D + 2


def _prompt(n):
    return _tokens(PROMPT_SEEDS[n], n)


_JITTED: dict = {}


def _jitted(jmodel):
    """The reference's prefill and decode step, jitted once per model."""
    if id(jmodel) not in _JITTED:
        _JITTED[id(jmodel)] = (
            jax.jit(lambda p, x, c: jmodel.prefill(p, {"tokens": x}, c)),
            jax.jit(lambda p, x, c, t: jmodel.decode_step(
                p, {"tokens": x}, c, t)))
    return _JITTED[id(jmodel)]


def _greedy(jmodel, jp, n):
    """The reference's prefilled batch-1 cache, first logits, and greedy
    stream of STREAM_LEN steps with the top-2 margin of each."""
    prefill, step = _jitted(jmodel)
    lg, row = prefill(jp, jnp.asarray(_prompt(n))[None],
                      jmodel.init_cache(1, MAX_LEN))
    cache, stream, margins = row, [], []
    for i in range(STREAM_LEN):
        top2 = np.sort(_np(lg[0]))[-2:]
        margins.append(float(top2[1] - top2[0]))
        stream.append(int(np.argmax(_np(lg[0]))))
        lg, cache = step(jp, jnp.asarray(stream[-1:], jnp.int32), cache,
                         jnp.asarray([n + i], jnp.int32))
    return row, np.array(stream, np.int32), np.array(margins)


@pytest.fixture(scope="module")
def streams(models):
    return {(nl, n): _greedy(models[nl][0], models[nl][1], n)
            for nl in LAYERS for n in PROMPT_SEEDS}


@pytest.mark.parametrize("n_layers", LAYERS)
def test_prompts_are_clear_of_ties(streams, n_layers):
    for n in PROMPT_SEEDS:
        margins = streams[(n_layers, n)][2]
        assert margins.min() > CLEAR_MARGIN, (n, margins)


def _batched(models, streams, n_layers, lens):
    """Both sides' batched caches holding the reference's prefilled rows
    (the port's bridged from them), each row's first token and
    position."""
    jmodel = models[n_layers][0]
    jc = jmodel.init_cache(len(lens), MAX_LEN)
    for i, n in enumerate(lens):
        jc = _set_row(jc, streams[(n_layers, n)][0], i)
    tc = cache_from_numpy(jax.tree_util.tree_map(np.asarray, jc),
                          device="cpu")
    first = np.array([streams[(n_layers, n)][1][0] for n in lens], np.int32)
    return jc, tc, first, np.asarray(lens, np.int32)


QUANTUM_CASES = [((3, 10, 21), (4, 0, 2), 4), ((7, 21), (1, 2), 2)]


@pytest.mark.parametrize("n_layers", LAYERS)
@pytest.mark.parametrize("lens,n_left,k", QUANTUM_CASES)
def test_decode_quantum_matches_jax(models, streams, n_layers, lens, n_left,
                                    k):
    """Tokens equal the reference's fused quantum; a row with no budget
    keeps every leaf bit for bit, written in place."""
    jmodel, jp, tmodel, tp = models[n_layers]
    jc, tc, first, pos = _batched(models, streams, n_layers, lens)
    nl = np.asarray(n_left, np.int32)
    jblock, jc, jpos = jax.jit(
        lambda p, t, c, q, n: jmodel.decode_quantum(p, t, c, q, n, k))(
        jp, jnp.asarray(first), jc, jnp.asarray(pos), jnp.asarray(nl))
    before = cache_to_numpy(tc)
    tblock, tc2, tpos = tmodel.decode_quantum(tp, _tt(first), tc, _tt(pos),
                                              _tt(nl), k)
    assert tc2 is tc
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    jblock = np.asarray(jblock)
    for i, n in enumerate(lens):
        np.testing.assert_array_equal(tblock[:n_left[i], i].numpy(),
                                      jblock[:n_left[i], i])
        np.testing.assert_array_equal(
            jblock[:n_left[i], i], streams[(n_layers, n)][1][1:1 + n_left[i]])
    after = cache_to_numpy(tc)
    _assert_state(after, _f32(jc), exact=False)
    for path, leaf in tree_leaves_with_path(after):
        ax = cache_batch_axis(path)
        for i in range(len(lens)):
            same = np.array_equal(np.take(leaf, i, axis=ax),
                                  np.take(_leaf(before, path), i, axis=ax))
            assert same == (n_left[i] == 0), (path, i)


# --------------------------------------------------------------------------
# speculative verify
# --------------------------------------------------------------------------
VERIFY_LENS = (3, 10, 21)


def _drafts(models, streams, n_layers):
    """Row 0 rejects the first draft, row 1 accepts two, row 2 all d."""
    cont = np.stack([streams[(n_layers, n)][1][1:D + 1]
                     for n in VERIFY_LENS])
    drafts = cont.copy()
    drafts[0, 0] = (drafts[0, 0] + 1) % 256
    drafts[1, 2] = (drafts[1, 2] + 1) % 256
    return drafts


@pytest.mark.parametrize("n_layers", LAYERS)
def test_verify_quantum_matches_jax(models, streams, n_layers):
    """Acceptance 0, 2 and d on the three rows; row 2's budget (3) caps
    its emission below its acceptance.  Block, ``n_emit``, ``accepted``
    and positions equal the reference's; the restored state is the
    reference's at the module's tolerance."""
    jmodel, jp, tmodel, tp = models[n_layers]
    jc, tc, first, pos = _batched(models, streams, n_layers, VERIFY_LENS)
    drafts = _drafts(models, streams, n_layers)
    n_left = np.asarray((D + 1, D + 1, 3), np.int32)
    jblock, jn, ja, jc2, jpos = _exact(
        jmodel.verify_quantum, jp, jnp.asarray(first), jnp.asarray(drafts),
        jc, jnp.asarray(pos), jnp.asarray(n_left))
    tblock, tn, ta, tc2, tpos = tmodel.verify_quantum(
        tp, _tt(first), _tt(drafts), tc, _tt(pos), _tt(n_left))
    assert tc2 is tc
    np.testing.assert_array_equal(np.asarray(ja), [0, 2, D])
    np.testing.assert_array_equal(np.asarray(jn), [1, 3, 3])
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    jblock = np.asarray(jblock)
    for i in range(3):
        np.testing.assert_array_equal(tblock[:int(jn[i]), i].numpy(),
                                      jblock[:int(jn[i]), i])
    _assert_state(cache_to_numpy(tc), _f32(jc2), exact=True)


@pytest.mark.parametrize("n_layers", LAYERS)
def test_restore_pass_equals_plain_steps(models, streams, n_layers):
    """After a verify that emits ``n_emit`` = 0, 1, 3 and 5 tokens per
    row, every row's state is the state after ``n_emit`` plain decode
    steps of the same tokens, at the module's state tolerances (the
    chunk's attention sums the ring and its own keys in one softmax where
    the steps attend the ring); the row at 0 keeps every leaf bit for
    bit."""
    _, _, tmodel, tp = models[n_layers]
    lens = (3, 7, 10, 21)
    _, tc, first, pos = _batched(models, streams, n_layers, lens)
    plain = cache_from_numpy(cache_to_numpy(tc), device="cpu")
    before = cache_to_numpy(tc)
    # drafts: each row's own greedy continuation, so every draft holds
    drafts = np.stack([streams[(n_layers, n)][1][1:D + 1] for n in lens])
    n_left = np.asarray((0, 1, 3, D + 1), np.int64)
    _, n_emit, _, _, _ = tmodel.verify_quantum(
        tp, _tt(first), _tt(drafts), tc, _tt(pos), _tt(n_left))
    np.testing.assert_array_equal(n_emit.numpy(), n_left)
    seq = np.concatenate([first[:, None], drafts], axis=1)
    for j in range(D + 1):
        tmodel.decode_step(tp, {"tokens": _tt(seq[:, j])}, plain,
                           _tt(pos + j), live=_tt(n_left > j).bool())
    got, want = cache_to_numpy(tc), cache_to_numpy(plain)
    _assert_state(got, want, exact=True)
    for path, leaf in tree_leaves_with_path(got):
        ax = cache_batch_axis(path)
        np.testing.assert_array_equal(np.take(leaf, 0, axis=ax),
                                      np.take(_leaf(before, path), 0,
                                              axis=ax))


# --------------------------------------------------------------------------
# the ring wraps: chunked prefill against monolithic
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_layers", LAYERS)
def test_window_ring_wrap_chunked_matches_monolithic(models, n_layers):
    """A prompt longer than the window (32 + 13 tokens): 16-token chunks
    reproduce the monolithic prefill's ring and its decode stream (the
    port of ``tests/test_prefill_chunking.py``'s ring-wrap test), and
    both streams equal the reference's."""
    jmodel, jp, tmodel, tp = models[n_layers]
    window = tmodel.cfg.rglru.window_size
    n = window + 13
    prompt = _tokens(11, n)

    def decode_tail(cache, logits, steps=4):
        out = [int(logits[0].argmax())]
        for i in range(steps):
            logits, cache = tmodel.decode_step(
                tp, {"tokens": _tt(out[-1:])}, cache, n + i)
            out.append(int(logits[0].argmax()))
        return out, cache

    lg, cache = tmodel.prefill(tp, {"tokens": _tt(prompt)[None]},
                               tmodel.init_cache(1, 2 * window, "cpu"))
    want, mono = decode_tail(cache, lg)
    cache = tmodel.init_cache(1, 2 * window, "cpu")
    done, c = 0, 16
    while done < n:
        valid = min(c, n - done)
        toks = np.zeros(c, np.int32)
        toks[:valid] = prompt[done:done + valid]
        lg, cache = tmodel.prefill_chunk(tp, {"tokens": _tt(toks)[None]},
                                         cache, done, valid)
        done += valid
    got, chunked = decode_tail(cache, lg)
    assert got == want
    _assert_state(cache_to_numpy(chunked), cache_to_numpy(mono), exact=True)
    # the reference's own stream
    prefill, step = _jitted(jmodel)
    jlg, jcache = prefill(jp, jnp.asarray(prompt)[None],
                          jmodel.init_cache(1, 2 * window))
    ref = [int(np.argmax(_np(jlg[0])))]
    for i in range(4):
        jlg, jcache = step(jp, jnp.asarray(ref[-1:], jnp.int32), jcache,
                           jnp.asarray([n + i], jnp.int32))
        ref.append(int(np.argmax(_np(jlg[0]))))
    assert got == ref
