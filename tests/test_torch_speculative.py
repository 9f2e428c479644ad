"""The port's speculative decode quanta against the JAX package on the CPU,
at the model level (reduced gemma-2b, dense and paged, and reduced
mamba2-780m; the JAX parameters bridged over; ``MAX_LEN`` 64).

  * ``NgramDrafter`` (the port's copy, numpy only) equals the reference's
    on its own cases, on seeded random histories and on ``hypothesis``
    histories, for several depths and n-gram ranges.
  * ``verify_quantum`` against the JAX one on the same tokens, drafts,
    positions, budgets and starting cache: drafts built from the
    reference's greedy continuation give per-row acceptance 0, partial
    (2) and full (d).  The prompts are chosen so that the reference's top
    two logits are more than ``CLEAR_MARGIN`` apart along that
    continuation (the test holds this), so block, ``n_emit``, ``accepted``
    and positions must be equal; KV caches within the model tests' 2e-2,
    SSM state within their conv / SSD bounds.
  * a paged verify equals the dense verify bit for bit (the plain paged
    attention gathers, then attends as the dense one does).
  * rows that are not live keep their cache bit for bit (dense rows,
    their pages, conv and SSD state), where the reference writes them.
  * the restore pass: the SSM state after a verify that emits ``n_emit``
    tokens equals the state after ``n_emit`` plain decode steps, and is
    bit-equal to the state carried in where ``n_emit`` is 0.
  * indices: a verify with a row at ``max_len - 1 - d``, a frozen row
    whose positions run past the row, and a live row that runs past it
    neither raises nor changes a frozen row (dense and paged).
  * ``spec_quantum`` raises ``StaticArgError`` on a bad key.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving.speculative import NgramDrafter as RefDrafter  # noqa: E402
from repro_torch.bridge import cache_from_numpy, cache_to_numpy, \
    params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.speculative import NgramDrafter  # noqa: E402
from repro_torch.serving.version_cache import StaticArgError, \
    VersionCache  # noqa: E402
from test_torch_model import CONV_TOL, SSD_STATE_TOL  # noqa: E402

MAX_LEN = 64
D = 4
PAGE = 8
N_PAGES = 24
# the model tests' tolerance on logits and bf16 KV entries, port against
# the reference as it compiles by default (tests/test_torch_model.py)
KV_TOL = 2e-2
# twice the largest logit difference measured between the port and the
# reference (tests/test_torch_model.py)
CLEAR_MARGIN = 2e-2
# per arch: (prompt length, seed of its tokens) of the three rows, picked
# so that the reference's greedy continuation stays clear of near ties
# for d + 1 tokens (``test_verify_prompts_are_clear_of_ties``)
PROMPTS = {"gemma-2b": ((3, 102), (7, 105), (10, 101)),
           "mamba2-780m": ((4, 101), (13, 100), (6, 101))}
CASES = ("gemma-2b", "gemma-2b-paged", "mamba2-780m")


def _tokens(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


def _tt(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in PROMPTS:
        jcfg = jax_reduced_config(name)
        jmodel = build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        tparams = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        out[name] = (jmodel, jparams, Model(get_reduced_config(name)),
                     tparams)
    return out


@pytest.fixture(scope="module")
def prepared(models):
    """Per arch: the reference's prefilled (B=3) cache, each row's first
    token and position, and its greedy continuation of d + 1 tokens with
    the top-2 logit margins along it."""
    out = {}
    for name, rows in PROMPTS.items():
        jmodel, jp, _, _ = models[name]
        prefill = jax.jit(lambda p, x, c: jmodel.prefill(p, {"tokens": x}, c))
        step = jax.jit(lambda p, x, c, t: jmodel.decode_step(
            p, {"tokens": x}, c, t))
        cache = jmodel.init_cache(len(rows), MAX_LEN)
        first = []
        for i, (n, seed) in enumerate(rows):
            lg, row = prefill(jp, jnp.asarray(_tokens(seed, n))[None],
                              jmodel.init_cache(1, MAX_LEN))
            cache = jax.tree_util.tree_map(
                lambda c, r: c.at[:, i].set(r[:, 0]), cache, row)
            first.append(int(jnp.argmax(lg[0])))
        pos = np.array([n for n, _ in rows], np.int32)
        tok, c = jnp.asarray(first, jnp.int32), cache
        cont, margins = [], []
        for j in range(D + 1):
            lg, c = step(jp, tok, c, jnp.asarray(pos + j))
            srt = np.sort(np.asarray(lg, np.float32), axis=-1)
            margins.append(srt[:, -1] - srt[:, -2])
            tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            cont.append(np.asarray(tok))
        out[name] = (cache, np.array(first, np.int32), pos,
                     np.stack(cont, 1), np.stack(margins, 1))
    return out


def _drafts(cont, vocab):
    """Row 0 rejects the first draft, row 1 accepts two, row 2 all d."""
    drafts = cont[:, :D].copy()
    drafts[0, 0] = (drafts[0, 0] + 1) % vocab
    drafts[1, 2] = (drafts[1, 2] + 1) % vocab
    return drafts


def _paged_np(dense, table, n_pages):
    """A paged numpy cache holding a dense one's rows at ``table``'s pages
    (the trash page and the spare pages hold garbage)."""
    rng = np.random.default_rng(0)
    out = {}
    for leaf in ("k", "v"):
        rows = np.asarray(dense["blocks"]["dense"][leaf], np.float32)
        nl, b = rows.shape[:2]
        pool = 8.0 * rng.standard_normal(
            (nl, n_pages + 1, PAGE, *rows.shape[3:])).astype(np.float32)
        for i in range(b):
            pool[:, table[i]] = rows[:, i].reshape(nl, -1, PAGE,
                                                   *rows.shape[3:])
        out[leaf] = pool.astype(jnp.bfloat16)
    return {"blocks": {"dense": out}, "page_table": table}


def _table(b):
    n_slot = MAX_LEN // PAGE
    rng = np.random.default_rng(21)
    return (rng.permutation(np.arange(1, N_PAGES + 1))[:b * n_slot]
            .reshape(b, n_slot).astype(np.int32))


def _gathered(cache_np, table):
    """A paged numpy cache's k/v read through ``table`` as dense rows."""
    out = {}
    for leaf in ("k", "v"):
        rows = np.asarray(cache_np["blocks"]["dense"][leaf],
                          np.float32)[:, table]
        out[leaf] = rows.reshape(rows.shape[0], table.shape[0], -1,
                                 *rows.shape[4:])
    return out


def _start(models, prepared, case):
    """(arch, jmodel, jp, tmodel, tp, numpy starting cache, first, pos,
    cont, margins, table or None)."""
    arch = case.replace("-paged", "")
    jmodel, jp, tmodel, tp = models[arch]
    cache, first, pos, cont, margins = prepared[arch]
    cache_np = jax.tree_util.tree_map(np.asarray, cache)
    table = None
    if case.endswith("-paged"):
        table = _table(len(first))
        cache_np = _paged_np(cache_np, table, N_PAGES)
    return (arch, jmodel, jp, tmodel, tp, cache_np, first, pos, cont,
            margins, table)


_JAX_VERIFY: dict = {}


def _jax_verify(jmodel):
    """The reference's verify, jitted once per model (it retraces per
    cache structure, dense or paged)."""
    if id(jmodel) not in _JAX_VERIFY:
        _JAX_VERIFY[id(jmodel)] = jax.jit(jmodel.verify_quantum)
    return _JAX_VERIFY[id(jmodel)]


def _verify_both(models, prepared, case, n_left, drafts=None):
    (arch, jmodel, jp, tmodel, tp, cache_np, first, pos, cont, _,
     table) = _start(models, prepared, case)
    if drafts is None:
        drafts = _drafts(cont, tmodel.cfg.vocab_size)
    n_left = np.asarray(n_left, np.int32)
    jout = _jax_verify(jmodel)(
        jp, jnp.asarray(first), jnp.asarray(drafts),
        jax.tree_util.tree_map(jnp.asarray, cache_np), jnp.asarray(pos),
        jnp.asarray(n_left))
    tcache = cache_from_numpy(cache_np, device="cpu")
    tout = tmodel.verify_quantum(tp, _tt(first), _tt(drafts), tcache,
                                 _tt(pos), _tt(n_left))
    assert tout[3] is tcache               # updated in place
    return jout, tout, cache_np, pos, table


def test_drafter_prompt_lookup():
    """The reference's own cases, on the port's drafter."""
    d = NgramDrafter(depth=3, max_ngram=2)
    assert d.draft([1, 2, 9, 9, 1, 2]).tolist() == [9, 9, 1]
    assert d.draft([1, 2, 3, 1, 2, 4, 1, 2]).tolist() == [4, 1, 2]
    assert d.draft([7, 5, 6, 7, 5]).tolist() == [6, 7, 5]
    assert d.draft([3, 8, 3]).tolist() == [8, 3, 3]
    assert d.draft([1, 2, 3, 4, 5]) is None
    assert d.draft([4]) is None
    assert d.draft([1, 2, 1, 2], depth=1).tolist() == [1]


@pytest.mark.parametrize("kw", [{"depth": 0}, {"min_ngram": 0},
                                {"max_ngram": 1, "min_ngram": 2}])
def test_drafter_rejects_bad_arguments(kw):
    with pytest.raises(ValueError):
        NgramDrafter(**kw)
    with pytest.raises(ValueError):
        RefDrafter(**kw)


def _same_drafts(hist, depth, max_ngram, min_ngram, ask):
    got = NgramDrafter(depth, max_ngram, min_ngram).draft(hist, ask)
    want = RefDrafter(depth, max_ngram, min_ngram).draft(hist, ask)
    if want is None:
        assert got is None, (hist, got)
    else:
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    return want is not None


@pytest.mark.parametrize("seed", range(4))
def test_drafter_matches_reference_on_seeded_histories(seed):
    rng = np.random.default_rng(seed)
    hits = 0
    for _ in range(200):
        alphabet = int(rng.integers(2, 12))
        hist = rng.integers(0, alphabet, int(rng.integers(1, 40)))
        min_ngram = int(rng.integers(1, 3))
        max_ngram = min_ngram + int(rng.integers(0, 3))
        ask = None if rng.random() < 0.5 else int(rng.integers(1, 7))
        hits += _same_drafts(hist, int(rng.integers(1, 6)), max_ngram,
                             min_ngram, ask)
    assert 0 < hits < 200          # both outcomes were met


try:
    from hypothesis import given
    from hypothesis import strategies as st
except ImportError:               # hypothesis is optional (tests/conftest.py)
    given = None

if given is not None:
    @given(hist=st.lists(st.integers(0, 5), min_size=1, max_size=48),
           depth=st.integers(1, 6), max_ngram=st.integers(1, 4),
           ask=st.one_of(st.none(), st.integers(1, 8)))
    def test_drafter_matches_reference_property(hist, depth, max_ngram, ask):
        _same_drafts(hist, depth, max_ngram, 1, ask)


@pytest.mark.parametrize("arch", sorted(PROMPTS))
def test_verify_prompts_are_clear_of_ties(prepared, arch):
    """The verify parity below needs the reference's top two logits more
    than CLEAR_MARGIN apart along each row's continuation (d + 1 tokens)."""
    margins = prepared[arch][4]
    assert margins.min() > CLEAR_MARGIN, margins


@pytest.mark.parametrize("case", CASES)
def test_verify_quantum_matches_jax(models, prepared, case):
    """Acceptance 0, 2 and d on the three rows; row 2's budget (3) caps
    its emission below its acceptance."""
    n_left = (D + 1, D + 1, 3)
    jout, tout, cache_np, pos, table = _verify_both(models, prepared, case,
                                                    n_left)
    jblock, jn, ja, jcache, jpos = (np.asarray(a) if not isinstance(a, dict)
                                    else a for a in jout)
    tblock, tn, ta, tcache, tpos = tout
    np.testing.assert_array_equal(ja, [0, 2, D])
    np.testing.assert_array_equal(jn, [1, 3, 3])
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_array_equal(tn.numpy(), jn)
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    assert tblock.shape == jblock.shape == (D + 1, 3)
    for i in range(3):
        np.testing.assert_array_equal(tblock[:jn[i], i].numpy(),
                                      jblock[:jn[i], i])
    got, want = cache_to_numpy(tcache), _f32(jcache)
    if case == "mamba2-780m":
        t, j = got["blocks"]["ssm"], want["blocks"]["ssm"]
        np.testing.assert_allclose(t["conv"], j["conv"], rtol=0,
                                   atol=CONV_TOL * np.abs(j["conv"]).max())
        np.testing.assert_allclose(
            t["ssd"], j["ssd"], rtol=0,
            atol=SSD_STATE_TOL[False] * np.abs(j["ssd"]).max())
        return
    if table is not None:
        np.testing.assert_array_equal(tcache["page_table"].numpy(), table)
        got, want = _gathered(got, table), _gathered(want, table)
    else:
        got, want = got["blocks"]["dense"], want["blocks"]["dense"]
    for leaf in ("k", "v"):
        for i in range(3):
            end = int(pos[i]) + D + 1      # pass 1 wrote the whole span
            np.testing.assert_allclose(got[leaf][:, i, :end],
                                       want[leaf][:, i, :end], rtol=0,
                                       atol=KV_TOL)


def test_verify_paged_equals_dense_bit_for_bit(models, prepared):
    n_left = (D + 1, 2, D + 1)
    _, dense, _, pos, _ = _verify_both(models, prepared, "gemma-2b", n_left)
    _, paged, _, _, table = _verify_both(models, prepared, "gemma-2b-paged",
                                         n_left)
    for a, b in zip(dense[:3] + dense[4:], paged[:3] + paged[4:]):
        assert torch.equal(a, b)
    got = _gathered(cache_to_numpy(paged[3]), table)
    want = cache_to_numpy(dense[3])["blocks"]["dense"]
    for leaf in ("k", "v"):
        for i in range(3):
            end = int(pos[i]) + D + 1
            np.testing.assert_array_equal(got[leaf][:, i, :end],
                                          want[leaf][:, i, :end])


@pytest.mark.parametrize("case", CASES)
def test_verify_frozen_rows_keep_their_cache(models, prepared, case):
    """A row with no budget emits nothing and keeps its cache bit for bit
    (the reference writes its KV span; the port writes nothing, or the
    trash page)."""
    (_, _, _, tmodel, tp, cache_np, first, pos, cont, _,
     table) = _start(models, prepared, case)
    tcache = cache_from_numpy(cache_np, device="cpu")
    before = cache_to_numpy(tcache)
    _, n_emit, _, _, new_pos = tmodel.verify_quantum(
        tp, _tt(first), _tt(_drafts(cont, tmodel.cfg.vocab_size)), tcache,
        _tt(pos), _tt([0, D + 1, 0]))
    assert n_emit.tolist() == [0, 3, 0]          # row 1 accepts two
    assert new_pos.tolist() == [pos[0], pos[1] + 3, pos[2]]
    after = cache_to_numpy(tcache)
    fam = "ssm" if case == "mamba2-780m" else "dense"
    for name, leaf in after["blocks"][fam].items():
        old = before["blocks"][fam][name]
        if table is not None:
            # the frozen rows' pages; the trash page takes their writes
            for i in (0, 2):
                np.testing.assert_array_equal(leaf[:, table[i]],
                                              old[:, table[i]])
            continue
        for i in (0, 2):
            np.testing.assert_array_equal(leaf[:, i], old[:, i])
        assert not np.array_equal(leaf[:, 1], old[:, 1])


def test_restore_pass_state_equals_n_emit_decode_steps(models, prepared):
    """mamba2: drafts equal to the greedy continuation, budgets 0, 2 and
    d + 1, so ``n_emit`` is the budget.  The conv and SSD state after the
    verify equal the state after ``n_emit`` plain decode steps (within the
    model tests' bounds: the verify scans five tokens in one chunk, the
    steps one at a time), and are bit-equal to the state carried in where
    ``n_emit`` is 0; the emitted tokens equal the steps' tokens."""
    (_, _, _, tmodel, tp, cache_np, first, pos, cont, _,
     _) = _start(models, prepared, "mamba2-780m")
    n_left = _tt([0, 2, D + 1])
    spec = cache_from_numpy(cache_np, device="cpu")
    block, n_emit, accepted, _, _ = tmodel.verify_quantum(
        tp, _tt(first), _tt(cont[:, :D]), spec, _tt(pos), n_left)
    assert n_emit.tolist() == [0, 2, D + 1]
    assert accepted.tolist() == [D] * 3
    plain = cache_from_numpy(cache_np, device="cpu")
    pblock, _, _ = tmodel.decode_quantum(tp, _tt(first), plain, _tt(pos),
                                         n_left, D + 1)
    for i, n in enumerate(n_emit.tolist()):
        assert block[:n, i].tolist() == pblock[:n, i].tolist()
    got = cache_to_numpy(spec)["blocks"]["ssm"]
    want = cache_to_numpy(plain)["blocks"]["ssm"]
    start = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   cache_np)["blocks"]["ssm"]
    for name, tol in (("conv", CONV_TOL), ("ssd", SSD_STATE_TOL[True])):
        np.testing.assert_array_equal(got[name][:, 0], start[name][:, 0])
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=tol * np.abs(want[name]).max())
        for i in (1, 2):
            assert not np.array_equal(got[name][:, i], start[name][:, i])


@pytest.mark.parametrize("case", ("gemma-2b", "gemma-2b-paged"))
def test_verify_rows_near_the_end_stay_inside_the_cache(models, prepared,
                                                        case):
    """Row 0 live at ``max_len - 1 - d`` (its span ends on the last
    position), row 1 frozen at ``max_len - 1`` (a slot whose positions run
    d past the row, as a mid-prefill slot's may), row 2 live at
    ``max_len - 2`` (runs past the row: the reference drops those writes;
    the port clamps them into the row, or the trash page).  Nothing
    raises, the frozen row keeps its cache, and row 0 writes its span as
    a verify further from the end does."""
    (_, _, _, tmodel, tp, cache_np, first, _, cont, _,
     table) = _start(models, prepared, case)
    pos = np.array([MAX_LEN - 1 - D, MAX_LEN - 1, MAX_LEN - 2])
    drafts = _drafts(cont, tmodel.cfg.vocab_size)
    tcache = cache_from_numpy(cache_np, device="cpu")
    before = cache_to_numpy(tcache)
    block, n_emit, _, _, _ = tmodel.verify_quantum(
        tp, _tt(first), _tt(drafts), tcache, _tt(pos), _tt([D + 1, 0, 1]))
    assert n_emit.tolist()[1] == 0 and bool(torch.isfinite(
        torch.as_tensor(block, dtype=torch.float32)).all())
    after = cache_to_numpy(tcache)
    if table is not None:
        before = _gathered(before, table)
        after = _gathered(after, table)
    else:
        before, after = before["blocks"]["dense"], after["blocks"]["dense"]
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(after[leaf][:, 1], before[leaf][:, 1])
        np.testing.assert_array_equal(after[leaf][:, 0, :pos[0]],
                                      before[leaf][:, 0, :pos[0]])
        np.testing.assert_array_equal(after[leaf][:, 2, :pos[2]],
                                      before[leaf][:, 2, :pos[2]])
        assert not np.array_equal(after[leaf][:, 0, pos[0]:],
                                  before[leaf][:, 0, pos[0]:])
    # row 0 alone, away from the other rows, writes the same span
    solo = cache_from_numpy(cache_np, device="cpu")
    tmodel.verify_quantum(tp, _tt(first), _tt(drafts), solo, _tt(pos),
                          _tt([D + 1, 0, 0]))
    solo = cache_to_numpy(solo)
    solo = (_gathered(solo, table) if table is not None
            else solo["blocks"]["dense"])
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(after[leaf][:, 0], solo[leaf][:, 0])


@pytest.mark.parametrize("k,d", [(3, 4), (4, 2.0), (4, True), (0, 4),
                                 (4, 0)])
def test_spec_quantum_rejects_bad_static_keys(models, k, d):
    vc = VersionCache(models["gemma-2b"][2])
    with pytest.raises(StaticArgError):
        vc.spec_quantum(vc.get({}), k, d, 2)
    fn = vc.spec_quantum(vc.get({}), 4, 2, 2)
    assert vc.spec_quantum(vc.get({}), 4, 2, 2) is fn
    assert vc.get({}).spec == {(4, 2): fn}


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
