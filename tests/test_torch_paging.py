"""The port's paged KV cache against the JAX package on the CPU (reduced
gemma-2b, the JAX parameters bridged over).

  * (a) the port's own ``PagePool`` against ``repro.serving.paging`` on a
    seeded random sequence of operations: identical return values and
    counters after every operation;
  * (b) ``paged_attention_plain`` (what the kernel wrapper runs on a CPU
    tensor) against the Pallas ``flash_attention_paged`` in interpret
    mode, in fp32 at 2e-4 (``tests/test_kernels.py``'s attention
    tolerance: the Pallas kernel runs its online softmax page by page,
    the plain version in one pass), with large garbage in the trash page,
    in unmapped pages and past each row's valid length; and bit for bit
    against the dense ``attention_plain`` on the gathered cache;
  * (c) paged cache specs, leaf paths and the paged cache itself against
    the reference's; a paged mamba2 engine raises ``ValueError`` on both;
  * (d) ``decode_step`` and ``decode_quantum`` on a paged cache: logits,
    KV and tokens bit-identical to the port's dense cache (and, on the
    JAX side, paged to dense under the exact compile of
    ``tests/test_torch_model.py``); port against JAX at 2e-2 on logits
    with identical tokens; frozen rows' pages bit-exact;
  * (e) the scenarios of ``tests/test_paged_cache.py`` on the port's
    engine, held against the JAX engine on the same traffic: port paged
    == port dense token for token, the same tokens as JAX paged up to a
    parting at an exact tie of the reference's logits (checked where it
    happens), and equal page counters, page headroom clamps, occupancy
    and host syncs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention_paged as jax_flash_attention_paged  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.model import path_keys  # noqa: E402
from repro.models.params import ParamSpec as JaxParamSpec  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import paging as jax_paging  # noqa: E402
from repro_torch.bridge import cache_to_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention_paged as fap  # noqa: E402
from repro_torch.kernels.flash_attention import attention_plain  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving import paging  # noqa: E402
from test_torch_core import shared_executables  # noqa: E402

MAX_LEN = 32
PAGE = 8
N_NEW = 4
ATTN_TOL = 2e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced_config("gemma-2b")
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    tcfg = get_reduced_config("gemma-2b")
    sides = {"jax": (jax_engine, jcfg, jparams, {}),
             "torch": (torch_engine, tcfg, tparams, {"device": "cpu"})}
    return sides, jmodel, Model(tcfg)


@pytest.fixture(autouse=True)
def _clean_dispatch():
    yield
    for mod in (dispatch, jax_dispatch):
        mod.clear_tile_overrides()
        mod.install_ladder(None)
    jax_dispatch.set_mode("xla")


# ---------------------------------------------------------------------------
# (a) the page pool


POOL_COUNTERS = ("committed", "peak_used", "requests", "conflicts",
                 "shared_hits", "cow_copies", "stalls", "free_pages",
                 "used_pages", "uncommitted_free", "published_pages")


# the reference's method names -> the port's
POOL_OPS = {"pages_for": "pages_for_tokens", "commit": "reserve",
            "uncommit": "unreserve", "alloc": "take_page",
            "retain": "retain_page", "release": "release_page",
            "refcount": "page_refcount", "publish": "publish_page",
            "lookup": "lookup_page", "lookup_covering": "lookup_covering_page"}


def _pool_op(side, pool, op):
    return getattr(pool, op if side == "jax" else POOL_OPS[op])


def _pool_state(side, pool, pages):
    return ({c: getattr(pool, c) for c in POOL_COUNTERS},
            {p: _pool_op(side, pool, "refcount")(p) for p in pages})


@pytest.mark.parametrize("seed", range(4))
def test_page_pool_matches_reference_on_random_operations(seed):
    """A seeded random walk over every operation, run on both pools with
    the same arguments: every return value and every counter equal."""
    rng = np.random.default_rng(seed)
    pools = {"jax": jax_paging.PagePool(6, 4), "torch": paging.PagePool(6, 4)}
    held: list[int] = []          # one entry per reference a holder owns
    chains = [(), (1,), (1, 2), (3, 1, 2, 0)]

    def toks():
        return tuple(int(t) for t in rng.integers(0, 3, rng.integers(0, 5)))

    for _ in range(300):
        op = rng.choice(["commit", "uncommit", "alloc", "retain", "release",
                         "publish", "lookup", "lookup_covering"])
        committed = pools["jax"].committed
        if op == "commit":
            args, kw = (int(rng.integers(0, 4)),), {}
        elif op == "uncommit":
            args, kw = (int(rng.integers(0, committed + 1)),), {}
        elif op == "alloc":
            args, kw = (), {"reserved": bool(committed and rng.random() < .6)}
        elif op in ("retain", "release", "publish"):
            if not held:
                continue
            page = held[int(rng.integers(len(held)))]
            if op == "release":
                held.remove(page)
            args, kw = ((chains[int(rng.integers(4))], toks(), page)
                        if op == "publish" else (page,)), {}
        else:
            args, kw = (chains[int(rng.integers(4))], toks()), {}
        got = {side: _pool_op(side, pool, op)(*args, **kw)
               for side, pool in pools.items()}
        assert got["torch"] == got["jax"], (op, args, kw, got)
        if op == "alloc" and got["jax"] is not None:
            held.append(got["jax"])
        elif op == "retain":
            held.append(args[0])
        pages = range(7)
        assert _pool_state("torch", pools["torch"], pages) == \
            _pool_state("jax", pools["jax"], pages), (op, args)
    assert pools["torch"].pages_for_tokens(9) == \
        pools["jax"].pages_for(9) == 3
    assert paging.TRASH_PAGE == jax_paging.TRASH_PAGE == 0


# ---------------------------------------------------------------------------
# (b) the kernel's plain version


def _paged_case(rng, b, ps, kh, n_slot, kvl):
    """Pools whose pages are shuffled across rows; every page a row does
    not map for a valid key (the trash page, unmapped entries, spare
    pages, the tail past kv_valid) holds garbage of magnitude ~1e4."""
    h, d = 4, 32
    n_pages = b * n_slot + 3
    kpool = 1e4 * rng.standard_normal((n_pages, ps, kh, d))
    vpool = 1e4 * rng.standard_normal((n_pages, ps, kh, d))
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, n_slot), np.int32)
    dense_k = rng.standard_normal((b, n_slot * ps, kh, d))
    dense_v = rng.standard_normal((b, n_slot * ps, kh, d))
    for i in range(b):
        mapped = -(-kvl[i] // ps)
        table[i, :mapped] = perm[i * n_slot:i * n_slot + mapped]
        # unmapped entries: the trash page or a spare page of garbage
        table[i, mapped:] = rng.choice([0, perm[-1]], n_slot - mapped)
        for j in range(mapped):
            lo, hi = j * ps, min((j + 1) * ps, kvl[i])
            kpool[table[i, j], :hi - lo] = dense_k[i, lo:hi]
            vpool[table[i, j], :hi - lo] = dense_v[i, lo:hi]
    q = rng.standard_normal((b, 1, h, d))
    return [a.astype(np.float32) for a in (q, kpool, vpool, dense_k,
                                           dense_v)] + [table]


# (page_size, kv heads, window, softcap)
PAGED_CASES = [(4, 1, None, None), (8, 2, None, None), (8, 1, 6, None),
               (4, 2, None, 30.0), (8, 2, 5, 20.0)]


@pytest.mark.parametrize("ps,kh,window,softcap", PAGED_CASES)
def test_paged_attention_plain_matches_pallas_interpret(ps, kh, window,
                                                        softcap):
    rng = np.random.default_rng(ps * 10 + kh)
    n_slot = 4
    kvl = np.array([1, 2 * ps + 3, n_slot * ps], np.int32)   # ragged
    offset = kvl - 1
    q, kp, vp, dk, dv, table = _paged_case(rng, 3, ps, kh, n_slot, kvl)
    want = jax_flash_attention_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        offset=jnp.asarray(offset), kv_valid_len=jnp.asarray(kvl),
        window=window, softcap=softcap, interpret=True)
    tt = {k: torch.from_numpy(v) for k, v in
          dict(q=q, kp=kp, vp=vp, dk=dk, dv=dv, table=table,
               off=offset, kvl=kvl).items()}
    got = fap.flash_attention_paged(
        tt["q"], tt["kp"], tt["vp"], tt["table"], offset=tt["off"],
        kv_valid_len=tt["kvl"], window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    dense = attention_plain(tt["q"], tt["dk"], tt["dv"], offset=tt["off"],
                            kv_valid_len=tt["kvl"], window=window,
                            softcap=softcap)
    assert torch.equal(got, dense)       # bit for bit on the gathered cache


def test_paged_attention_routes_and_counts_like_the_other_kernels():
    """The ops adapter takes q_positions[..., 0]; the dispatch hook reads
    no tile table; a CPU tensor runs the plain version and launches
    nothing; the gather helper and the ref alias are the plain version's."""
    rng = np.random.default_rng(3)
    kvl = np.array([5, 9], np.int32)
    q, kp, vp, _, _, table = _paged_case(rng, 2, 4, 1, 3, kvl)
    args = [torch.from_numpy(a) for a in (q, kp, vp)]
    pos = torch.from_numpy(kvl[:, None] - 1)
    want = ref.paged_attention_ref(*args, torch.from_numpy(table),
                                   offset=pos[:, 0],
                                   kv_valid_len=torch.from_numpy(kvl))
    before = fap.launch_count()
    with dispatch.tile_context({"attention": {"bq": 16, "bkv": 16}}):
        got = dispatch.get_paged_attention()(
            *args, page_table=torch.from_numpy(table), q_positions=pos,
            kv_valid_len=torch.from_numpy(kvl), window=None, softcap=None)
    assert torch.equal(got, want)
    assert torch.equal(got, ops.flash_attention_paged(
        *args, page_table=torch.from_numpy(table), q_positions=pos,
        kv_valid_len=torch.from_numpy(kvl)))
    assert fap.launch_count() == before
    gathered = fap.gather_pages(args[1], torch.from_numpy(table))
    assert gathered.shape == (2, 12, 1, 32)
    assert torch.equal(gathered[1, 4:8], args[1][table[1, 1]])


def test_paged_attention_wrapper_checks_shapes():
    q = torch.zeros(2, 1, 4, 32)
    pool = torch.zeros(5, 4, 1, 32)
    with pytest.raises(ValueError, match="page_table"):
        fap.flash_attention_paged(q, pool, pool,
                                  torch.zeros(3, 2, dtype=torch.int32),
                                  offset=0, kv_valid_len=1)
    with pytest.raises(ValueError, match="pools"):
        fap.flash_attention_paged(q, pool, pool[:, :, :, :16],
                                  torch.zeros(2, 2, dtype=torch.int32),
                                  offset=0, kv_valid_len=1)
    # the kernel's shared memory at gemma-2b's widths (8 query heads on one
    # KV head, head_dim 256, 32 table entries a row): the dense kernel's
    # block of 16 padded rows and 64-key tiles, then the staged entries
    assert fap.smem_bytes(8, 256, 32) == 152_768 + 128
    assert fap.smem_bytes(3, 32, 5) % 16 == 0


# ---------------------------------------------------------------------------
# (c) specs


def _jax_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxParamSpec))
    return {path_keys(p): (tuple(s.shape), jnp.dtype(s.dtype).name,
                           tuple(s.axes)) for p, s in flat}


def _torch_specs(tree):
    return {p: (tuple(s.shape), str(s.dtype).replace("torch.", ""),
                tuple(s.axes)) for p, s in tree_leaves_with_path(tree)}


def test_paged_specs_match_reference(setup):
    sides, jmodel, tmodel = setup
    assert tmodel.paged_leaf_paths() == jmodel.paged_leaf_paths() == \
        frozenset({("blocks", "dense", "k"), ("blocks", "dense", "v")})
    assert tmodel.all_cache_leaves_paged() and \
        jmodel.all_cache_leaves_paged()
    args = (3, MAX_LEN, 10, PAGE)
    assert _torch_specs(tmodel.paged_cache_specs(*args)) == \
        _jax_specs(jmodel.paged_cache_specs(*args))
    got = {p: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
           for p, a in tree_leaves_with_path(
               tmodel.init_paged_cache(*args, "cpu"))}
    want = {path_keys(p): (tuple(a.shape), str(a.dtype))
            for p, a in jax.tree_util.tree_flatten_with_path(
                jmodel.init_paged_cache(*args))[0]}
    assert got == want
    assert got[("page_table",)] == ((3, MAX_LEN // PAGE), "int32")
    for model in (tmodel, jmodel):
        with pytest.raises(ValueError, match="multiple"):
            model.paged_cache_specs(3, MAX_LEN, 10, 5)


def test_paged_mamba2_engine_raises_like_the_reference():
    jcfg = jax_reduced_config("mamba2-780m")
    tcfg = get_reduced_config("mamba2-780m")
    tparams = Model(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    assert Model(tcfg).paged_leaf_paths() == frozenset()
    with pytest.raises(ValueError, match="pageable"):
        torch_engine.ServingEngine(tcfg, tparams, batch_slots=1,
                                   max_len=MAX_LEN, page_size=PAGE,
                                   device="cpu")
    jparams = build_model(jcfg).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="pageable"):
        jax_engine.ServingEngine(jcfg, jparams, batch_slots=1,
                                 max_len=MAX_LEN, page_size=PAGE)


# ---------------------------------------------------------------------------
# (d) the model on a paged cache


def _exact(fn, *args):
    """The reference compiled without XLA's excess precision."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _paged_from_dense(dense, table, n_pages):
    """A paged numpy cache holding the rows of a dense one at ``table``'s
    pages (the trash page and spare pages hold garbage)."""
    rng = np.random.default_rng(0)
    out = {}
    for leaf in ("k", "v"):
        rows = dense["blocks"]["dense"][leaf]           # (L, B, T, K, D)
        nl, b, t = rows.shape[:3]
        pool = 8.0 * rng.standard_normal(
            (nl, n_pages + 1, PAGE, *rows.shape[3:])).astype(np.float32)
        for i in range(b):
            pool[:, table[i]] = rows[:, i].reshape(nl, -1, PAGE,
                                                   *rows.shape[3:])
        out[leaf] = pool
    return {"blocks": {"dense": out}, "page_table": table}


def _to_jax_cache(tree):
    def one(a):
        a = np.asarray(a)
        return jnp.asarray(a) if a.dtype == np.int32 else \
            jnp.asarray(a, jnp.bfloat16)
    return jax.tree_util.tree_map(one, tree)


def _prefilled(setup, b=3, lens=(7, 12, 3)):
    """Port dense cache prefilled with ``lens`` prompts (one row each) and
    each row's next token; plus a shuffled page table mapping each row's
    four logical pages."""
    _, _, tmodel = setup
    sides = setup[0]
    tp = sides["torch"][2]
    rng = np.random.default_rng(21)
    cache = tmodel.init_cache(b, MAX_LEN, "cpu")
    nxt = []
    for i, n in enumerate(lens):
        row = tmodel.init_cache(1, MAX_LEN, "cpu")
        toks = torch.from_numpy(rng.integers(0, 256, (1, n)))
        lg, row = tmodel.prefill(tp, {"tokens": toks}, row)
        for leaf in ("k", "v"):
            cache["blocks"]["dense"][leaf][:, i] = \
                row["blocks"]["dense"][leaf][:, 0]
        nxt.append(int(lg.argmax(-1)))
    n_slot = MAX_LEN // PAGE
    n_pages = b * n_slot + 2
    table = (rng.permutation(np.arange(1, n_pages + 1))[:b * n_slot]
             .reshape(b, n_slot).astype(np.int32))
    return cache, np.array(nxt), np.array(lens), table, n_pages


def _gathered(cache_np, table):
    """A paged numpy cache's k/v read through ``table`` as dense rows
    (L, B, T, K, D)."""
    out = {}
    for leaf in ("k", "v"):
        pool = np.asarray(cache_np["blocks"]["dense"][leaf], np.float32)
        rows = pool[:, table]                      # (L, B, n_slot, ps, ...)
        out[leaf] = rows.reshape(rows.shape[0], table.shape[0], -1,
                                 *rows.shape[4:])
    return out


def test_decode_step_on_paged_cache_bit_identical(setup):
    """On each side, a decode step on the paged cache gives the dense
    cache's logits and KV bit for bit.  Across the two sides the dense
    paths already differ by a bf16 rounding flip on one row (the q
    projection's bf16 product sums in another order on XLA's CPU backend
    than in PyTorch, ROADMAP C), so port against JAX is held at 2e-2 on
    logits (``tests/test_torch_model.py``) with the same argmax."""
    sides, jmodel, tmodel = setup
    jp, tp = sides["jax"][2], sides["torch"][2]
    dense, nxt, pos, table, n_pages = _prefilled(setup)
    dense_np = cache_to_numpy(dense)
    paged_np = _paged_from_dense(dense_np, table, n_pages)
    paged = params_from_numpy(paged_np, device="cpu")
    tt, tpos = torch.from_numpy(nxt), torch.from_numpy(pos)
    dl, dense = tmodel.decode_step(tp, {"tokens": tt}, dense, tpos)
    pl, paged = tmodel.decode_step(tp, {"tokens": tt}, paged, tpos)
    step = (lambda p, x, c, t: jmodel.decode_step(p, {"tokens": x}, c, t))
    jargs = (jp, jnp.asarray(nxt, jnp.int32))
    jpos = jnp.asarray(pos, jnp.int32)
    jdl, jdc = _exact(step, *jargs, _to_jax_cache(dense_np), jpos)
    jpl, jpc = _exact(step, *jargs, _to_jax_cache(paged_np), jpos)
    assert torch.equal(pl, dl)
    np.testing.assert_array_equal(np.asarray(jpl, np.float32),
                                  np.asarray(jdl, np.float32))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jpl, np.float32),
                               rtol=0, atol=2e-2)
    assert np.array_equal(pl.argmax(-1).numpy(), np.asarray(jpl).argmax(-1))
    # every row's keys up to and including the new token, read through the
    # table, equal the dense cache's on the same side
    got = _gathered(cache_to_numpy(paged), table)
    jgot = _gathered(jax.tree_util.tree_map(np.asarray, jpc), table)
    assert np.array_equal(np.asarray(jpc["page_table"]), table)
    want = cache_to_numpy(dense)["blocks"]["dense"]
    jwant = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   jdc)["blocks"]["dense"]
    for leaf in ("k", "v"):
        for i in range(3):
            upto = int(pos[i]) + 1
            np.testing.assert_array_equal(got[leaf][:, i, :upto],
                                          want[leaf][:, i, :upto])
            np.testing.assert_array_equal(jgot[leaf][:, i, :upto],
                                          jwant[leaf][:, i, :upto])


def test_decode_quantum_on_paged_cache_matches_dense_and_jax(setup):
    sides, jmodel, tmodel = setup
    jp, tp = sides["jax"][2], sides["torch"][2]
    dense, nxt, pos, table, n_pages = _prefilled(setup)
    paged_np = _paged_from_dense(cache_to_numpy(dense), table, n_pages)
    paged = params_from_numpy(paged_np, device="cpu")
    n_left = np.array([4, 1, 0])          # row 1 freezes, row 2 never runs
    args = [torch.from_numpy(a) for a in (nxt, pos, n_left)]
    dblock, _, dpos = tmodel.decode_quantum(tp, args[0], dense, args[1],
                                            args[2], 4)
    pblock, paged, ppos = tmodel.decode_quantum(tp, args[0], paged, args[1],
                                                args[2], 4)
    assert torch.equal(pblock, dblock) and torch.equal(ppos, dpos)
    jblock, _, jpos = _exact(
        lambda p, x, c, t, nl: jmodel.decode_quantum(p, x, c, t, nl, 4),
        jp, jnp.asarray(nxt, jnp.int32), _to_jax_cache(paged_np),
        jnp.asarray(pos, jnp.int32), jnp.asarray(n_left, jnp.int32))
    np.testing.assert_array_equal(pblock.numpy(), np.asarray(jblock))
    np.testing.assert_array_equal(ppos.numpy(), np.asarray(jpos))
    # frozen rows: every page of row 2, and row 1's pages past its one
    # step, hold exactly what they held before the quantum
    got = cache_to_numpy(paged)["blocks"]["dense"]
    before = paged_np["blocks"]["dense"]
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(got[leaf][:, table[2]],
                                      before[leaf][:, table[2]])
        row1 = got[leaf][:, table[1]].reshape(got[leaf].shape[0], MAX_LEN,
                                              *got[leaf].shape[3:])
        was1 = before[leaf][:, table[1]].reshape(row1.shape)
        np.testing.assert_array_equal(row1[:, pos[1] + 1:],
                                      was1[:, pos[1] + 1:])
        assert not np.array_equal(row1[:, pos[1]], was1[:, pos[1]])


def test_select_cache_rows_keeps_pools_and_table(setup):
    _, _, tmodel = setup
    old = tmodel.init_paged_cache(2, MAX_LEN, 4, PAGE, "cpu")
    new = {"blocks": {"dense": {k: v + 1 for k, v in
                                old["blocks"]["dense"].items()}},
           "page_table": old["page_table"] + 1}
    out = tmodel.select_cache_rows(torch.tensor([False, False]), new, old)
    for path, leaf in tree_leaves_with_path(out):
        want = new
        for k in path:
            want = want[k]
        assert leaf is want, path


# ---------------------------------------------------------------------------
# (e) engine scenarios of tests/test_paged_cache.py, JAX engine alongside


def _engine(side, **kw):
    mod, cfg, params, extra = side
    return mod.ServingEngine(cfg, params, max_len=MAX_LEN, **extra, **kw)


def _mixed_requests(mod, vocab):
    """Mixed-length prompts; even-indexed ones share a 10-token prefix."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, vocab, 10).astype(np.int32)
    reqs = []
    for i, extra in enumerate((3, 5, 7, 2, 9)):
        tail = rng.integers(0, vocab, extra).astype(np.int32)
        p = (np.concatenate([shared, tail]) if i % 2 == 0 else
             rng.integers(0, vocab, 8 + extra).astype(np.int32))
        reqs.append(mod.Request(rid=i, prompt=p, max_new_tokens=N_NEW))
    return reqs


def _staggered(side, paged, slots=3):
    eng = _engine(side, batch_slots=slots, page_size=PAGE if paged else None)
    reqs = _mixed_requests(side[0], side[1].vocab_size)
    assert eng.admit_request(reqs[0], drain=True)
    eng.step()
    for r in reqs[1:slots]:
        assert eng.admit_request(r, drain=True)
    eng.run_to_completion(reqs[slots:])
    return reqs, eng


def _prefix_sharing(side, paged):
    mod, cfg = side[0], side[1]
    rng = np.random.default_rng(11)
    base = rng.integers(0, cfg.vocab_size, 17).astype(np.int32)
    r0 = mod.Request(rid=0, prompt=base, max_new_tokens=6)
    r1 = mod.Request(rid=1, prompt=np.concatenate(
        [base[:10], rng.integers(0, cfg.vocab_size, 4).astype(np.int32)]),
        max_new_tokens=6)
    r2 = mod.Request(rid=2, prompt=base[:12].copy(), max_new_tokens=6)
    eng = _engine(side, batch_slots=3, page_size=PAGE if paged else None)
    assert eng.admit_request(r0, drain=True)
    eng.step_quantum(2)               # r0 publishes its prompt pages
    assert eng.admit_request(r1, drain=True)
    assert eng.admit_request(r2, drain=True)
    eng.run_to_completion([])
    return [r0, r1, r2], eng


def _max_len_minus_one(side, paged):
    mod, cfg = side[0], side[1]
    rng = np.random.default_rng(5)
    p = rng.integers(0, cfg.vocab_size, MAX_LEN - 1).astype(np.int32)
    eng = _engine(side, batch_slots=1, page_size=PAGE if paged else None)
    req = mod.Request(rid=0, prompt=p, max_new_tokens=N_NEW)
    eng.run_to_completion([req])
    return [req], eng


def _deferral(side, paged):
    """A request refused on page-pool exhaustion admits once the resident
    one frees its pages (the reused pages leak nothing)."""
    mod, cfg = side[0], side[1]
    rng = np.random.default_rng(13)
    a = rng.integers(0, cfg.vocab_size, 17).astype(np.int32)
    b = rng.integers(0, cfg.vocab_size, 17).astype(np.int32)
    ra = mod.Request(rid=0, prompt=a, max_new_tokens=N_NEW)
    rb = mod.Request(rid=1, prompt=b, max_new_tokens=N_NEW)
    kw = dict(page_size=PAGE, n_pages=4) if paged else {}
    eng = _engine(side, batch_slots=2, **kw)
    assert eng.admit_request(ra, drain=True)
    pages = eng.admission_pages(b, N_NEW)
    admitted = eng.admit_request(rb, drain=True)
    conflicts = eng.page_stats.get("conflicts", 0)
    eng.run_to_completion([] if admitted else [rb])
    eng.extra = (pages, admitted, conflicts)
    return [ra, rb], eng


SCENARIOS = {"staggered": _staggered, "prefix_sharing": _prefix_sharing,
             "max_len_minus_one": _max_len_minus_one, "deferral": _deferral}


@pytest.fixture(scope="module")
def runs(setup):
    """Every scenario once per (side, paged): (rid -> tokens, rid ->
    prompt, engine); every request ran to completion."""
    sides = setup[0]
    out = {}
    for name, fn in SCENARIOS.items():
        for side in ("jax", "torch"):
            for paged in (False, True):
                if side == "jax" and not paged:
                    continue
                reqs, eng = fn(sides[side], paged)
                assert all(r.done for r in reqs), (name, side, paged)
                out[name, side, paged] = ({r.rid: list(r.output)
                                           for r in reqs},
                                          {r.rid: r.prompt for r in reqs},
                                          eng)
    return out


def _parts_only_at_reference_ties(setup, got, want, prompts):
    """Token streams equal, or parting where the reference's own logits
    tie.  The JAX engine runs with XLA's excess precision (its default);
    compiled without it, as the port rounds, the reference's top two
    logits can tie exactly, and then the port's argmax (the first of the
    tied ids, as torch.argmax and jnp.argmax both pick) is the exact
    reference's and the default-compiled stream may take the other.  At a
    parting the exact-compiled reference prefill of the prompt and the
    agreed tokens must give both tokens the top logit."""
    _, jmodel, _ = setup
    jp = setup[0]["jax"][2]
    for rid, stream in got.items():
        if stream == want[rid]:
            continue
        t = next(i for i, (a, b) in enumerate(zip(stream, want[rid]))
                 if a != b)
        toks = np.concatenate([prompts[rid], np.asarray(stream[:t])])
        logits, _ = _exact(lambda p, x, c: jmodel.prefill(
            p, {"tokens": x}, c), jp, jnp.asarray(toks, jnp.int32)[None],
            jmodel.init_cache(1, MAX_LEN))
        lg = np.asarray(logits, np.float32)[0]
        assert lg[stream[t]] == lg[want[rid][t]] == lg.max(), \
            (rid, t, stream, want[rid])
        assert stream[t] == int(np.argmax(lg)), (rid, t)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_paged_engine_tokens_equal_dense_and_jax(setup, runs, scenario):
    """port paged == port dense token for token; against JAX paged the
    same tokens, except a parting at an exact tie of the reference (see
    ``_parts_only_at_reference_ties``); the same host syncs, page
    counters and occupancy as the JAX engine."""
    tp, prompts, te = runs[scenario, "torch", True]
    td, _, _ = runs[scenario, "torch", False]
    jp, _, je = runs[scenario, "jax", True]
    assert tp == td, (tp, td)
    _parts_only_at_reference_ties(setup, tp, jp, prompts)
    assert te.host_syncs == je.host_syncs
    assert te.tokens_decoded == je.tokens_decoded
    assert te.prefill_chunks == je.prefill_chunks
    assert te.page_stats == je.page_stats
    assert te.peak_cache_tokens == je.peak_cache_tokens
    assert te.peak_active_slots == je.peak_active_slots
    assert te.cache_utilization == je.cache_utilization
    assert te.pool.used_pages == 0 and te.pool.committed == 0


def test_release_drops_page_references(runs):
    """After all requests finish the pool drains (no leaked pages or
    commitment) and every table row, host and device, parks on the trash
    page."""
    eng = runs["staggered", "torch", True][2]
    assert eng.pool.used_pages == 0 and eng.pool.committed == 0
    assert np.all(eng._page_table == paging.TRASH_PAGE)
    eng._sync_table()
    assert torch.all(eng.cache["page_table"] == paging.TRASH_PAGE)
    dense = runs["staggered", "torch", False][2]
    assert dense.page_stats == {} and dense.pool is None
    # paged residency never exceeds the dense footprint at equal slots
    assert eng.pool.peak_used * PAGE <= dense.slots * dense.max_len
    assert eng.cache_utilization > 0


def test_prefix_sharing_and_copy_on_write(runs):
    eng = runs["prefix_sharing", "torch", True][2]
    st = eng.page_stats
    assert st["shared_hits"] >= 2, st     # r1 full page + r2 partial tail
    assert st["cow_copies"] >= 1, st      # r2's decode privatized its page


def test_slot_reuse_after_page_pool_deferral(runs):
    te = runs["deferral", "torch", True][2]
    je = runs["deferral", "jax", True][2]
    (needed, free), admitted, conflicts = te.extra
    assert te.extra == je.extra
    assert free is not None and needed > free
    assert not admitted and conflicts >= 1
    dense_extra = runs["deferral", "torch", False][2].extra
    assert dense_extra[0] == (0, None)


def test_prompt_of_exactly_max_len_minus_one(runs):
    out = runs["max_len_minus_one", "torch", True][0]
    assert len(out[0]) == 2               # prefill token + one decode step


def test_decode_k_headroom_clamps_like_the_reference(setup):
    """With one free page a 16-step quantum would cross two page
    boundaries: both engines clamp to the 8 steps the pool can map."""
    sides = setup[0]
    rng = np.random.default_rng(17)
    p = rng.integers(0, 256, PAGE).astype(np.int32)
    got = {}
    for name, side in sides.items():
        eng = _engine(side, batch_slots=1, page_size=PAGE, n_pages=2,
                      page_reserve="prompt")
        assert eng.admit_request(side[0].Request(rid=0, prompt=p,
                                                 max_new_tokens=16),
                                 drain=True)
        dense = _engine(side, batch_slots=1)
        got[name] = ([eng.decode_k_headroom(k) for k in (1, 4, 8, 9, 16)],
                     eng.pool.free_pages, dense.decode_k_headroom(16))
    assert got["torch"] == got["jax"]
    assert got["torch"] == ([1, 4, 8, 8, 8], 1, 16)


def test_warmup_mid_serving_keeps_resident_pages(setup):
    """Warm decodes run at position 0 with every slot aimed at the trash
    page, then the real table comes back: a paged engine warmed up with
    a request resident serves it as one that never warmed up."""
    side = setup[0]["torch"]
    outs = []
    for warm in (False, True):
        eng = _engine(side, batch_slots=2, page_size=PAGE)
        reqs = _mixed_requests(side[0], side[1].vocab_size)[:3]
        assert eng.admit_request(reqs[0], drain=True)
        eng.step_quantum(2)
        if warm:
            eng.warmup(levels=[0.0, 1.0])
            assert torch.equal(eng.cache["page_table"],
                               torch.from_numpy(eng._page_table))
        eng.run_to_completion(reqs[1:])
        outs.append(([list(r.output) for r in reqs], eng.page_stats))
    assert outs[0] == outs[1]


def test_monolithic_prefill_paged_matches_dense(setup):
    """``chunked_prefill=False``: the whole prompt prefills at admission
    and is scattered into pages; tokens equal the dense engine's."""
    side = setup[0]["torch"]
    outs = {}
    for paged in (False, True):
        eng = _engine(side, batch_slots=2, chunked_prefill=False,
                      page_size=PAGE if paged else None)
        reqs = _mixed_requests(side[0], side[1].vocab_size)
        eng.run_to_completion(reqs)
        assert all(r.done for r in reqs)
        outs[paged] = [list(r.output) for r in reqs]
        if paged:
            assert eng.pool.used_pages == 0 and eng.pool.committed == 0
            assert eng.page_stats["shared_hits"] == 0   # needs chunking
    assert outs[True] == outs[False]


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
