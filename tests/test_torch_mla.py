"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX package's ``mla_attention`` on the CPU, at the reduced
deepseek-v2-lite-16b widths (d_model 128, 4 heads, kv_lora_rank 32,
qk_nope 32, qk_rope 16, v 32), layer 0's seeded weights on both sides,
inputs and prior cache contents made from seeded numpy.

Cases: no cache; a dense cache at per-row positions for S = 1, 16 and 5
(one row running past the end of its cache row, whose writes the
reference drops and the port clamps); a paged cache (page size 4) for
S = 1 and 5, one row's span unmapped so its latents land on the trash
page; each with ``absorb`` off and on; and the query-chunked scoring
branch (the score budget lowered on both sides).

Tolerances: outputs within 2e-2 absolute and relative of the reference
compiled without XLA's excess precision, as the port rounds (one bf16
flip of the output projection at any magnitude); the latents written
within one
bf16 ulp of the reference's (at the scale of each written vector; the
projection sums d_model products in another order), and every other
cache entry bit for bit
(the trash page excepted, where rows may collide).  A row that is not
live keeps its latents bit for bit (dense) or writes only the trash page
(paged).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from test_torch_deepseek import reduced_params  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
TOL = 2e-2
T = 32
PAGE = 4
N_PAGES = 24
EXACT = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: as fast
    alone, and the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def layer():
    tparams, jparams = reduced_params(get_reduced_config(ARCH))
    return (jax_reduced_config(ARCH), get_reduced_config(ARCH),
            jparams["pro_0"]["attn"], tparams["pro_0"]["attn"])


def _cfgs(layer, absorb):
    return tuple(dataclasses.replace(c, mla=dataclasses.replace(
        c.mla, absorb=absorb)) for c in layer[:2])


def _bf16(a):
    """float32 numpy rounded through bf16 (what both caches hold)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _inputs(seed, b, s, jcfg, leading):
    """x (B,S,M) and a prior cache whose leaves have ``leading`` (B, T) or
    (n_pages + 1, PAGE) rows, all made from ``seed``."""
    rng = np.random.default_rng(seed)
    r, dr = jcfg.mla.kv_lora_rank, jcfg.mla.qk_rope_head_dim
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    cache = {"c_kv": _bf16(rng.standard_normal((*leading, r))),
             "k_rope": _bf16(rng.standard_normal((*leading, 1, dr)))}
    return x, cache


def _reference(jcfg, jp, x, positions, cache, index, table):
    def fn(p, xx, pos, c, idx, tab):
        return jax_mla.mla_attention(p, xx, cfg=jcfg, positions=pos,
                                     cache=c, cache_index=idx,
                                     page_table=tab)
    args = (jp, jnp.asarray(x, jnp.bfloat16), jnp.asarray(positions),
            None if cache is None else jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.bfloat16), cache),
            None if index is None else jnp.asarray(index, jnp.int32),
            None if table is None else jnp.asarray(table, jnp.int32))
    out, new = jax.jit(fn).lower(*args).compile(
        compiler_options=EXACT)(*args)
    new = None if new is None else {k: np.asarray(v, np.float32)
                                    for k, v in new.items()}
    return np.asarray(out, np.float32), new


def _port(tcfg, tp, x, positions, cache, index, table, live=None):
    tc = None if cache is None else {
        k: torch.from_numpy(v).bfloat16() for k, v in cache.items()}
    out = mla.latent_attention(
        tp, torch.from_numpy(x).bfloat16(), cfg=tcfg,
        positions=torch.from_numpy(np.asarray(positions, np.int64)),
        cache=tc, live=live,
        cache_index=None if index is None else torch.from_numpy(
            np.asarray(index, np.int64)),
        page_table=None if table is None else torch.from_numpy(
            np.asarray(table, np.int32)))
    new = None if tc is None else {k: v.float().numpy()
                                   for k, v in tc.items()}
    return out.float().numpy(), new


def _ulp(a):
    """One bf16 ulp at the scale of each written vector (its largest
    entry over the last axis): a latent is the RMS-normalized sum of
    d_model products, so an entry near zero carries the fp32 summation
    order's absolute error, not its own ulp."""
    scale = np.abs(a).max(axis=-1, keepdims=True)
    e = np.floor(np.log2(np.maximum(scale, 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _assert_cache(got, want, prior, skip_trash=False):
    """Written latents within one ulp; entries the reference left alone
    bit for bit."""
    for name in want:
        g, w, p = got[name], want[name], prior[name]
        if skip_trash:
            g, w, p = g[1:], w[1:], p[1:]
        assert np.all(np.abs(g - w) <= _ulp(w)), name
        kept = w == p
        np.testing.assert_array_equal(g[kept], p[kept], err_msg=name)


def _positions(index, s):
    return np.asarray(index)[:, None] + np.arange(s)[None, :]


@pytest.mark.parametrize("absorb", [False, True])
def test_no_cache(layer, absorb):
    jcfg, tcfg = _cfgs(layer, absorb)
    x, _ = _inputs(1, 2, 12, jcfg, (2, T))
    pos = _positions([0, 0], 12)
    jout, _ = _reference(jcfg, layer[2], x, pos, None, None, None)
    tout, _ = _port(tcfg, layer[3], x, pos, None, None, None)
    np.testing.assert_allclose(tout, jout, rtol=TOL, atol=TOL)


# S -> per-row start positions: S = 16 is a prefill chunk, S = 5 a verify
# (its last row starts 3 short of the cache's end: the reference drops the
# writes past it, the port clamps them onto the last position)
DENSE_STARTS = {1: [0, 7, 31], 16: [0, 9, 16], 5: [2, 11, T - 3]}


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("s", sorted(DENSE_STARTS))
def test_dense_cache_per_row(layer, s, absorb):
    jcfg, tcfg = _cfgs(layer, absorb)
    index = DENSE_STARTS[s]
    x, cache = _inputs(2 + s, 3, s, jcfg, (3, T))
    pos = _positions(index, s)
    jout, jnew = _reference(jcfg, layer[2], x, pos, cache, index, None)
    live = (torch.ones(3, dtype=torch.bool) if s == 5 else None)
    tout, tnew = _port(tcfg, layer[3], x, pos, cache, index, None, live)
    np.testing.assert_allclose(tout, jout, rtol=TOL, atol=TOL)
    _assert_cache(tnew, jnew, cache)


def test_dense_row_not_live_keeps_its_latents(layer):
    jcfg, tcfg = _cfgs(layer, False)
    x, cache = _inputs(7, 3, 1, jcfg, (3, T))
    index = [4, 9, 20]
    live = torch.tensor([True, False, True])
    _, frozen = _port(tcfg, layer[3], x, _positions(index, 1), cache, index,
                      None, live)
    _, full = _port(tcfg, layer[3], x, _positions(index, 1), cache, index,
                    None)
    for name in cache:
        np.testing.assert_array_equal(frozen[name][1], cache[name][1])
        np.testing.assert_array_equal(frozen[name][[0, 2]],
                                      full[name][[0, 2]])
        assert not np.array_equal(full[name][1], cache[name][1])


def _table():
    """Row 0 and row 1 fully mapped (shuffled pages), row 2 mapped only
    on its first two pages: its writes from position 8 on hit the trash
    page."""
    rng = np.random.default_rng(0)
    pages = rng.permutation(np.arange(1, N_PAGES + 1))
    n_slot = T // PAGE
    table = np.zeros((3, n_slot), np.int32)
    table[0] = pages[:n_slot]
    table[1] = pages[n_slot:2 * n_slot]
    table[2, :2] = pages[2 * n_slot:2 * n_slot + 2]
    return table


PAGED_STARTS = {1: [5, 30, 9], 5: [0, 17, 7]}


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("s", sorted(PAGED_STARTS))
def test_paged_cache(layer, s, absorb):
    jcfg, tcfg = _cfgs(layer, absorb)
    index = PAGED_STARTS[s]
    x, cache = _inputs(20 + s, 3, s, jcfg, (N_PAGES + 1, PAGE))
    pos = _positions(index, s)
    table = _table()
    jout, jnew = _reference(jcfg, layer[2], x, pos, cache, index, table)
    tout, tnew = _port(tcfg, layer[3], x, pos, cache, index, table)
    np.testing.assert_allclose(tout, jout, rtol=TOL, atol=TOL)
    _assert_cache(tnew, jnew, cache, skip_trash=True)
    # row 2's unmapped span went to the trash page, on both sides
    off = (index[2] + np.arange(s)) % PAGE
    hit = (index[2] + np.arange(s)) // PAGE >= 2
    for name in cache:
        np.testing.assert_array_equal(tnew[name][0][off[hit]],
                                      jnew[name][0][off[hit]])
        assert hit.any() or s == 1


def test_paged_row_not_live_writes_the_trash_page(layer):
    jcfg, tcfg = _cfgs(layer, False)
    x, cache = _inputs(9, 3, 1, jcfg, (N_PAGES + 1, PAGE))
    index = [5, 30, 3]
    live = torch.tensor([True, False, True])
    _, got = _port(tcfg, layer[3], x, _positions(index, 1), cache, index,
                   _table(), live)
    phys = _table()[1, 30 // PAGE]
    for name in cache:
        np.testing.assert_array_equal(got[name][phys], cache[name][phys])


@pytest.mark.parametrize("absorb", [False, True])
def test_query_chunked_scoring(layer, absorb, monkeypatch):
    """Above the score budget both sides score in query chunks (budget
    lowered to 48 scores: a 12-token prompt runs as 3 chunks of 4)."""
    budget = 48
    monkeypatch.setattr(jax_layers, "SCORE_CHUNK_ELEMS", budget)
    monkeypatch.setattr(jax_layers, "_chunk_len", functools.partial(
        jax_layers._chunk_len, budget=budget))
    monkeypatch.setattr(mla, "SCORE_CHUNK_ELEMS", budget)
    assert mla.score_chunk_len(12, 12) == 4
    jcfg, tcfg = _cfgs(layer, absorb)
    x, cache = _inputs(30, 2, 12, jcfg, (2, T))
    for index, c in (([0, 0], None), ([3, 8], cache)):
        pos = _positions(index, 12)
        idx = None if c is None else index
        jout, jnew = _reference(jcfg, layer[2], x, pos, c, idx, None)
        tout, tnew = _port(tcfg, layer[3], x, pos, c, idx, None)
        np.testing.assert_allclose(tout, jout, rtol=TOL, atol=TOL)
        if c is not None:
            _assert_cache(tnew, jnew, cache)
