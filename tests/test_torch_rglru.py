"""The port's RG-LRU block and local-attention ring against the JAX package
on the CPU (``repro_torch.models.rglru`` beside ``repro.models.rglru``;
the reduced recurrentgemma-2b's first recurrent layer, the JAX parameters
bridged over; inputs made from numpy seeds).

Tolerances and why:
  * ``lru_scan``: the same combine summed in another order (a log-step
    scan against ``jax.lax.associative_scan``), so fp32 at 1e-5 of the
    largest state entry.
  * ``recurrent_block``: the output and the bf16 conv state within one
    bf16 rounding flip of the reference compiled without XLA's excess
    precision (2**-7 relative, 2e-2 absolute, as the Mamba-2 block's);
    the fp32 state at 1e-4 of its largest entry (the scan's order, and
    ``exp``/``sigmoid`` may differ by an ulp between XLA and PyTorch).
  * the ring: the new keys, values and positions land bit for bit where
    the reference puts them (copies, no arithmetic); the context is
    fp32 softmax attention rounded to bf16 once, so one bf16 flip
    (2**-7 relative and absolute).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import rglru as jax_rg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import rglru  # noqa: E402

BF16_TOL = 2.0 ** -7
STATE_TOL = 1e-4
WINDOW = 32


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _exact(fn, *args):
    """A reference function compiled without XLA's excess precision."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


@pytest.fixture(scope="module")
def mixer():
    jcfg = jax_reduced_config("recurrentgemma-2b")
    jparams = build_model(jcfg).init(jax.random.PRNGKey(1))
    layer0 = jax.tree_util.tree_map(lambda a: a[0],
                                    jparams["blocks"]["rec_0"]["mixer"])
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, layer0),
                                device="cpu")
    return jcfg, layer0, get_reduced_config("recurrentgemma-2b"), tparams


@pytest.mark.parametrize("s,with_h0", [(1, True), (7, False), (16, True),
                                       (37, True)])
def test_lru_scan_matches_associative_scan(s, with_h0):
    rng = np.random.default_rng(s)
    log_a = -rng.uniform(0.0, 2.0, (2, s, 24)).astype(np.float32)
    gated = rng.standard_normal((2, s, 24)).astype(np.float32)
    h0 = rng.standard_normal((2, 24)).astype(np.float32) if with_h0 else None
    hj, lj = jax_rg._lru_scan(jnp.asarray(log_a), jnp.asarray(gated),
                              None if h0 is None else jnp.asarray(h0))
    ht, lt = rglru.lru_scan(_t(log_a), _t(gated),
                            None if h0 is None else _t(h0))
    scale = np.abs(_np(hj)).max()
    np.testing.assert_allclose(_np(ht), _np(hj), rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(_np(lt), _np(ht)[:, -1])


def test_lru_scan_pads_are_identities():
    """Steps with log a = 0 and no input leave the state of the last real
    step: a padded scan's state equals the real steps' state."""
    rng = np.random.default_rng(4)
    log_a = -rng.uniform(0.0, 2.0, (1, 5, 8)).astype(np.float32)
    gated = rng.standard_normal((1, 5, 8)).astype(np.float32)
    h0 = rng.standard_normal((1, 8)).astype(np.float32)
    pad = np.zeros((1, 11, 8), np.float32)
    h_real, last_real = rglru.lru_scan(_t(log_a), _t(gated), _t(h0))
    h_pad, last_pad = rglru.lru_scan(_t(np.concatenate([log_a, pad], 1)),
                                     _t(np.concatenate([gated, pad], 1)),
                                     _t(h0))
    np.testing.assert_allclose(_np(last_pad), _np(last_real), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(h_pad)[:, :5], _np(h_real), rtol=1e-6,
                               atol=1e-6)


def _cache(rng, cfg, b, carried):
    rg = cfg.rglru
    h = (rng.standard_normal((b, rg.lru_width)) if carried
         else np.zeros((b, rg.lru_width)))
    conv = (rng.standard_normal((b, rg.conv_width - 1, rg.lru_width))
            if carried else np.zeros((b, rg.conv_width - 1, rg.lru_width)))
    return h.astype(np.float32), conv.astype(np.float32)


# (tokens, cache, valid_len): one decode token on a carried state; a
# monolithic prompt without a cache; a chunk from a zero state and on top
# of a carried state, all real; a padded chunk with a scalar valid_len;
# a verify's restore pass with per-row (B,) valid lengths 0, 3 and 8
BLOCK_CASES = [(1, True, None), (9, None, None), (12, False, None),
               (8, True, None), (8, True, 5), (8, True, (0, 3, 8))]


@pytest.mark.parametrize("s,carried,valid_len", BLOCK_CASES)
def test_recurrent_block_matches_reference(mixer, s, carried, valid_len):
    jcfg, jp, tcfg, tp = mixer
    b = 3
    rng = np.random.default_rng(31 + s)
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = _t(x, torch.bfloat16)
    if carried is None:
        out_j, _ = _exact(lambda p_, x_: jax_rg.rglru_block(
            p_, x_, cfg=jcfg), jp, jx)
        out_t = rglru.recurrent_block(tp, tx, cfg=tcfg)
        np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=BF16_TOL,
                                   atol=2e-2)
        return
    h, conv = _cache(rng, jcfg, b, carried)
    jcache = {"h": jnp.asarray(h), "conv": jnp.asarray(conv, jnp.bfloat16)}
    if valid_len is None:
        jvl, tvl = None, None
    elif isinstance(valid_len, tuple):
        jvl, tvl = jnp.asarray(valid_len, jnp.int32), torch.tensor(valid_len)
    else:
        jvl, tvl = jnp.int32(valid_len), valid_len
    out_j, new_j = _exact(lambda p_, x_, c_: jax_rg.rglru_block(
        p_, x_, cfg=jcfg, cache=c_, valid_len=jvl), jp, jx, jcache)
    tcache = {"h": _t(h), "conv": _t(conv, torch.bfloat16)}
    out_t = rglru.recurrent_block(tp, tx, cfg=tcfg, cache=tcache,
                                  valid_len=tvl)
    keep = np.full(b, s) if valid_len is None else \
        np.broadcast_to(np.asarray(valid_len), (b,))
    for i in range(b):
        np.testing.assert_allclose(_np(out_t)[i, :keep[i]],
                                   _np(out_j)[i, :keep[i]], rtol=BF16_TOL,
                                   atol=2e-2)
    np.testing.assert_allclose(_np(tcache["conv"]), _np(new_j["conv"]),
                               rtol=BF16_TOL, atol=2e-2)
    hj = _np(new_j["h"])
    np.testing.assert_allclose(_np(tcache["h"]), hj, rtol=0,
                               atol=STATE_TOL * np.abs(hj).max())
    if isinstance(valid_len, tuple):
        # the row with no real token keeps its state bit for bit
        np.testing.assert_array_equal(_np(tcache["h"])[0], h[0])
        np.testing.assert_array_equal(_np(tcache["conv"])[0],
                                      _np(_t(conv, torch.bfloat16))[0])


def test_recurrent_block_freezes_rows_that_are_not_live(mixer):
    _, _, tcfg, tp = mixer
    rng = np.random.default_rng(17)
    h, conv = _cache(rng, tcfg, 3, True)
    cache = {"h": _t(h), "conv": _t(conv, torch.bfloat16)}
    before = {k: v.clone() for k, v in cache.items()}
    live = torch.tensor([True, False, True])
    rglru.recurrent_block(tp, _t(rng.standard_normal((3, 1, 128)),
                                 torch.bfloat16),
                          cfg=tcfg, cache=cache, live=live)
    for name in ("h", "conv"):
        assert torch.equal(cache[name][1], before[name][1])
        assert not torch.equal(cache[name][0], before[name][0])


# --------------------------------------------------------------------------
# the ring
# --------------------------------------------------------------------------
H, KH, D = 4, 1, 32


def _ring(rng, b, filled_to):
    """A ring whose row i holds positions [0, filled_to[i]) at their
    slots (the last WINDOW of them), -1 elsewhere, with random keys."""
    k = rng.standard_normal((b, WINDOW, KH, D)).astype(np.float32)
    v = rng.standard_normal((b, WINDOW, KH, D)).astype(np.float32)
    pos = np.full((b, WINDOW), -1, np.int32)
    for i, n in enumerate(filled_to):
        for p in range(max(0, n - WINDOW), n):
            pos[i, p % WINDOW] = p
    return k, v, pos


def _jax_ring(k, v, pos):
    return {"k": jnp.asarray(k, jnp.bfloat16),
            "v": jnp.asarray(v, jnp.bfloat16), "pos": jnp.asarray(pos)}


def _torch_ring(k, v, pos):
    return {"k": _t(k, torch.bfloat16), "v": _t(v, torch.bfloat16),
            "pos": torch.from_numpy(pos.copy())}


def _assert_ring(tring, jring):
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(_np(tring[name]), _np(jring[name]))


def test_window_cache_specs_match_reference():
    jcfg = jax_reduced_config("recurrentgemma-2b")
    tcfg = get_reduced_config("recurrentgemma-2b")
    want = jax_rg.window_cache_specs(jcfg, 3)
    got = rglru.window_cache_specs(tcfg, 3)
    assert set(got) == set(want)
    for name, spec in got.items():
        assert spec.shape == want[name].shape
        assert spec.axes == want[name].axes
        assert str(spec.dtype).rsplit(".", 1)[-1] == \
            np.dtype(want[name].dtype).name


@pytest.mark.parametrize("t", [(0, 5, 31, 32), (33, 64, 70, 95)])
def test_ring_decode_matches_reference(t):
    """Per-row positions before and across the wrap (slot t % 32)."""
    rng = np.random.default_rng(sum(t))
    b = len(t)
    k, v, pos = _ring(rng, b, t)
    q = rng.standard_normal((b, 1, H, D)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, 1, KH, D)).astype(np.float32)
              for _ in range(2))
    ctx_j, ring_j = jax_rg.window_attention_decode(
        jnp.asarray(q, jnp.bfloat16), _jax_ring(k, v, pos),
        jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16),
        jnp.asarray(t, jnp.int32), WINDOW)
    ring_t = _torch_ring(k, v, pos)
    ctx_t = rglru.ring_decode(_t(q, torch.bfloat16), ring_t,
                              _t(kn, torch.bfloat16), _t(vn, torch.bfloat16),
                              torch.tensor(t), WINDOW)
    _assert_ring(ring_t, ring_j)
    np.testing.assert_allclose(_np(ctx_t), _np(ctx_j), rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_ring_decode_keeps_rows_that_are_not_live():
    rng = np.random.default_rng(8)
    k, v, pos = _ring(rng, 2, (10, 40))
    ring = _torch_ring(k, v, pos)
    before = {n: a.clone() for n, a in ring.items()}
    rglru.ring_decode(_t(rng.standard_normal((2, 1, H, D)), torch.bfloat16),
                      ring, *(_t(rng.standard_normal((2, 1, KH, D)),
                                 torch.bfloat16) for _ in range(2)),
                      torch.tensor([10, 40]), WINDOW,
                      live=torch.tensor([False, True]))
    for name in ("k", "v", "pos"):
        assert torch.equal(ring[name][0], before[name][0])
        assert not torch.equal(ring[name][1], before[name][1])


# (C, t0, valid_len): scalar positions with pads; per-row starts and valid
# lengths across the wrap, one row with no real token (a restore pass's
# n_emit = 0); a chunk longer than the window, all real and padded
CHUNK_CASES = [(16, 8, 11), (16, (0, 20, 40), (16, 0, 9)),
               (5, (28, 31, 60), (5, 2, 3)), (40, 0, 40), (40, 25, 37),
               (48, (3, 10, 0), (48, 45, 20))]


@pytest.mark.parametrize("c,t0,valid_len", CHUNK_CASES)
def test_ring_chunk_matches_reference(c, t0, valid_len):
    b = 3
    rng = np.random.default_rng(c)
    starts = np.broadcast_to(np.asarray(t0), (b,))
    k, v, pos = _ring(rng, b, starts)
    q = rng.standard_normal((b, c, H, D)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, c, KH, D)).astype(np.float32)
              for _ in range(2))
    per_row = isinstance(t0, tuple) or isinstance(valid_len, tuple)
    jt0, jvl = (jnp.asarray(t0, jnp.int32), jnp.asarray(valid_len, jnp.int32))
    ctx_j, ring_j = jax_rg.window_attention_chunk(
        jnp.asarray(q, jnp.bfloat16), _jax_ring(k, v, pos),
        jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16),
        jt0, jvl, WINDOW)
    ring_t = _torch_ring(k, v, pos)
    ctx_t = rglru.ring_chunk(
        _t(q, torch.bfloat16), ring_t, _t(kn, torch.bfloat16),
        _t(vn, torch.bfloat16),
        torch.tensor(t0) if per_row else t0,
        torch.tensor(valid_len) if per_row else valid_len, WINDOW)
    _assert_ring(ring_t, ring_j)
    vls = np.broadcast_to(np.asarray(valid_len), (b,))
    for i in range(b):
        np.testing.assert_allclose(_np(ctx_t)[i, :vls[i]],
                                   _np(ctx_j)[i, :vls[i]], rtol=BF16_TOL,
                                   atol=BF16_TOL)


def test_ring_chunk_keeps_rows_that_are_not_live():
    rng = np.random.default_rng(9)
    k, v, pos = _ring(rng, 2, (10, 12))
    ring = _torch_ring(k, v, pos)
    before = {n: a.clone() for n, a in ring.items()}
    rglru.ring_chunk(_t(rng.standard_normal((2, 5, H, D)), torch.bfloat16),
                     ring, *(_t(rng.standard_normal((2, 5, KH, D)),
                                torch.bfloat16) for _ in range(2)),
                     torch.tensor([10, 12]), 5, WINDOW,
                     live=torch.tensor([True, False]))
    for name in ("k", "v", "pos"):
        assert torch.equal(ring[name][1], before[name][1])
        assert not torch.equal(ring[name][0], before[name][0])


@pytest.mark.parametrize("s", [9, 32, 45])
def test_fill_ring_matches_reference(s):
    rng = np.random.default_rng(s)
    k, v, pos = _ring(rng, 2, (0, 0))
    kn, vn = (rng.standard_normal((2, s, KH, D)).astype(np.float32)
              for _ in range(2))
    ring_j = jax_rg.fill_window_cache(_jax_ring(k, v, pos),
                                      jnp.asarray(kn, jnp.bfloat16),
                                      jnp.asarray(vn, jnp.bfloat16), WINDOW)
    ring_t = _torch_ring(k, v, pos)
    rglru.fill_ring(ring_t, _t(kn, torch.bfloat16), _t(vn, torch.bfloat16),
                    WINDOW)
    _assert_ring(ring_t, ring_j)


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
