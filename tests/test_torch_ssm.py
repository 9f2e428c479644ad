"""The port's Mamba-2 pieces against the JAX package on the CPU: the SSD
scan's plain version (what ``ssd_scan`` runs on a CPU tensor) and the
``ssm`` module (reduced mamba2-780m widths, the JAX parameters bridged
over).

Tolerances and why:
  * SSD scan in fp32 at 2e-4 against the Pallas kernel in interpret mode
    and against ``ref.ssd_ref`` at another chunking (the reference's own
    tolerance, ``tests/test_kernels.py``): the same sums in another
    order.
  * SSD scan in bf16: y is rounded to bf16 once, so 2**-7 relative (one
    bf16 ulp, doubled for a rounding flip) plus 2**-7 absolute; the fp32
    state at the fp32 tolerance scaled by its largest entry.
  * ``causal_conv1d``: bit-identical (bf16 products and sums in the same
    order on both sides).
  * ``ssd_decode_step``: fp32 at 1e-6 relative (``exp`` may differ by an
    ulp between XLA and PyTorch).
  * ``mamba2_block``: outputs and the bf16 conv state within one bf16
    rounding flip of the reference compiled without XLA's excess
    precision (2**-7 relative, 2e-2 absolute); the fp32 SSD state at
    1e-2 of its largest entry: ``exp``/``log1p`` differ by an ulp between
    XLA and PyTorch, and a flipped bf16 rounding of x, B or C moves the
    state by that much.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels.ref import ssd_ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

BF16_TOL = 2.0 ** -7


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


def _scan_inputs(rng, bsz, l, h, p, n, with_init):
    x = rng.standard_normal((bsz, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (bsz, l, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    b = rng.standard_normal((bsz, l, h, n)).astype(np.float32)
    c = rng.standard_normal((bsz, l, h, n)).astype(np.float32)
    h0 = (rng.standard_normal((bsz, h, p, n)).astype(np.float32)
          if with_init else None)
    return x, dt, a, b, c, h0


# the reference's sweep (tests/test_kernels.py): every (l, chunk) pair
# with and without an initial state; (h, p, n) cycle through their values
SWEEP = [(l, chunk, init, (1, 3)[i // 2 % 2], (4, 8)[i // 3 % 2],
          (4, 8)[i // 5 % 2])
         for i, (l, chunk, init) in enumerate(
             (l, chunk, init) for l in (8, 24, 40) for chunk in (4, 8, 16)
             for init in (False, True))]


@pytest.mark.parametrize("l,chunk,with_init,h,p,n", SWEEP)
def test_ssd_scan_plain_matches_pallas_and_ref(l, chunk, with_init, h, p, n):
    rng = np.random.default_rng(l * 7 + h)
    x, dt, a, b, c, h0 = _scan_inputs(rng, 2, l, h, p, n, with_init)
    j = [jnp.asarray(v) for v in (x, dt, a, b, c)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    y_k, s_k = jax_ops.ssd_scan(*j, chunk_size=chunk, initial_state=jh0,
                                interpret=True)
    y_r, s_r = jax_ref.ssd_ref(*j, chunk_size=5, initial_state=jh0)
    y, s = ops.ssd_scan(*(_t(v) for v in (x, dt, a, b, c)),
                        chunk_size=chunk,
                        initial_state=None if h0 is None else _t(h0))
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    for want_y, want_s in ((y_k, s_k), (y_r, s_r)):
        np.testing.assert_allclose(_np(y), _np(want_y), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(_np(s), _np(want_s), rtol=2e-4,
                                   atol=2e-4)


def test_ssd_scan_plain_bf16_matches_pallas():
    """The serve's types: bf16 x, B, C; fp32 dt, a and state; a ragged
    last chunk (40 = 16 + 16 + 8)."""
    rng = np.random.default_rng(3)
    x, dt, a, b, c, h0 = _scan_inputs(rng, 2, 40, 3, 8, 8, True)
    bf = [jnp.asarray(v, jnp.bfloat16) for v in (x, b, c)]
    y_k, s_k = jax_ops.ssd_scan(bf[0], jnp.asarray(dt), jnp.asarray(a),
                                bf[1], bf[2], chunk_size=16,
                                initial_state=jnp.asarray(h0),
                                interpret=True)
    y, s = ssd.ssd_scan(_t(x, torch.bfloat16), _t(dt), _t(a),
                        _t(b, torch.bfloat16), _t(c, torch.bfloat16),
                        chunk_size=16, initial_state=_t(h0))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(y_k), rtol=BF16_TOL,
                               atol=BF16_TOL)
    np.testing.assert_allclose(_np(s), _np(s_k),
                               rtol=0, atol=2e-4 * np.abs(_np(s_k)).max())


def test_ssd_scan_masks_the_ragged_tail_like_padding():
    """Cutting the last chunk short equals the TPU wrapper's dt = 0
    padding: padded rows are exact no-ops for y and the final state."""
    rng = np.random.default_rng(5)
    x, dt, a, b, c, h0 = _scan_inputs(rng, 1, 21, 2, 4, 4, True)
    pad = [np.concatenate([v, np.zeros((1, 11) + v.shape[2:], np.float32)],
                          axis=1) for v in (x, dt, b, c)]
    y, s = ssd_ref(*(_t(v) for v in (x, dt, a, b, c)), chunk_size=8,
                   initial_state=_t(h0))
    y_pad, s_pad = ssd_ref(_t(pad[0]), _t(pad[1]), _t(a), _t(pad[2]),
                           _t(pad[3]), chunk_size=8, initial_state=_t(h0))
    np.testing.assert_allclose(_np(y), _np(y_pad[:, :21]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(s), _np(s_pad), rtol=1e-6, atol=1e-6)


def test_ssd_shared_memory_sizing():
    """The serve's shapes fit one block; what does not fit is refused by
    the wrapper before anything reaches the card."""
    assert ssd.smem_bytes(256, 128) == 205_056
    assert ssd.smem_bytes(256, 128) <= ssd.MAX_SMEM_BYTES
    assert ssd.smem_bytes(512, 128) > ssd.MAX_SMEM_BYTES
    # one block per 16 columns of P: mamba2-780m's 48 heads of 64 at B = 1
    assert ssd.launch_geometry(1, 48, 64) == (4, 192)
    assert ssd.launch_geometry(2, 3, 20) == (2, 12)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_ssd_scan_plain_takes_b_and_c_per_group(g):
    """B and C per group (B, L, G, N): head h reads group h // (H/G),
    bit for bit what the per-head copies give."""
    rng = np.random.default_rng(g)
    x, dt, a, _, _, h0 = _scan_inputs(rng, 2, 20, 4, 8, 8, True)
    b, c = (rng.standard_normal((2, 20, g, 8)).astype(np.float32)
            for _ in range(2))
    grouped = ssd.ssd_scan(*(_t(v) for v in (x, dt, a, b, c)), chunk_size=8,
                           initial_state=_t(h0))
    per_head = ssd.ssd_scan(*(_t(v) for v in (x, dt, a, np.repeat(
        b, 4 // g, axis=2), np.repeat(c, 4 // g, axis=2))), chunk_size=8,
        initial_state=_t(h0))
    for got, want in zip(grouped, per_head):
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        ssd.ssd_scan(*(_t(v) for v in (x, dt, a, b[:, :, :1].repeat(
            3, axis=2), c[:, :, :1].repeat(3, axis=2))), chunk_size=8)


def test_get_ssd_reads_no_tile_table(monkeypatch):
    """The scan runs at the model's chunk: an ``"ssd"`` tile table, in a
    context or installed globally, is not read."""
    seen = []
    monkeypatch.setattr(ops, "ssd_scan", lambda *a, **kw: seen.append(kw))
    fn = dispatch.get_ssd()
    args = [torch.zeros(1)] * 5
    fn(*args, chunk_size=256)
    with dispatch.tile_context({"ssd": {"chunk_size": 64}}):
        fn(*args, chunk_size=256)
    dispatch.install_tile_overrides({"ssd": {"chunk_size": 32}})
    try:
        fn(*args, chunk_size=256)
    finally:
        dispatch.clear_tile_overrides()
    assert seen == [{"chunk_size": 256, "initial_state": None}] * 3


# ---------------------------------------------------------------------------
# the ssm module, reduced mamba2-780m
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mixer():
    jcfg = jax_reduced_config("mamba2-780m")
    jparams = build_model(jcfg).init(jax.random.PRNGKey(1))
    layer0 = jax.tree_util.tree_map(lambda a: a[0],
                                    jparams["blocks"]["ssm"]["mixer"])
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, layer0),
                                device="cpu")
    return jcfg, layer0, get_reduced_config("mamba2-780m"), tparams


@pytest.mark.parametrize("with_state,valid_len", [(False, None), (True, None),
                                                  (True, 5), (True, 1)])
def test_causal_conv1d_bit_identical(with_state, valid_len):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 8, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    jx, jst = (jnp.asarray(v, jnp.bfloat16) for v in (x, st))
    y_j, s_j = _exact(lambda x_, w_, b_, s_: jax_ssm.causal_conv1d(
        x_, w_, b_, s_ if with_state else None, valid_len=valid_len),
        jx, jnp.asarray(w), jnp.asarray(b), jst)
    y_t, s_t = ssm.causal_conv1d(
        _t(x, torch.bfloat16), _t(w), _t(b),
        _t(st, torch.bfloat16) if with_state else None, valid_len=valid_len)
    np.testing.assert_array_equal(_np(y_t), _np(y_j))
    np.testing.assert_array_equal(_np(s_t), _np(s_j))


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(12)
    state = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (2, 3)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (3,)).astype(np.float32)
    b, c = (rng.standard_normal((2, 3, 8)).astype(np.float32)
            for _ in range(2))
    y_j, s_j = jax_ssm.ssd_decode_step(*(jnp.asarray(v) for v in (
        state, x, dt, a, b, c)))
    y_t, s_t = ssm.ssd_decode_step(*(_t(v) for v in (state, x, dt, a, b, c)))
    np.testing.assert_allclose(_np(y_t), _np(y_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(s_t), _np(s_j), rtol=1e-6, atol=1e-6)


def _assert_block_close(out_t, out_j, cache_t, cache_j):
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=BF16_TOL,
                               atol=2e-2)
    np.testing.assert_allclose(_np(cache_t["conv"]), _np(cache_j["conv"]),
                               rtol=BF16_TOL, atol=2e-2)
    ssd_j = _np(cache_j["ssd"])
    np.testing.assert_allclose(_np(cache_t["ssd"]), ssd_j, rtol=0,
                               atol=1e-2 * np.abs(ssd_j).max())


# (tokens, cache, valid_len): monolithic prefill with a cache, a padded
# chunk on top of a carried state, one decode token
BLOCK_CASES = [(24, False, None), (8, True, 5), (1, True, None)]


@pytest.mark.parametrize("s,carried,valid_len", BLOCK_CASES)
def test_mamba2_block_matches_reference(mixer, s, carried, valid_len):
    jcfg, jp, tcfg, tp = mixer
    ssm_cfg = jcfg.ssm
    rng = np.random.default_rng(13 + s)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    conv_ch = ssm_cfg.d_inner + 2 * ssm_cfg.num_groups * ssm_cfg.state_dim
    conv = (rng.standard_normal((2, ssm_cfg.conv_width - 1, conv_ch))
            if carried else np.zeros((2, ssm_cfg.conv_width - 1, conv_ch)))
    state = (rng.standard_normal((2, ssm_cfg.num_heads, ssm_cfg.head_dim,
                                  ssm_cfg.state_dim))
             if carried else np.zeros((2, ssm_cfg.num_heads,
                                       ssm_cfg.head_dim, ssm_cfg.state_dim)))
    jcache = {"conv": jnp.asarray(conv, jnp.bfloat16),
              "ssd": jnp.asarray(state, jnp.float32)}
    vl = None if valid_len is None else jnp.int32(valid_len)
    out_j, new_j = _exact(lambda p_, x_, c_: jax_ssm.mamba2_block(
        p_, x_, cfg=jcfg, cache=c_, valid_len=vl),
        jp, jnp.asarray(x, jnp.bfloat16), jcache)
    tcache = {"conv": _t(conv, torch.bfloat16), "ssd": _t(state)}
    out_t = ssm.mamba2_block(tp, _t(x, torch.bfloat16), cfg=tcfg,
                             cache=tcache, valid_len=valid_len)
    keep = s if valid_len is None else valid_len
    _assert_block_close(out_t[:, :keep], _np(out_j)[:, :keep], tcache,
                        new_j)


def test_mamba2_block_freezes_rows_that_are_not_live(mixer):
    _, _, tcfg, tp = mixer
    rng = np.random.default_rng(17)
    cache = {"conv": _t(rng.standard_normal((3, 3, 288)), torch.bfloat16),
             "ssd": _t(rng.standard_normal((3, 8, 32, 16)))}
    before = {k: v.clone() for k, v in cache.items()}
    live = torch.tensor([True, False, True])
    ssm.mamba2_block(tp, _t(rng.standard_normal((3, 1, 128)),
                            torch.bfloat16),
                     cfg=tcfg, cache=cache, live=live)
    for name in ("conv", "ssd"):
        assert torch.equal(cache[name][1], before[name][1])
        assert not torch.equal(cache[name][0], before[name][0])
