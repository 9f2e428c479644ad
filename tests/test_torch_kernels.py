"""The port's kernel layer against the JAX package on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version;
these tests hold that version against the JAX Pallas kernel run in
interpret mode, on the reference's shape sweeps:

  * block_matmul: fp32 at 1e-4 (both accumulate in fp32; only the
    summation order differs); bf16 at rtol 8e-2, atol 6.4e-1 — the
    reference's own tolerance (``tests/test_kernels.py``) for outputs
    rounded to bf16.
  * flash_attention: fp32 at 2e-4 (``tests/test_kernels.py``): online
    (tiled) against one-pass softmax.  Both follow the kernel contract, so
    fully masked rows are 0 on both sides and every row is compared.

Also: the tile dispatch semantics case by case against
``repro.kernels.dispatch``, and the tile arithmetic of the CUDA wrappers
and the port's H100 level table.  The CUDA kernels themselves are tested
on the card by ``tests/test_torch_cuda.py``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.kernels import block_matmul as bm  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.serving.engine import H100_LEVEL_TILES  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor."""
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# (m, k, n, bm, bk, bn, dtype): ragged sizes in 1..70 and the reference's
# tile choices
MATMUL_CASES = [
    (1, 1, 1, 8, 16, 16, "float32"),
    (3, 70, 5, 16, 32, 16, "float32"),
    (17, 33, 65, 32, 16, 32, "float32"),
    (70, 70, 70, 8, 32, 32, "float32"),
    (64, 9, 40, 16, 16, 16, "float32"),
    (4, 64, 48, 8, 32, 32, "bfloat16"),
    (16, 48, 70, 16, 16, 32, "bfloat16"),
    (33, 65, 17, 32, 32, 16, "bfloat16"),
    (70, 1, 70, 8, 16, 16, "bfloat16"),
]


@pytest.mark.parametrize("m,k,n,tbm,tbk,tbn,dtype", MATMUL_CASES)
def test_block_matmul_plain_matches_pallas(m, k, n, tbm, tbk, tbn, dtype):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    xj, xt = _pair(rng, (m, k), dtype)
    wj, wt = _pair(rng, (k, n), dtype)
    want = jax_ops.block_matmul(xj, wj, bm=tbm, bk=tbk, bn=tbn,
                                interpret=True)
    got = ops.block_matmul(xt, wt, bm=tbm, bk=tbk, bn=tbn)
    assert got.dtype == xt.dtype and got.shape == (m, n)
    tol = 1e-4 if dtype == "float32" else 8e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol * 8)


def test_block_matmul_flattens_leading_dims():
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (2, 3, 24), "float32")
    wj, wt = _pair(rng, (24, 16), "float32")
    want = jax_ops.block_matmul(xj, wj, bm=8, bk=8, bn=8, interpret=True)
    got = ops.block_matmul(xt, wt)
    assert got.shape == (2, 3, 16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


# (b, s, t, h, kv, d, offsets, kv_valid, window, softcap, bq, bkv)
ATTENTION_CASES = [
    # prefill from 0, MQA and GQA, with and without a window
    (2, 8, 8, 4, 1, 16, 0, 8, None, None, 8, 8),
    (2, 17, 23, 4, 2, 8, 0, 17, 5, None, 4, 8),
    (2, 24, 30, 2, 1, 16, 0, 24, 16, None, 8, 4),
    # a prefill chunk at an offset, softcap
    (1, 4, 32, 4, 1, 16, 10, 14, None, 5.0, 4, 8),
    # decode: per-row offsets, MQA, window and softcap
    (3, 1, 32, 4, 1, 16, (5, 17, 31), (6, 18, 32), None, None, 8, 8),
    (3, 1, 32, 4, 2, 16, (5, 17, 31), (6, 18, 32), 8, 30.0, 8, 16),
    # a row with no valid key (the kernel writes 0)
    (2, 1, 16, 2, 1, 8, (3, 0), (4, 0), None, None, 8, 8),
]


@pytest.mark.parametrize("b,s,t,h,kv,d,offsets,kv_valid,window,softcap,"
                         "bq,bkv", ATTENTION_CASES)
def test_flash_attention_plain_matches_pallas(b, s, t, h, kv, d, offsets,
                                              kv_valid, window, softcap, bq,
                                              bkv):
    rng = np.random.default_rng(b * 1000 + s * 10 + t)
    qj, qt = _pair(rng, (b, s, h, d), "float32")
    kj, kt = _pair(rng, (b, t, kv, d), "float32")
    vj, vt = _pair(rng, (b, t, kv, d), "float32")
    off = np.broadcast_to(np.asarray(offsets, np.int32), (b,))
    qpos = off[:, None] + np.arange(s, dtype=np.int32)[None, :]
    kvl = np.asarray(kv_valid, np.int32)
    want = jax_ops.flash_attention(
        qj, kj, vj, q_positions=jnp.asarray(qpos),
        kv_valid_len=jnp.asarray(kvl) if kvl.ndim else int(kvl),
        window=window, softcap=softcap, bq=bq, bkv=bkv, interpret=True)
    got = ops.flash_attention(
        qt, kt, vt, q_positions=torch.from_numpy(qpos),
        kv_valid_len=torch.from_numpy(kvl) if kvl.ndim else int(kvl),
        window=window, softcap=softcap, bq=bq, bkv=bkv)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_ref_module_names_the_plain_versions():
    assert ref.matmul_ref is bm.matmul_plain
    assert ref.attention_ref is fa.attention_plain


# --------------------------------------------------------------------------
# tile arithmetic of the CUDA wrappers (CPU-checkable)
# --------------------------------------------------------------------------
# the serving path's GEMMs at full width: gate/up and down, decode (M=4)
# and a prefill chunk (M=16)
SERVE_GEMMS = [(m, k, n) for m in (4, 16)
               for k, n in ((2048, 16384), (16384, 2048))]


@pytest.mark.parametrize("level", range(len(H100_LEVEL_TILES)))
def test_every_level_tile_is_built_and_fits(level):
    tiles = H100_LEVEL_TILES[level]
    for m, k, n in SERVE_GEMMS:
        tm, tk, tn = bm.effective_tiles(m, k, n, **tiles["matmul"])
        assert tm in bm.BM_CHOICES and tk in bm.BK_CHOICES and \
            tn in bm.BN_CHOICES
        # the block's shared memory is sized by the kernel alone: the
        # card tests bound what it reports (tests/test_torch_cuda.py)
        assert tm <= max(16, m)
    att = tiles["attention"]
    assert fa.smem_bytes(att["bq"], att["bkv"], 256) <= fa.MAX_SMEM_BYTES


def test_effective_tiles_never_exceed_the_rounded_problem():
    assert bm.effective_tiles(4, 2048, 16384, 128, 64, 128) == (16, 64, 128)
    assert bm.effective_tiles(37, 20, 9, 128, 64, 128) == (64, 32, 32)
    assert bm.effective_tiles(300, 4096, 4096, 64, 32, 64) == (64, 32, 64)


def test_wrappers_reject_mixed_devices_and_tile_sizes():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError):
        bm.block_matmul_2d(x, torch.zeros(5, 3))
    q = torch.zeros(1, 2, 3, 4)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 2, 2, 4), torch.zeros(1, 2, 2, 4),
                           offset=0, kv_valid_len=2)


# --------------------------------------------------------------------------
# dispatch semantics, case by case against the reference
# --------------------------------------------------------------------------
@pytest.fixture
def both_dispatch():
    yield
    for mod in (dispatch, jax_dispatch):
        mod.clear_tile_overrides()
        mod.install_ladder(None)


def _state(mod):
    return (mod.all_tile_overrides(), mod.tile_overrides("matmul"),
            mod.tile_overrides("attention"), mod.active_ladder())


def test_install_clears_ops_the_new_table_omits(both_dispatch):
    for mod in (dispatch, jax_dispatch):
        mod.install_tile_overrides(
            {"matmul": {"bm": 64}, "attention": {"bq": 64}})
    assert _state(dispatch) == _state(jax_dispatch)
    for mod in (dispatch, jax_dispatch):
        mod.install_tile_overrides({"matmul": {"bm": 32}})
    assert _state(dispatch) == _state(jax_dispatch)
    assert dispatch.tile_overrides("attention") == {}


def test_tile_context_is_atomic_scoped_and_nests(both_dispatch):
    seen = {}
    for mod in (dispatch, jax_dispatch):
        mod.install_tile_overrides({"attention": {"bq": 64}})
        with mod.tile_context({"matmul": {"bm": 16}}):
            inner = _state(mod)
            with mod.tile_context({"attention": {"bkv": 8}}):
                innermost = _state(mod)
            back = _state(mod)
        seen[mod] = (inner, innermost, back, _state(mod))
    assert seen[dispatch] == seen[jax_dispatch]
    inner, innermost, back, after = seen[dispatch]
    assert inner[2] == {} and innermost[1] == {} and back == inner
    assert after[2] == {"bq": 64}


def test_tile_context_restores_after_an_exception(both_dispatch):
    for mod in (dispatch, jax_dispatch):
        with pytest.raises(KeyError):
            with mod.tile_context({"matmul": {"bm": 16}}):
                raise KeyError("x")
        assert mod.all_tile_overrides() == {}


def test_ladder_install_load_and_reject(both_dispatch, tmp_path):
    levels = [{"matmul": {"bm": 32 + i, "bk": 32, "bn": 64}}
              for i in range(10)]
    good = tmp_path / "ladder.json"
    good.write_text(json.dumps({"levels": levels, "meta": "x"}))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"levels": []}))
    for mod in (dispatch, jax_dispatch):
        assert mod.load_ladder(good) == levels
        copy = mod.active_ladder()
        copy[0]["matmul"]["bm"] = -1      # a copy, not the installed table
        with pytest.raises(ValueError):
            mod.load_ladder(bad)
    assert _state(dispatch) == _state(jax_dispatch)
    assert dispatch.active_ladder() == levels
    for mod in (dispatch, jax_dispatch):
        mod.install_ladder(None)
    assert dispatch.active_ladder() is None is jax_dispatch.active_ladder()


def test_hooks_read_tiles_at_call_time(both_dispatch, monkeypatch):
    calls = []
    monkeypatch.setattr(ops, "block_matmul",
                        lambda x, w, **kw: calls.append(kw) or x @ w)
    mm = dispatch.get_matmul()
    x, w = torch.ones(2, 3), torch.ones(3, 4)
    mm(x, w)
    with dispatch.tile_context({"matmul": {"bm": 16, "bk": 32, "bn": 32}}):
        mm(x, w)
    assert calls == [{}, {"bm": 16, "bk": 32, "bn": 32}]
