"""The port against the JAX package on reduced starcoder2-3b (the JAX
parameters bridged over): LayerNorm with a bias, the non-gated
tanh-gelu MLP, grouped-query attention with two KV heads and a sliding
window of 32 in the reduced config.

Tolerances: logits within 2e-2 (``tests/test_torch_model.py``'s, inside
``tests/test_kernels.py``'s bf16 tolerance) against the reference both as
it runs by default and compiled without XLA's excess precision, and
identical greedy tokens.  Unlike gemma-2b, starcoder2 is not
bit-identical even without excess precision: its LayerNorm variance and
tanh-gelu are fp32 reductions and polynomials whose last ulp differs
between XLA and PyTorch, which can flip a bf16 rounding (measured: one
bf16 ulp on 18 of 512 prefill logits), as the ssm family's exp and
log1p do.
The engines run a 64-position cache so that prompts and decodes reach
past the window; dense and paged caches, chunked and staggered
admissions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from test_torch_model import SCAN_TOL, _exact, _np, _tt  # noqa: E402
from test_torch_core import shared_executables  # noqa: E402

ARCH = "starcoder2-3b"
MAX_LEN = 64
WINDOW = 32
PROMPT_LENS = (40, 9, 33, 5)       # two prompts longer than the window
N_NEW = 12


def _with_random_biases(tree, rng):
    """The reference initializes norm biases to zero; give every bias
    leaf random values so the LayerNorm's bias path is exercised."""
    def leaf(path, a):
        if getattr(path[-1], "key", None) != "bias":
            return a
        vals = rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return jnp.asarray(vals, a.dtype)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced_config(ARCH)
    jmodel = build_model(jcfg)
    jparams = _with_random_biases(jmodel.init(jax.random.PRNGKey(3)),
                                  np.random.default_rng(3))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jmodel, jparams, get_reduced_config(ARCH), tparams


@pytest.fixture(autouse=True)
def _clean_dispatch():
    yield
    for mod in (dispatch, jax_dispatch):
        mod.clear_tile_overrides()
        mod.install_ladder(None)


def test_reduced_config_is_the_family_the_test_claims(pair):
    jcfg, _, _, tcfg, _ = pair
    assert tcfg.norm_type == "layernorm" and tcfg.activation == "gelu"
    assert tcfg.num_kv_heads == 2 and tcfg.num_heads == 4
    assert tcfg.sliding_window == WINDOW == jcfg.sliding_window
    bias = pair[4]["blocks"]["dense"]["ln1"]["bias"]      # the norm's bias
    assert float(bias.abs().max()) > 0.0


def _logits_both(pair, exact):
    """A 40-token prefill (past the window), two decode steps at 40 and
    41, then an 8-token chunk at 48, on both models."""
    _, jmodel, jp, tcfg, tp = pair
    tmodel = Model(tcfg)
    run = _exact if exact else (lambda fn, *args: fn(*args))
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 256, (2, 40)).astype(np.int32)
    jc, tc = jmodel.init_cache(2, MAX_LEN), tmodel.init_cache(2, MAX_LEN,
                                                               "cpu")
    got, want = [], []
    jl, jc = run(lambda p, x, c: jmodel.prefill(p, {"tokens": x}, c),
                 jp, jnp.asarray(toks), jc)
    tl, tc = tmodel.prefill(tp, {"tokens": _tt(toks)}, tc)
    got.append(tl.numpy())
    want.append(_np(jl))
    for t in (40, 41):
        nxt = np.argmax(want[-1].reshape(2, -1, want[-1].shape[-1])[:, -1],
                        -1).astype(np.int32)
        jl, jc = run(lambda p, x, c, pos: jmodel.decode_step(
            p, {"tokens": x}, c, pos), jp, jnp.asarray(nxt), jc,
            jnp.asarray([t, t], jnp.int32))
        tl, tc = tmodel.decode_step(tp, {"tokens": _tt(nxt)}, tc, _tt([t, t]))
        got.append(tl.numpy())
        want.append(_np(jl))
    chunk = rng.integers(0, 256, (2, 8)).astype(np.int32)
    jl, jc = run(lambda p, x, c: jmodel.prefill_chunk(
        p, {"tokens": x}, c, jnp.int32(42), jnp.int32(8)),
        jp, jnp.asarray(chunk), jc)
    tl, tc = tmodel.prefill_chunk(tp, {"tokens": _tt(chunk)}, tc, 42, 8)
    got.append(tl.numpy())
    want.append(_np(jl))
    return got, want


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "scanned"])
def test_prefill_and_decode_logits_match_reference(pair, exact):
    got, want = _logits_both(pair, exact)
    clear = 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=SCAN_TOL)
        # the argmax agrees wherever the reference's top two are further
        # apart than the tolerance (random weights put some rows on ties)
        top2 = np.sort(w, -1)[..., -2:]
        rows = top2[..., 1] - top2[..., 0] > SCAN_TOL
        np.testing.assert_array_equal(g.argmax(-1)[rows], w.argmax(-1)[rows])
        clear += int(rows.sum())
    assert clear >= 4


def _serve(side_mod, cfg, params, prompts, **kw):
    """Staggered admissions into a 2-slot engine (a slot reused), chunked
    prefill of 8 tokens, 4-step fused quanta."""
    extra = {"device": "cpu"} if side_mod is torch_engine else {}
    engine = side_mod.ServingEngine(cfg, params, batch_slots=2,
                                    max_len=MAX_LEN, prefill_chunk_len=8,
                                    **extra, **kw)
    reqs = [side_mod.Request(rid=i, prompt=p, max_new_tokens=N_NEW)
            for i, p in enumerate(prompts)]
    assert engine.admit_request(reqs[0], drain=True)
    engine.step_quantum(4)
    assert engine.admit_request(reqs[1], drain=True)
    engine.step_quantum(4)
    engine.run_to_completion(reqs[2:])
    assert all(r.done for r in reqs)
    return engine, reqs


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_tokens_identical_to_jax_engine(pair, paged):
    jcfg, _, jparams, tcfg, tparams = pair
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    kw = {"page_size": 8} if paged else {}
    je, jreqs = _serve(jax_engine, jcfg, jparams, prompts, **kw)
    te, treqs = _serve(torch_engine, tcfg, tparams, prompts, **kw)
    for j, t in zip(jreqs, treqs):
        assert t.output == j.output, t.rid
    assert te.host_syncs == je.host_syncs
    assert te.prefill_chunks == je.prefill_chunks
    if paged:
        assert te.page_stats == je.page_stats
        assert te.pool.used_pages == 0


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
