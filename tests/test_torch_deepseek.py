"""The port's moe family (deepseek-v2-lite-16b: MLA latent cache, capacity
MoE, a dense prologue layer) against the JAX model on the CPU, at the
model level: the reduced config (``pro_0`` then two stacked ``moe_ds``
blocks; d_model 128, 4 experts top-2, kv_lora_rank 32), the JAX
parameters bridged over, ``MAX_LEN`` 64.

Tolerances and why:
  * logits within 2e-2 absolute of the reference compiled without XLA's
    excess precision (as the port rounds every op to bf16; the default
    compile skips intermediate roundings and moves logits by up to ~7e-2
    on this model, through the routers);
  * greedy tokens and acceptances equal the exact reference's;
  * cache latents: the first layer's (``pro_0``, fed by the embeddings
    alone) within one bf16 ulp at the scale of each written vector
    (``tests/test_torch_mla.py``), the later layers' within 2e-2 of each
    vector's largest entry (a batched verify sums its MoE products in
    another order than XLA, and a later layer's input carries that);
  * rows that are not live keep their latents bit for bit.
The trees (parameters and caches) equal the reference's in paths, shapes,
axes and dtypes at full width, and the weight bridge carries the moe tree
(the fp32 router, the expert stacks, ``pro_0``) exactly.
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
from repro_torch.models.params import std_of, \
    tree_leaves_with_path  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
MAX_LEN = 64
LOGIT_TOL = 2e-2
LATENT_TOL = 2e-2
EXACT = {"xla_allow_excess_precision": False}
D = 4


def mla_only(cfg):
    """The MoE-free clone (the reference's ``_mla_only``): every layer
    ``ds_dense0`` (MLA and a dense MLP)."""
    return dataclasses.replace(cfg, name=cfg.name + "-mla-only",
                               first_dense_layers=cfg.num_layers)


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
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: as fast
    alone, and the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tree(tree):
    """A torch parameter tree as JAX arrays, dtypes kept (bf16 crosses
    through float32, which holds it exactly)."""
    def one(t):
        a = jnp.asarray(t.float().numpy())
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a
    return {k: jax_tree(v) if isinstance(v, dict) else one(v)
            for k, v in tree.items()}


def reduced_params(cfg, seed=0):
    """Weights made from a seed with numpy at the initializer's scales
    (``std_of``: fan-in scaled normals, 0.02 for embeddings, ones and
    zeros), as a port tree and the same values as a JAX tree (the JAX
    initializer compiles a random op per leaf shape: seconds a module)."""
    rng = np.random.default_rng(seed)
    tparams: dict = {}
    for path, spec in tree_leaves_with_path(Model(cfg).param_specs()):
        if spec.init in ("zeros", "ones"):
            leaf = np.full(spec.shape, float(spec.init == "ones"))
        else:
            leaf = rng.standard_normal(spec.shape) * std_of(spec)
        node = tparams
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.from_numpy(leaf.astype(np.float32)).to(
            spec.dtype)
    return tparams, jax_tree(tparams)


def reference_params():
    """The JAX model's own initializer's weights (reduced config) and the
    same values bridged to the port: the whole-model parity the port
    holds bit for bit against the reference compiled without excess
    precision (with other weights, one-ulp flips of the bf16 products in
    the dense first layer can flip a router downstream)."""
    jmodel = build_model(jax_reduced_config(ARCH))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jmodel, jparams, tparams


@pytest.fixture(scope="module")
def pair():
    jmodel, jparams, tparams = reference_params()
    return jmodel, jparams, Model(get_reduced_config(ARCH)), tparams


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _ulp(a):
    scale = np.abs(a).max(axis=-1, keepdims=True)
    return 2.0 ** (np.floor(np.log2(np.maximum(scale, 2.0 ** -126))) - 7)


def _assert_cache(got, want):
    """``pro_0``'s latents (fed by the embeddings alone) within one bf16
    ulp at each vector's scale, the stacked layers' within LATENT_TOL of
    each vector's largest entry (their inputs carry the upstream layers'
    ulp-level differences)."""
    for path, t in tree_leaves_with_path(got):
        j = _leaf(want, path)
        scale = np.abs(j).max(axis=-1, keepdims=True)
        tol = _ulp(j) if path[0] == "pro_0" else LATENT_TOL * scale
        assert np.all(np.abs(t - j) <= tol), path


# --------------------------------------------------------------------------
# plan, trees, bridge
# --------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["full", "reduced", "mla-only"])
def test_plan_matches_reference(which):
    if which == "full":
        jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    else:
        jcfg, tcfg = jax_reduced_config(ARCH), get_reduced_config(ARCH)
    if which == "mla-only":
        jcfg, tcfg = mla_only(jcfg), mla_only(tcfg)
    got, want = plan_layers(tcfg), jax_make_plan(jcfg)
    assert (got.prologue, got.scan_kinds, got.n_groups, got.epilogue) == \
        (want.prologue, want.scan_kinds, want.n_groups, want.epilogue)
    if which == "full":
        assert (got.prologue, got.scan_kinds, got.n_groups) == \
            (("ds_dense0",), ("moe_ds",), 26)


def test_dense_residual_moe_is_not_ported():
    """The dense-residual MoE block (``moe_arctic``) is planned as the
    reference plans it: on deepseek's config with ``dense_residual`` set
    (its dense prologue kept, then ``moe_arctic`` in place of ``moe_ds``)
    and on arctic-480b's own.  (The name is kept from when the port raised
    ``NotImplementedError`` for this block.)"""
    for name in (ARCH, "arctic-480b"):
        jcfg, tcfg = jax_config(name), get_config(name)
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, dense_residual=True))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, dense_residual=True))
        got, want = Model(tcfg).plan, jax_make_plan(jcfg)
        assert (got.prologue, got.scan_kinds, got.n_groups, got.epilogue) \
            == (want.prologue, want.scan_kinds, want.n_groups, want.epilogue)
        assert got.scan_kinds == ("moe_arctic",)


def _spec_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxParamSpec))
    return {tuple(p.key for p in path): s for path, s in flat}


def _same_specs(got, want):
    want = _spec_leaves(want)
    got = dict(tree_leaves_with_path(got))
    assert set(got) == set(want)
    for path, spec in got.items():
        assert spec.shape == want[path].shape, path
        assert spec.axes == want[path].axes, path
        assert str(spec.dtype).rsplit(".", 1)[-1] == \
            np.dtype(want[path].dtype).name, path
    return got


@pytest.mark.parametrize("which", ["full", "mla-only"])
def test_trees_match_reference(which):
    """Parameter, cache and paged-cache specs under the same paths,
    shapes, axes and dtypes; every cache leaf pages."""
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    if which == "mla-only":
        jcfg, tcfg = mla_only(jcfg), mla_only(tcfg)
    jmodel, tmodel = build_model(jcfg), Model(tcfg)
    params = _same_specs(tmodel.param_specs(), jmodel.param_specs())
    _same_specs(tmodel.cache_specs(3, 512), jmodel.cache_specs(3, 512))
    _same_specs(tmodel.paged_cache_specs(3, 512, 40, 16),
                jmodel.paged_cache_specs(3, 512, 40, 16))
    assert tmodel.all_cache_leaves_paged()
    assert not tmodel.has_recurrent_leaves()
    assert tmodel.paged_leaf_paths() == jmodel.paged_leaf_paths()
    if which == "full":
        experts = params[("blocks", "moe_ds", "moe", "w_gate")]
        assert experts.shape == (26, 64, 2048, 1408)
        assert params[("blocks", "moe_ds", "moe", "router")].dtype == \
            torch.float32
        assert params[("pro_0", "mlp", "w_up")].shape == (2048, 10944)
        assert params[("blocks", "moe_ds", "shared", "w_down")].shape == \
            (26, 2816, 2048)
        assert sum(s.size for s in params.values()) > 15.6e9


def test_bridge_round_trip_of_the_moe_tree(pair):
    """Every leaf crosses exactly: the router stays fp32, the expert
    stacks and ``pro_0`` bf16, values unchanged."""
    _, jparams, _, tparams = pair
    back = cache_to_numpy(tparams)
    for path, leaf in tree_leaves_with_path(tparams):
        j = np.asarray(_leaf(jparams, path), np.float32)
        np.testing.assert_array_equal(_leaf(back, path), j,
                                      err_msg=str(path))
        want = "float32" if path[-1] in ("router", "scale") else "bfloat16"
        assert str(leaf.dtype) == f"torch.{want}", path
    assert tuple(tparams["blocks"]["moe_ds"]["moe"]["w_gate"].shape) == \
        (2, 4, 128, 64)
    assert set(tparams["pro_0"]) == {"ln1", "attn", "ln2", "mlp"}


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


# prompt lengths of the batched quantum and verify rows
LENS = (3, 10, 21)
STREAM_LEN = D + 2


def _compiled_once(fn):
    """``fn`` jitted and compiled without excess precision at its first
    call's shapes, that executable reused after."""
    exe = []

    def call(*args):
        if not exe:
            exe.append(jax.jit(fn).lower(*args).compile(
                compiler_options=EXACT))
        return exe[0](*args)
    return call


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


def _set_row(cache, row, i):
    def put(path, c, r):
        ax = jax_batch_axis(path)
        idx = (slice(None),) * ax + (i,)
        return c.at[idx].set(r[(slice(None),) * ax + (0,)])
    return jax.tree_util.tree_map_with_path(put, cache, row)


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
    latent bit for bit, written in place."""
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
    cache equal the exact reference's.

    The drafts are the exact reference verify's own argmax, with row 0's
    first and row 1's third draft replaced by another token, iterated to
    a fixed point: the verify routes all rows' drafts together, so each
    row's argmax depends on every row's drafts."""
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


def test_paged_decode_equals_dense_decode(pair, streams):
    """Decode steps and a verify on a paged cache (shuffled pages of 8)
    give the dense cache's logits bit for bit, and the pools hold the
    dense rows' latents."""
    _, _, tmodel, tp = pair
    _, dense, first, pos = _batched(pair, streams)
    ps, n_pages = 8, 3 * MAX_LEN // 8
    paged = tmodel.init_paged_cache(3, MAX_LEN, n_pages, ps, "cpu")
    table = 1 + np.random.default_rng(5).permutation(n_pages).reshape(3, -1)
    paged["page_table"].copy_(torch.from_numpy(table.astype(np.int32)))
    for path, leaf in tree_leaves_with_path(dense):
        pool = _leaf(paged, path)
        ax = cache_batch_axis(path)
        rows = leaf.reshape(*leaf.shape[:ax], 3 * MAX_LEN // ps, ps,
                            *leaf.shape[ax + 2:])
        pool.index_copy_(ax, torch.from_numpy(table.reshape(-1)), rows)
    toks = _tt(first)
    for step in range(3):
        got, _ = tmodel.decode_step(tp, {"tokens": toks}, paged,
                                    _tt(pos + step))
        want, _ = tmodel.decode_step(tp, {"tokens": toks}, dense,
                                     _tt(pos + step))
        assert torch.equal(got, want), step
        toks = want.argmax(-1)
    drafts = torch.stack([toks] * D, dim=1)
    n_left = _tt([D + 1] * 3)
    got = tmodel.verify_quantum(tp, toks, drafts, paged, _tt(pos + 3),
                                n_left)
    want = tmodel.verify_quantum(tp, toks, drafts, dense, _tt(pos + 3),
                                 n_left)
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert torch.equal(g, w)
    for path, leaf in tree_leaves_with_path(dense):
        ax = cache_batch_axis(path)
        pool = _leaf(paged, path).index_select(
            ax, torch.from_numpy(table.reshape(-1)))
        assert torch.equal(pool.reshape(leaf.shape), leaf), path
