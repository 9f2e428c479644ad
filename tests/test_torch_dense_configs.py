"""The dense configs registered with arctic-480b (minicpm-2b, llama3-405b)
against the JAX package on the CPU, and the weight draw's two routes.

Model level: the reduced configs (three dense layers, d_model 128, 4
heads over 2 KV heads, d_ff 256; minicpm's tied embeddings, llama3's
rope theta 500000) and an MHA variant of reduced minicpm (4 KV heads, so
one query head a KV head, G = 1, as at full width), the JAX
initializer's weights bridged over: a prefill, a decode step, a padded
chunk, a decode quantum with a frozen row and a verify at acceptances d
and 2.  Logits within 2e-2 absolute of the reference compiled without
XLA's excess precision (the port rounds every op to bf16, as that
compile does); tokens, acceptances and positions equal; KV entries
within 2e-2 of each vector's largest entry; a frozen row's cache bit for
bit.  Full width: the trees equal the reference's (specs only, nothing
allocated).

Weights: every config registered before arctic-480b draws each leaf
whole, as ``init_params`` always did (bit for bit); a leaf past
``WHOLE_DRAW_ELEMENTS`` is drawn slice by slice, held on a small stand-in.
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
from repro_torch.bridge import cache_to_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.models import params as params_mod  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import ParamSpec, draws_in_slices, \
    init_params, std_of, tree_leaves_with_path, \
    tree_map_with_path  # noqa: E402
from test_torch_deepseek import _compiled_once, _exact, _f32, _leaf, _np, \
    _same_specs, _tokens, _tt  # noqa: E402

MAX_LEN = 64
LOGIT_TOL = 2e-2
KV_TOL = 2e-2
D = 4
# the configs registered before arctic-480b, minicpm-2b and llama3-405b
EARLIER = ("deepseek-v2-lite-16b", "gemma-2b", "mamba2-780m",
           "recurrentgemma-2b", "starcoder2-3b")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: as fast
    alone, and the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mha(cfg):
    return dataclasses.replace(cfg, name=cfg.name + "-mha",
                               num_kv_heads=cfg.num_heads)


CASES = {"minicpm-2b": ("minicpm-2b", False),
         "llama3-405b": ("llama3-405b", False),
         "minicpm-2b-mha": ("minicpm-2b", True)}


def _pair(case):
    arch, mha = CASES[case]
    jcfg, tcfg = jax_reduced_config(arch), get_reduced_config(arch)
    if mha:
        jcfg, tcfg = _mha(jcfg), _mha(tcfg)
    assert (tcfg.num_heads // tcfg.num_kv_heads) == (1 if mha else 2)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jmodel, jparams, Model(tcfg), tparams


def _assert_cache(got, want):
    for path, t in tree_leaves_with_path(got):
        j = _leaf(want, path)
        scale = np.abs(j).max(axis=-1, keepdims=True)
        assert np.all(np.abs(t - j) <= KV_TOL * scale), path


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1),
                                  _np(want).argmax(-1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_entry_points_match_reference(case):
    """Prefill 12 tokens on two rows, a decode step, a 16-token chunk of
    11 real tokens at a device-scalar start; then from that cache a
    4-step quantum with budgets 4 and 2, and a verify of depth 4 whose
    drafts are the reference's own stream (row 1's third replaced:
    acceptances 4 and 2).  Logits, tokens, positions and caches against
    the exact reference."""
    jmodel, jp, tmodel, tp = _pair(case)
    toks = np.stack([_tokens(1, 12), _tokens(2, 12)])
    jl, jc = _exact(lambda p, x, c: jmodel.prefill(p, {"tokens": x}, c),
                    jp, jnp.asarray(toks), jmodel.init_cache(2, MAX_LEN))
    tl, tc = tmodel.prefill(tp, {"tokens": _tt(toks)},
                            tmodel.init_cache(2, MAX_LEN, "cpu"))
    _close(tl, jl)
    nxt = np.argmax(_np(jl), -1).astype(np.int32)
    jl, jc = _exact(lambda p, x, c, t: jmodel.decode_step(
        p, {"tokens": x}, c, t), jp, jnp.asarray(nxt), jc,
        jnp.asarray([12, 12], jnp.int32))
    tl, tc = tmodel.decode_step(tp, {"tokens": _tt(nxt)}, tc, _tt([12, 12]))
    _close(tl, jl)
    chunk = np.stack([_tokens(3, 16), _tokens(4, 16)])
    jl, jc = _exact(lambda p, x, c: jmodel.prefill_chunk(
        p, {"tokens": x}, c, jnp.int32(13), jnp.int32(11)),
        jp, jnp.asarray(chunk), jc)
    tl, tc = tmodel.prefill_chunk(tp, {"tokens": _tt(chunk)}, tc,
                                  torch.tensor(13), torch.tensor(11))
    _close(tl, jl)
    _assert_cache(cache_to_numpy(tc), _f32(jc))

    first = np.argmax(_np(jl), -1).astype(np.int32)
    pos = np.asarray([24, 24], np.int32)
    quantum = _compiled_once(
        lambda p, t, c, q, n: jmodel.decode_quantum(p, t, c, q, n, D))
    stream = np.asarray(quantum(jp, jnp.asarray(first), jc, jnp.asarray(pos),
                                jnp.asarray([D, D], jnp.int32))[0])
    n_left = np.asarray([D, 2], np.int32)
    jblock, jc_q, jpos = quantum(jp, jnp.asarray(first), jc,
                                 jnp.asarray(pos), jnp.asarray(n_left))
    tc_v = tree_map_with_path(lambda _, a: a.clone(), tc)
    before = cache_to_numpy(tc)
    tblock, tc_q, tpos = tmodel.decode_quantum(tp, _tt(first), tc, _tt(pos),
                                               _tt(n_left), D)
    assert tc_q is tc
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    jblock = np.asarray(jblock)
    for i in range(2):
        np.testing.assert_array_equal(tblock[:n_left[i], i].numpy(),
                                      jblock[:n_left[i], i])
    after = cache_to_numpy(tc)
    _assert_cache(after, _f32(jc_q))
    # row 1 stopped after 2 steps: positions 26.. keep their entries
    for path, leaf in tree_leaves_with_path(after):
        np.testing.assert_array_equal(leaf[:, 1, 26:],
                                      _leaf(before, path)[:, 1, 26:])

    drafts = stream[:D].T.copy()
    drafts[1, 2] = (drafts[1, 2] + 1) % 256
    full = np.full(2, D + 1, np.int32)
    jout = _exact(jmodel.verify_quantum, jp, jnp.asarray(first),
                  jnp.asarray(drafts), jc, jnp.asarray(pos),
                  jnp.asarray(full))
    tout = tmodel.verify_quantum(tp, _tt(first), _tt(drafts), tc_v,
                                 _tt(pos), _tt(full))
    np.testing.assert_array_equal(np.asarray(jout[2]), [D, 2])
    for i in (0, 1, 2, 4):
        np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]))
    _assert_cache(cache_to_numpy(tc_v), _f32(jout[3]))


@pytest.mark.parametrize("arch", ["minicpm-2b", "llama3-405b"])
def test_trees_match_reference(arch):
    """Parameter, cache and paged-cache specs at full width under the same
    paths, shapes, axes and dtypes (specs only: nothing is allocated)."""
    jmodel, tmodel = build_model(jax_config(arch)), Model(get_config(arch))
    params = _same_specs(tmodel.param_specs(), jmodel.param_specs())
    _same_specs(tmodel.cache_specs(3, 512), jmodel.cache_specs(3, 512))
    _same_specs(tmodel.paged_cache_specs(3, 512, 40, 16),
                jmodel.paged_cache_specs(3, 512, 40, 16))
    assert tmodel.all_cache_leaves_paged()
    assert tmodel.paged_leaf_paths() == jmodel.paged_leaf_paths()
    cfg = tmodel.cfg
    assert params[("blocks", "dense", "mlp", "w_up")].shape == \
        (cfg.num_layers, cfg.d_model, cfg.d_ff)
    n = sum(s.size for s in params.values())
    assert (2.7e9 < n < 2.75e9) if arch == "minicpm-2b" \
        else (405e9 < n < 406e9)


# --------------------------------------------------------------------------
# the weight draw
# --------------------------------------------------------------------------
def _whole_draws(specs, generator):
    """``init_params`` as every config registered before arctic-480b
    draws: each normal leaf whole, in fp32, scaled and cast."""
    out: dict = {}
    for path, spec in tree_leaves_with_path(specs):
        if spec.init in ("zeros", "ones"):
            leaf = torch.full(spec.shape, float(spec.init == "ones"),
                              dtype=spec.dtype)
        else:
            leaf = torch.randn(spec.shape, generator=generator,
                               dtype=torch.float32)
            leaf = leaf.mul_(std_of(spec)).to(spec.dtype)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


@pytest.mark.parametrize("arch", EARLIER)
def test_earlier_configs_keep_their_weights(arch):
    """No leaf of the full config reaches the sliced route, and the
    reduced config's weights equal the whole-leaf draw bit for bit."""
    specs = Model(get_config(arch)).param_specs()
    assert not any(draws_in_slices(s) for _, s in tree_leaves_with_path(specs))
    specs = Model(get_reduced_config(arch)).param_specs()
    got = init_params(specs, torch.Generator().manual_seed(3), "cpu")
    want = _whole_draws(specs, torch.Generator().manual_seed(3))
    for path, leaf in tree_leaves_with_path(got):
        assert leaf.dtype == _leaf(want, path).dtype, path
        assert torch.equal(leaf, _leaf(want, path)), path


def test_sliced_draw_on_a_small_stand_in(monkeypatch):
    """With the thresholds at 1000 and 64 elements: a leaf of 768 is
    drawn whole (bit for bit the old route), one of 4 x 5 x 8 x 8 = 1280
    as 20 draws of 8 x 8 in index order, each scaled and cast; the
    arctic-480b expert stacks are the full-width configs' sliced leaves."""
    monkeypatch.setattr(params_mod, "WHOLE_DRAW_ELEMENTS", 1000)
    monkeypatch.setattr(params_mod, "SLICE_DRAW_ELEMENTS", 64)
    specs = {"a": ParamSpec((12, 8, 8), axes=("layers", "embed", "mlp")),
             "b": ParamSpec((4, 5, 8, 8),
                            axes=("layers", "expert", "embed", "mlp")),
             "c": ParamSpec((8,), torch.float32, ("embed",), init="ones")}
    assert [draws_in_slices(s) for s in specs.values()] == \
        [False, True, False]
    got = init_params(specs, torch.Generator().manual_seed(5), "cpu")
    gen = torch.Generator().manual_seed(5)
    want_a = torch.randn((12, 8, 8), generator=gen).mul_(
        std_of(specs["a"])).to(torch.bfloat16)
    std = std_of(specs["b"])
    want_b = torch.stack([torch.randn((8, 8), generator=gen).mul_(std).to(
        torch.bfloat16) for _ in range(20)]).reshape(4, 5, 8, 8)
    assert torch.equal(got["a"], want_a)
    assert torch.equal(got["b"], want_b)
    assert got["b"].dtype == torch.bfloat16
    assert torch.equal(got["c"], torch.ones(8))
    monkeypatch.undo()
    sliced = [p for p, s in tree_leaves_with_path(
        Model(get_config("arctic-480b")).param_specs()) if draws_in_slices(s)]
    assert sliced == [("blocks", "moe_arctic", "moe", w)
                      for w in ("w_down", "w_gate", "w_up")]
