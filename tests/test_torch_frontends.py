"""The port's frontend configs (qwen2-vl-2b: M-RoPE over patch
embeddings; musicgen-large: sinusoidal positions over frame embeddings)
against the JAX package on the CPU.

Module level: ``_rope_angles`` and ``apply_rope`` with the reduced M-RoPE
sections (4, 6, 6) on positions whose three rows differ, bit for bit; at
the published sections (16, 24, 24) the angles within two fp32 ulps (the
two packages' ``pow`` differ in the last bit of one frequency, which a
position's product carries) and the
rotated bf16 values bit for bit; ``sinusoidal_pe`` within 1e-5 absolute
(XLA's and torch's ``exp``, ``sin`` and ``cos`` differ in the last
bits); ``input_specs`` and ``make_sample_inputs`` equal to the
reference's leaf for leaf.

Model level, on the reduced configs (three dense blocks, d_model 128, 4
heads over 2 KV heads of 32, d_ff 256) with the JAX initializer's
weights bridged over, against the reference compiled without XLA's
excess precision: ``prefill`` on embeddings with M-RoPE positions whose
rows differ (t 0, h i // 4, w i: the w row row-contiguous, so the
reference's kernel and plain paths agree), chained ``prefill_chunk``
calls, ``decode_step`` on an embedding and on a token, and ``forward`` on
every registered reduced config: logits within 2e-2 absolute (the
reference's own tolerance, ``tests/test_models.py``), greedy tokens
equal, KV entries within 2e-2 of each vector's largest entry; a capacity
MoE's ``forward`` parts only from a token whose router sat at a near-tie
(``ROUTER_TIE``, ``chip_smoke.py``'s rule).  Full
width: plans and trees equal the reference's, ``param_count`` and
``param_bytes`` too on all ten configs, inside the published ranges.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import frontends as jax_frontends  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model import make_plan as jax_make_plan  # noqa: E402
from repro.models.params import param_bytes as jax_param_bytes  # noqa: E402
from repro.models.params import param_count as jax_param_count  # noqa: E402
from repro_torch.bridge import cache_to_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config, \
    get_reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models import frontends  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.model import Model, plan_layers  # noqa: E402
from repro_torch.models.params import param_bytes, param_count, \
    tree_leaves_with_path  # noqa: E402
from test_torch_deepseek import _compiled_once, _exact, _f32, _leaf, _np, \
    _same_specs  # noqa: E402

ARCHS = ("qwen2-vl-2b", "musicgen-large")
MAX_LEN = 32
LOGIT_TOL = 2e-2
KV_TOL = 2e-2
PE_TOL = 1e-5
# a router whose k-th and (k+1)-th probabilities lie this close may pick
# another expert under a one-ulp difference upstream (chip_smoke.py's
# ROUTER_TIE)
ROUTER_TIE = 1e-2
# the published parameter ranges of tests/test_models.py
PUBLISHED = {
    "llama3-405b": (390e9, 420e9), "arctic-480b": (450e9, 500e9),
    "deepseek-v2-lite-16b": (14e9, 18e9), "gemma-2b": (2.0e9, 3.0e9),
    "minicpm-2b": (2.2e9, 3.3e9), "starcoder2-3b": (2.8e9, 3.5e9),
    "mamba2-780m": (0.6e9, 0.9e9), "recurrentgemma-2b": (2.2e9, 3.4e9),
    "musicgen-large": (1.8e9, 2.6e9), "qwen2-vl-2b": (1.3e9, 2.4e9)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: as fast
    alone, and the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mrope_positions(b, s, t0=0):
    """(3, B, S) positions whose rows differ: t 0, h (t0 + i) // 4, w
    t0 + i (row-contiguous)."""
    i = np.arange(t0, t0 + s)
    rows = np.stack([np.zeros_like(i), i // 4, i]).astype(np.int32)
    return np.broadcast_to(rows[:, None], (3, b, s)).copy()


# --------------------------------------------------------------------------
# module level
# --------------------------------------------------------------------------
@pytest.mark.parametrize("head_dim,sections", [(32, (4, 6, 6)),
                                               (128, (16, 24, 24)),
                                               (32, None)])
def test_rope_angles_and_rotation_match_reference(head_dim, sections):
    theta = 1e6
    pos = mrope_positions(2, 40, t0=3)
    if sections is None:
        pos = pos[-1]
    want = np.asarray(JL._rope_angles(jnp.asarray(pos), head_dim, theta,
                                      sections))
    got = TL._rope_angles(torch.from_numpy(pos), head_dim, theta,
                          sections).numpy()
    assert got.shape == want.shape == (2, 40, head_dim // 2)
    if head_dim == 32:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -22, atol=0)
    x = np.random.default_rng(0).standard_normal(
        (2, 40, 4, head_dim)).astype(np.float32)
    jx = JL.apply_rope(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos),
                       theta, sections)
    tx = TL.apply_rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos),
                       theta, sections)
    assert tx.dtype == torch.bfloat16
    np.testing.assert_array_equal(tx.float().numpy(), _np(jx))
    if sections is not None:
        # the rows differ, so the sections matter: the w row alone
        # rotates otherwise
        alone = TL.apply_rope(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(pos[-1]), theta)
        assert not torch.equal(alone, tx)


def test_rope_sections_must_split_the_pairs():
    pos = torch.from_numpy(mrope_positions(1, 4))
    with pytest.raises(ValueError, match="sections"):
        TL._rope_angles(pos, 32, 1e6, (4, 6, 5))


@pytest.mark.parametrize("width", [128, 2048])
def test_sinusoidal_pe_matches_reference(width):
    pos = (np.arange(40).reshape(2, 20) + 5).astype(np.int32)
    want = np.asarray(JL.sinusoidal_pe(jnp.asarray(pos), width))
    got = TL.sinusoidal_pe(torch.from_numpy(pos), width)
    assert got.dtype == torch.float32 and got.shape == (2, 20, width)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PE_TOL)


MODES = {"train": (16, 2), "prefill": (12, 3), "decode": (1, 4)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", ARCHS + ("gemma-2b",))
def test_input_specs_and_samples_match_reference(arch, mode):
    s, b = MODES[mode]
    jcfg, tcfg = jax_reduced_config(arch), get_reduced_config(arch)
    jshape = JaxShapeConfig("s", seq_len=s, global_batch=b, mode=mode)
    tshape = ShapeConfig("s", seq_len=s, global_batch=b, mode=mode)
    jspecs = jax_frontends.input_specs(jcfg, jshape)
    tspecs = frontends.input_specs(tcfg, tshape)
    assert set(tspecs) == set(jspecs)
    for name, spec in tspecs.items():
        assert spec.shape == jspecs[name].shape, name
        assert spec.axes == jspecs[name].axes, name
        assert str(spec.dtype).rsplit(".", 1)[-1] == \
            np.dtype(jspecs[name].dtype).name, name
    want = jax_frontends.make_sample_inputs(jcfg, jshape, seed=7)
    got = frontends.make_sample_inputs(tcfg, tshape, device="cpu", seed=7)
    assert set(got) == set(want)
    for name, leaf in got.items():
        assert leaf.device.type == "cpu"
        assert str(leaf.dtype).rsplit(".", 1)[-1] == \
            np.dtype(want[name].dtype).name, name
        np.testing.assert_array_equal(leaf.float().numpy(), _np(want[name]))
    if arch == "qwen2-vl-2b" and mode != "decode":
        assert set(got) >= {"embeds", "positions"}


# --------------------------------------------------------------------------
# plans, trees, parameter counts
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_plans_and_trees_match_reference(arch):
    """Planned as dense blocks, as the reference plans both; parameter,
    cache and paged-cache specs under the same paths, shapes, axes and
    dtypes at full width (specs only: nothing is allocated)."""
    for which in ("full", "reduced"):
        jcfg = (jax_config if which == "full" else jax_reduced_config)(arch)
        tcfg = (get_config if which == "full" else get_reduced_config)(arch)
        got, want = plan_layers(tcfg), jax_make_plan(jcfg)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.scan_kinds == ("dense",)
    jmodel, tmodel = build_model(jax_config(arch)), Model(get_config(arch))
    params = _same_specs(tmodel.param_specs(), jmodel.param_specs())
    _same_specs(tmodel.cache_specs(3, 512), jmodel.cache_specs(3, 512))
    _same_specs(tmodel.paged_cache_specs(3, 512, 40, 16),
                jmodel.paged_cache_specs(3, 512, 40, 16))
    assert tmodel.all_cache_leaves_paged()
    assert not tmodel.has_recurrent_leaves()
    cfg = tmodel.cfg
    if arch == "musicgen-large":
        assert params[("blocks", "dense", "mlp", "b_up")].shape == \
            (48, 8192)
        assert ("embed", "unembed") in params
    else:
        assert params[("blocks", "dense", "mlp", "w_gate")].shape == \
            (28, 1536, 8960)
        assert ("embed", "unembed") not in params
    assert cfg.num_heads // cfg.num_kv_heads == \
        {"qwen2-vl-2b": 6, "musicgen-large": 1}[arch]


def test_param_counts_match_reference():
    """``param_count`` and ``param_bytes`` equal the reference's on all
    ten full configs and lie in the published ranges."""
    assert ARCH_NAMES == JAX_ARCH_NAMES
    assert set(PUBLISHED) == set(ARCH_NAMES)
    for arch in ARCH_NAMES:
        tspecs = Model(get_config(arch)).param_specs()
        jspecs = build_model(jax_config(arch)).param_specs()
        n = param_count(tspecs)
        assert n == jax_param_count(jspecs), arch
        assert param_bytes(tspecs) == jax_param_bytes(jspecs), arch
        lo, hi = PUBLISHED[arch]
        assert lo <= n <= hi, (arch, n)
    small = {"a": TL.ParamSpec((3, 4), axes=("embed", "mlp")),
             "b": {"c": TL.ParamSpec((5,), torch.float32, ("embed",))}}
    assert param_count(small) == 17
    assert param_bytes(small) == 3 * 4 * 2 + 5 * 4


# --------------------------------------------------------------------------
# entry points on the reduced configs
# --------------------------------------------------------------------------
def _bridged(arch):
    jmodel = build_model(jax_reduced_config(arch))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jmodel, jparams, Model(get_reduced_config(arch)), tparams


@pytest.fixture(scope="module")
def pairs():
    return {arch: _bridged(arch) for arch in ARCHS}


def _assert_cache(got, want):
    for path, t in tree_leaves_with_path(got):
        j = _leaf(want, path)
        assert t.shape == j.shape, path
        scale = np.abs(j).max(axis=-1, keepdims=True)
        assert np.all(np.abs(t - j) <= KV_TOL * scale), path


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1),
                                  _np(want).argmax(-1))


def _embeds(seed, b, s, m):
    """0.02-scaled normals rounded to bf16, as ``make_sample_inputs``
    draws them: the port's tensor and the reference's array."""
    val = 0.02 * np.random.default_rng(seed).standard_normal((b, s, m))
    t = torch.from_numpy(val).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _inputs(cfg, seed, b, s, t0=0):
    """An embedding prompt of ``s`` positions from ``t0``: the port's and
    the reference's inputs (M-RoPE positions whose rows differ)."""
    t, j = _embeds(seed, b, s, cfg.d_model)
    tin, jin = {"embeds": t}, {"embeds": j}
    if cfg.pos_embed == "mrope":
        pos = mrope_positions(b, s, t0)
        tin["positions"] = torch.from_numpy(pos)
        jin["positions"] = jnp.asarray(pos)
    return tin, jin


@pytest.mark.parametrize("arch", ARCHS)
def test_embedding_entry_points_match_reference(pairs, arch):
    """Prefill 12 patch or frame embeddings on two rows; the same prompt
    as chained 8-position chunks (8 real, then 4 real of 8) from an empty
    cache, which must equal the monolithic prefill within the tolerance;
    then a decode step on an embedding at 12 and one on a token at 13.
    Logits, tokens and caches against the exact reference."""
    jmodel, jp, tmodel, tp = pairs[arch]
    cfg = tmodel.cfg
    tin, jin = _inputs(cfg, 1, 2, 12)
    jl, jc = _exact(lambda p, x, c: jmodel.prefill(p, x, c), jp, jin,
                    jmodel.init_cache(2, MAX_LEN))
    tl, tc = tmodel.prefill(tp, tin, tmodel.init_cache(2, MAX_LEN, "cpu"))
    _close(tl, jl)
    _assert_cache(cache_to_numpy(tc), _f32(jc))

    chunk = _compiled_once(lambda p, x, c, t0, vl: jmodel.prefill_chunk(
        p, x, c, t0, vl))
    jcc, tcc = jmodel.init_cache(2, MAX_LEN), tmodel.init_cache(2, MAX_LEN,
                                                                 "cpu")
    for t0, n in ((0, 8), (8, 4)):
        tpart = {"embeds": torch.zeros(2, 8, cfg.d_model,
                                       dtype=torch.bfloat16)}
        tpart["embeds"][:, :n] = tin["embeds"][:, t0:t0 + n]
        jpart = {"embeds": jnp.asarray(tpart["embeds"].float().numpy()
                                       ).astype(jnp.bfloat16)}
        if "positions" in tin:
            pos = mrope_positions(2, 8, t0)
            tpart["positions"] = torch.from_numpy(pos)
            jpart["positions"] = jnp.asarray(pos)
        jlc, jcc = chunk(jp, jpart, jcc, jnp.int32(t0), jnp.int32(n))
        tlc, tcc = tmodel.prefill_chunk(tp, tpart, tcc, torch.tensor(t0),
                                        torch.tensor(n))
        _close(tlc, jlc)
    _close(tlc, jl)
    np.testing.assert_allclose(tlc.numpy(), tl.numpy(), rtol=0,
                               atol=LOGIT_TOL)
    chunked = cache_to_numpy(tcc)
    for path, leaf in tree_leaves_with_path(cache_to_numpy(tc)):
        got, want = _leaf(chunked, path)[:, :, :12], leaf[:, :, :12]
        scale = np.abs(want).max(axis=-1, keepdims=True)
        assert np.all(np.abs(got - want) <= KV_TOL * scale), path

    step_e = {"embeds": _embeds(2, 2, 1, cfg.d_model)[0][:, 0]}
    jl, jc = _exact(lambda p, x, c, t: jmodel.decode_step(p, x, c, t), jp,
                    {"embeds": jnp.asarray(step_e["embeds"].float().numpy()
                                           ).astype(jnp.bfloat16)},
                    jc, jnp.asarray([12, 12], jnp.int32))
    tl, tc = tmodel.decode_step(tp, step_e, tc, torch.tensor([12, 12]))
    _close(tl, jl)
    nxt = np.argmax(_np(jl), -1).astype(np.int32)
    jl, jc = _exact(lambda p, x, c, t: jmodel.decode_step(
        p, {"tokens": x}, c, t), jp, jnp.asarray(nxt), jc,
        jnp.asarray([13, 13], jnp.int32))
    tl, tc = tmodel.decode_step(tp, {"tokens": torch.from_numpy(
        nxt.astype(np.int64))}, tc, torch.tensor([13, 13]))
    _close(tl, jl)
    _assert_cache(cache_to_numpy(tc), _f32(jc))


@pytest.mark.parametrize("arch", ARCHS)
def test_default_positions_and_sinusoidal_inputs(pairs, arch):
    """Without ``positions`` an M-RoPE config broadcasts row-contiguous
    positions to all three rows, and a prefill given them equals one
    without; a token prompt of a sinusoidal config carries the encoding
    (the same tokens at other positions give other logits)."""
    _, _, tmodel, tp = pairs[arch]
    pos = tmodel._default_positions(2, 5, torch.tensor([3, 7]), "cpu")
    want = torch.tensor([[3, 4, 5, 6, 7], [7, 8, 9, 10, 11]])
    if arch == "qwen2-vl-2b":
        assert pos.shape == (3, 2, 5)
        assert all(torch.equal(pos[i], want) for i in range(3))
    else:
        assert torch.equal(pos, want)
    tin, _ = _inputs(tmodel.cfg, 3, 2, 6)
    x = tmodel._embed_inputs(tp, {"tokens": torch.tensor([[5] * 6] * 2)},
                             tmodel._default_positions(2, 6, 0, "cpu"))
    if arch == "musicgen-large":
        assert not torch.equal(x[:, 0], x[:, 1])
        return
    assert torch.equal(x[:, 0], x[:, 1])
    got, _ = tmodel.prefill(tp, {"embeds": tin["embeds"]},
                            tmodel.init_cache(2, MAX_LEN, "cpu"))
    with_pos, _ = tmodel.prefill(tp, {"embeds": tin["embeds"],
                                      "positions": tmodel._default_positions(
                                          2, 6, 0, "cpu")},
                                 tmodel.init_cache(2, MAX_LEN, "cpu"))
    assert torch.equal(got, with_pos)


def _router_ties(monkeypatch, b, s):
    """Record, for each flattened token (row-major, as the routing group
    flattens them), the smallest gap between the k-th and the (k+1)-th
    router probability over the port's MoE layers."""
    gaps = torch.full((b * s,), float("inf"))
    real = moe_mod.route_tokens

    def recording(params, xg, moe):
        out = real(params, xg, moe)
        top = out[0].sort(dim=-1, descending=True).values
        gap = (top[..., moe.top_k - 1] - top[..., moe.top_k]).reshape(-1)
        torch.minimum(gaps, gap, out=gaps)
        return out
    monkeypatch.setattr(moe_mod, "route_tokens", recording)
    return gaps


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_matches_reference(arch, monkeypatch):
    """Full-sequence logits of every registered reduced config, tokens
    (or embeddings and M-RoPE positions) from ``make_sample_inputs``,
    against the exact reference, and the last position's against the
    port's own ``prefill`` bit for bit.  A capacity MoE config may part
    from the reference only from a token on whose router, in some layer,
    held its k-th and (k+1)-th expert within ROUTER_TIE (a one-ulp
    difference upstream then picks another expert; the routing group's
    later tokens take other capacity slots); its load-balance loss within
    1e-5 relative where nothing parted, else 1e-3."""
    jmodel, jp, tmodel, tp = _bridged(arch)
    cfg = tmodel.cfg
    b, s = 2, 16
    shape = ("s", s, b, "prefill")
    jin = jax_frontends.make_sample_inputs(
        jmodel.cfg, JaxShapeConfig(*shape), seed=4)
    tin = frontends.make_sample_inputs(cfg, ShapeConfig(*shape),
                                       device="cpu", seed=4)
    if arch == "qwen2-vl-2b":
        pos = mrope_positions(b, s)
        jin["positions"], tin["positions"] = jnp.asarray(pos), \
            torch.from_numpy(pos)
    gaps = _router_ties(monkeypatch, b, s) if cfg.moe else None
    jl, jaux = _exact(lambda p, x: jmodel.forward(p, x), jp, jin)
    tl, taux = tmodel.forward(tp, tin)
    assert tl.shape == (b, s, cfg.vocab_size)
    assert tl.dtype == torch.float32 and taux.dtype == torch.float32
    parted = ~np.all(np.abs(tl.numpy() - _np(jl)) <= LOGIT_TOL, axis=-1)
    if cfg.moe is None:
        assert not parted.any(), np.argwhere(parted)
    else:
        ties = (gaps < ROUTER_TIE).nonzero().reshape(-1).tolist()
        first = np.flatnonzero(parted.reshape(-1))
        assert not first.size or (ties and ties[0] <= first[0]), \
            (first, ties)
    np.testing.assert_allclose(float(taux), float(jaux),
                               rtol=1e-3 if parted.any() else 1e-5,
                               atol=1e-6)
    assert (float(taux) > 0) == (cfg.moe is not None)
    if cfg.moe is None:
        pre, _ = tmodel.prefill(tp, tin, tmodel.init_cache(b, MAX_LEN, "cpu"))
        assert torch.equal(pre, tl[:, -1])
