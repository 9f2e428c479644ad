"""The port's capacity MoE (``repro_torch.models.moe``) against the JAX
package's ``apply_moe`` on the CPU, at the reduced deepseek-v2-lite-16b
widths (d_model 128, 4 experts of d_ff 64, top-2), one layer's seeded
weights on both sides, inputs made from seeded numpy.

  * outputs within 2e-2 of the reference (compiled without XLA's excess
    precision, as the port rounds) and the aux loss equal to 1e-6, with
    capacity binding (at least one token dropped, asserted) and with no
    drop;
  * routing: on seeds whose k-th and (k+1)-th router probabilities are
    more than ``CLEAR_GAP`` apart for every token (asserted), the chosen
    experts and every token's slot (dispatch and combine) equal the
    reference's routing (the reference's own lines, in ``jnp``);
  * a slot index >= the capacity is an all-zero row (a drop), as the
    reference's ``one_hot`` gives; a token every chosen expert drops comes
    out 0 on both sides;
  * exact ties resolve to the lower expert index, as ``jax.lax.top_k``;
  * the capacity is the reference's on the full config's serving shapes.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from test_torch_deepseek import reduced_params  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
TOL = 2e-2
CLEAR_GAP = 1e-3
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
    """One moe_ds layer's expert parameters, on both sides."""
    tparams, jparams = reduced_params(get_reduced_config(ARCH))
    tp = {k: v[0] for k, v in tparams["blocks"]["moe_ds"]["moe"].items()}
    jp = {k: v[0] for k, v in jparams["blocks"]["moe_ds"]["moe"].items()}
    return jax_reduced_config(ARCH), get_reduced_config(ARCH), jp, tp


def _cfgs(layer, capacity_factor):
    jcfg, tcfg = layer[0], layer[1]
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=capacity_factor)) for c in (jcfg, tcfg))


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _reference_routing(params, xg, moe_cfg):
    """The reference's routing lines (``repro.models.moe.apply_moe``):
    -> (probs, gate_idx, dispatch, combine), numpy."""
    g, sg, _ = xg.shape
    e, k = moe_cfg.num_experts, moe_cfg.top_k
    logits = jnp.einsum("gsm,me->gse", xg.astype(jnp.float32),
                        params["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(
        jnp.sum(gate_vals, axis=-1, keepdims=True), 1e-9)
    cap = max(1, int(math.ceil(sg * k * moe_cfg.capacity_factor / e)))
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.float32)
    flat = onehot.reshape(g, sg * k, e)
    pos = jnp.cumsum(flat, axis=1) - flat
    slot = jax.nn.one_hot(pos.astype(jnp.int32), cap,
                          dtype=jnp.float32) * flat[..., None]
    slot = slot.reshape(g, sg, k, e, cap)
    return tuple(np.asarray(a) for a in (
        probs, gate_idx, jnp.sum(slot, axis=2),
        jnp.sum(slot * gate_vals[..., None, None], axis=2)))


def _run(layer, capacity_factor, seed, shape):
    jcfg, tcfg = _cfgs(layer, capacity_factor)
    jp, tp = layer[2], layer[3]
    x = _x(seed, (*shape, jcfg.d_model))
    xj = jnp.asarray(x, jnp.bfloat16)
    fn = jax.jit(lambda p, a: jax_moe.apply_moe(p, a, jcfg, jcfg.moe))
    jout, jaux = fn.lower(jp, xj).compile(compiler_options=EXACT)(jp, xj)
    tout, taux = moe.capacity_moe(tp, torch.from_numpy(x).bfloat16(), tcfg,
                                  tcfg.moe)
    return (np.asarray(jout, np.float32), float(jaux),
            tout.float().numpy(), float(taux), x, jcfg, tcfg)


# capacity factor -> (seed, (B, S)): at 0.5 every group drops tokens; at 4
# every expert has room for every token of its group
CASES = {"binds": (0.5, 3, (2, 16)), "default": (1.25, 4, (4, 5)),
         "no drop": (4.0, 5, (2, 16))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_output_and_aux_match_reference(layer, case):
    cf, seed, shape = CASES[case]
    jout, jaux, tout, taux, x, jcfg, tcfg = _run(layer, cf, seed, shape)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=TOL)
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)
    # drops, counted from the port's routing
    total = shape[0] * shape[1]
    sg = moe.routing_group_size(total)
    xg = torch.from_numpy(x).bfloat16().reshape(total // sg, sg, -1)
    _, _, dispatch, _ = moe.route_tokens(layer[3], xg, tcfg.moe)
    routed = total * tcfg.moe.top_k
    kept = int(dispatch.sum())
    if case == "binds":
        assert kept < routed
    if case == "no drop":
        assert kept == routed


@pytest.mark.parametrize("seed", [12, 13, 16])
def test_routing_matches_reference_on_clear_gaps(layer, seed):
    """Chosen experts and slots equal the reference's, on inputs whose
    top-k choice is clear for every token (capacity binding)."""
    jcfg, tcfg = _cfgs(layer, 0.75)
    x = _x(seed, (1, 24, jcfg.d_model))
    xb = torch.from_numpy(x).bfloat16()
    probs, onehot, dispatch, combine = moe.route_tokens(layer[3], xb,
                                                        tcfg.moe)
    jprobs, jidx, jdisp, jcomb = _reference_routing(
        layer[2], jnp.asarray(x, jnp.bfloat16), jcfg.moe)
    k = tcfg.moe.top_k
    srt = np.sort(jprobs, axis=-1)[..., ::-1]
    assert (srt[..., k - 1] - srt[..., k]).min() > CLEAR_GAP
    np.testing.assert_allclose(probs.numpy(), jprobs, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(onehot.argmax(-1).numpy(), jidx)
    np.testing.assert_array_equal(dispatch.numpy(), jdisp)
    np.testing.assert_allclose(combine.numpy(), jcomb, rtol=0, atol=1e-6)
    assert dispatch.sum() < x.shape[1] * k


def test_slot_at_or_past_capacity_is_a_zero_row():
    cap = 3
    pos = np.array([0.0, 1.0, 2.0, 3.0, 5.0], np.float32)
    got = moe.capacity_slots(torch.from_numpy(pos), cap).numpy()
    want = np.asarray(jax.nn.one_hot(pos.astype(np.int32), cap))
    np.testing.assert_array_equal(got, want)
    assert not got[3:].any()


def test_fully_dropped_token_outputs_zero(layer):
    """With capacity 1 per expert (one slot for 16 tokens x 2 choices), a
    token all of whose experts are full comes out 0 on both sides."""
    jout, _, tout, _, x, _, tcfg = _run(layer, 0.125, 21, (1, 16))
    xg = torch.from_numpy(x).bfloat16()
    _, _, dispatch, _ = moe.route_tokens(layer[3], xg, tcfg.moe)
    dropped = dispatch[0].sum(dim=(1, 2)) == 0
    assert dropped.any()
    assert not tout[0][dropped.numpy()].any()
    assert not jout[0][dropped.numpy()].any()


@pytest.mark.parametrize("probs,want", [
    ([0.25, 0.25, 0.25, 0.25], [0, 1]),
    ([0.1, 0.3, 0.3, 0.3], [1, 2]),
    ([0.4, 0.2, 0.2, 0.2], [0, 1]),
    ([0.2, 0.1, 0.35, 0.35], [2, 3]),
])
def test_exact_ties_resolve_to_the_lower_expert(probs, want):
    p = np.asarray(probs, np.float32)[None]
    vals, idx = moe.ordered_top_k(torch.from_numpy(p), 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(p), 2)
    np.testing.assert_array_equal(idx.numpy()[0], want)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_tied_router_routes_as_reference(layer):
    """A router whose columns 1 and 3 are equal: experts 1 and 3 tie
    exactly for every token; where the pair straddles the top-k boundary
    both sides choose expert 1, with the same slots."""
    jcfg, tcfg = _cfgs(layer, 1.25)
    router = np.asarray(layer[2]["router"]).copy()
    router[:, 3] = router[:, 1]
    router[:, 0] -= 1.0
    jp = dict(layer[2], router=jnp.asarray(router))
    tp = dict(layer[3], router=torch.from_numpy(router))
    x = _x(31, (1, 8, jcfg.d_model))
    _, onehot, dispatch, _ = moe.route_tokens(
        tp, torch.from_numpy(x).bfloat16(), tcfg.moe)
    _, jidx, jdisp, _ = _reference_routing(
        jp, jnp.asarray(x, jnp.bfloat16), jcfg.moe)
    np.testing.assert_array_equal(onehot.argmax(-1).numpy(), jidx)
    np.testing.assert_array_equal(dispatch.numpy(), jdisp)
    # where one of the tied pair is chosen, it is the lower one
    has1, has3 = (jidx == 1).any(-1), (jidx == 3).any(-1)
    assert not (has3 & ~has1).any() and (has1 & ~has3).any()


def test_group_size_and_capacity_at_full_width():
    """The routing groups and capacities of deepseek's serving shapes: a
    4-row step, a 16-token chunk, a 4 x 5 verify, a 250-token prompt."""
    cfg = get_config(ARCH)
    for total, cap in ((4, 1), (16, 2), (20, 3), (250, 30)):
        sg = moe.routing_group_size(total)
        assert sg == jax_moe._group_size(total) == total
        assert moe.expert_capacity(sg, cfg.moe) == max(1, math.ceil(
            sg * 6 * 1.25 / 64)) == cap
    assert moe.routing_group_size(1024) == jax_moe._group_size(1024) == 512
    assert moe.routing_group_size(1026) == jax_moe._group_size(1026) == 342
