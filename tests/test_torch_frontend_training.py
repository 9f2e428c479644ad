"""A train step of a frontend config whose token embedding the loss does
not read, against the JAX package's, on the CPU.

Reduced musicgen-large takes frame embeddings and unembeds through its
own matrix, so its ``embed/embedding`` leaf gets no gradient from
autograd; the reference's ``jax.grad`` gives it zeros, and AdamW then
decays it.  The port's step gives such a leaf zeros too (the dry-run of
``musicgen-large`` x ``train_4k`` found the gap): one step from the
reference's state on the reference's batch (``make_sample_inputs``,
equal leaf for leaf) gives the reference's loss and first moments (the
gradients times 1 - b1), within the tolerances of
``tests/test_torch_training.py``; the unread leaf's moments are zero and
its master is decayed, nothing else, under one microbatch and under
two.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.models import build_model, make_sample_inputs  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jstep  # noqa: E402
from repro_torch.bridge import train_state_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models.frontends import make_sample_inputs as \
    port_sample_inputs  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import path_str, \
    tree_leaves_with_path  # noqa: E402
from repro_torch.training import train_step as tstep  # noqa: E402

EXACT = {"xla_allow_excess_precision": False}
SEQ, BATCH = 16, 4
# tests/test_torch_training.py's: the loss of one batch, and each leaf's
# gradient, relative L2 (bf16 backprop rounds in other orders); here
# read through AdamW's first moment, (1 - b1) x the gradient
LOSS_RTOL = 1e-4
GRAD_RTOL = 2e-2
UNREAD = "embed/embedding"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: the test
    runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_ref(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in p): np.asarray(a, np.float64)
            for p, a in flat}


def _flat_port(tree) -> dict:
    return {path_str(p): t.detach().double().numpy()
            for p, t in tree_leaves_with_path(tree)}


@pytest.mark.parametrize("accum", [1, 2])
def test_frontend_step_decays_the_unread_embedding_as_the_reference(accum):
    jcfg = jax_reduced_config("musicgen-large")
    cfg = get_reduced_config("musicgen-large")
    assert jcfg.frontend != "none" and not jcfg.tie_embeddings
    jmodel, tmodel = build_model(jcfg), Model(cfg)
    tc = jstep.TrainConfig(optimizer=jopt.OptimizerConfig(
        lr=1e-2, warmup_steps=0, total_steps=8), accum_steps=accum)
    ttc = tstep.TrainConfig(optimizer=tstep.OptimizerConfig(
        lr=1e-2, warmup_steps=0, total_steps=8), accum_steps=accum)
    jstate = jstep.init_train_state(jmodel, jax.random.PRNGKey(0), tc)
    state = train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    jbatch = make_sample_inputs(jcfg, JaxShapeConfig("t", SEQ, BATCH,
                                                     "train"))
    batch = port_sample_inputs(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                               device="cpu")
    assert set(batch) == {"embeds", "labels"}
    before = _flat_port(state["opt"]["master"])[UNREAD]

    step = jax.jit(jstep.make_train_step(jmodel, tc)).lower(
        jstate, jbatch).compile(compiler_options=EXACT)
    jnew, jm = step(jstate, jbatch)
    new, m = tstep.make_train_step(tmodel, ttc)(state, batch)

    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        LOSS_RTOL * abs(float(jm["loss"]))
    want, got = _flat_ref(jnew["opt"]), _flat_port(new["opt"])
    assert set(got) == set(want)
    for p in want:
        if p.startswith("mu/") and p != f"mu/{UNREAD}":
            den = np.linalg.norm(want[p])
            assert den > 0 and \
                np.linalg.norm(got[p] - want[p]) <= GRAD_RTOL * den, p
    decay = 1.0 - 1e-2 * ttc.optimizer.weight_decay
    after = got[f"master/{UNREAD}"]
    assert np.allclose(after, before * decay, rtol=1e-6, atol=0)
    assert not np.any(got[f"mu/{UNREAD}"]) and not np.any(got[f"nu/{UNREAD}"])
