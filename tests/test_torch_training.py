"""The port's training path against the JAX package on the CPU.

Model level, on reduced gemma-2b (three dense blocks, d_model 128, 4
heads over 1 KV head of 32, vocab 256) started on both sides from one
reference train state carried over by ``bridge.train_state_from_numpy``,
against the reference compiled without XLA's excess precision: ``loss``
within LOSS_RTOL of ``Model.loss``, and every leaf's gradient within
GRAD_RTOL relative L2 of ``jax.value_and_grad``'s under remat ``"none"``,
``"full"`` and ``"dots"``.

Optimizer level: AdamW and Adafactor fed the same numpy grads (clipping
engaged) give the reference's master, moments and statistics within
OPT_RTOL of each leaf's largest entry, step after step.  AdamW's first
step moves a weight by about lr * sign(g), so a one-ulp grad difference
near 0 moves it by 2 lr: whole steps are held on the loss trajectory
(TRAJECTORY_RTOL), never on master bits.

The rest of the step: the schedules on a grid of steps, the int8
error-feedback compression bit for bit, ``accum_steps=2`` against 1,
exact kernel calls per step under each remat (B1 and B2 counted where
they would launch on the card); reduced starcoder2-3b's loss falls under
both optimizers (the reference's ``test_loss_decreases``), reduced
deepseek-v2-lite-16b's loss with its MoE aux term equals the reference's
on the reference's own initial weights; the data pipeline's batches equal
the reference's bit for bit; ``launch.train.main`` trains in process; the
kernels' autograd paths equal autograd of their plain versions.
"""
import collections
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.models import build_model, make_sample_inputs  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jstep  # noqa: E402
from repro_torch.bridge import cache_to_numpy, params_from_numpy, \
    train_state_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels import block_matmul as bm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models.frontends import make_sample_inputs as \
    torch_sample_inputs  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import path_str, \
    tree_leaves_with_path  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tstep  # noqa: E402

EXACT = {"xla_allow_excess_precision": False}
SEQ, BATCH = 16, 4
# the loss of one batch, port against the reference (same state): the
# forward is the reference's op for op (readings: 7.1e-6 relative on
# reduced gemma-2b, 8.3e-8 on reduced deepseek at 4 x 8)
LOSS_RTOL = 1e-4
# per-leaf gradient, relative L2 against the reference's: bf16 backprop
# rounds products and sums in other orders (readings: largest 3.9e-3,
# blocks/dense/attn/wq, under every remat)
GRAD_RTOL = 2e-2
# optimizer state after an update from the same grads, against each
# leaf's largest entry: fp32 arithmetic op for op, the global norm summed
# in another order (readings: at most 4.8e-7 for AdamW, 5.9e-7 for
# Adafactor, over three steps)
OPT_RTOL = 1e-6
# the loss over five whole steps (lr 1e-2), against the reference's
# (readings: at most 6.1e-4 relative under AdamW, 7.7e-4 under Adafactor)
TRAJECTORY_RTOL = 5e-3
# accum_steps=2 against 1 on the same batch: the loss (readings 9e-8
# relative) and each leaf's gradient, relative L2 (readings 3.4e-3 in
# fp32, 3.8e-3 with a bf16 accumulator)
ACCUM_LOSS_RTOL = 1e-5
ACCUM_GRAD_RTOL = 2e-2
REMATS = ("none", "full", "dots")
# a router whose k-th and (k+1)-th probabilities lie this close may pick
# another expert under a one-ulp difference upstream (chip_smoke.py's
# ROUTER_TIE); a loss across such a flip, against the reference's
# (readings: 1.8e-4 relative at the reduced deepseek's 4 x 16 batch, its
# aux term 8.9e-6)
ROUTER_TIE = 1e-2
MOE_TIE_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: as fast
    alone, and the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compiled(fn, *args):
    """``fn`` jitted and compiled without excess precision at ``args``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree) -> dict:
    """path string -> float64 numpy leaf, for a JAX or a port tree."""
    if isinstance(tree, dict) and any(
            isinstance(v, torch.Tensor) for _, v in
            tree_leaves_with_path(tree)):
        tree = cache_to_numpy(tree)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in p): np.asarray(a, np.float64)
            for p, a in flat}


def _rel_l2(got, want) -> float:
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else \
        float(np.linalg.norm(got))


def _tokens(step=0, vocab=256):
    return JaxTokenPipeline(JaxDataConfig(
        vocab_size=vocab, seq_len=SEQ, global_batch=BATCH)).batch(step)


@pytest.fixture(scope="module")
def gemma():
    """Reduced gemma-2b on both sides and the reference's AdamW train
    state (PRNGKey(0))."""
    jcfg = jax_reduced_config("gemma-2b")
    jmodel, tmodel = build_model(jcfg), Model(get_reduced_config("gemma-2b"))
    tc = jstep.TrainConfig(optimizer=jopt.OptimizerConfig(
        lr=1e-2, warmup_steps=0, total_steps=8))
    state = jstep.init_train_state(jmodel, jax.random.PRNGKey(0), tc)
    return jmodel, tmodel, tc, state


@pytest.fixture(scope="module")
def reference_grads(gemma):
    """The reference's (loss, grads) of batch 0 under each remat, each
    compiled once."""
    jmodel, _, _, state = gemma
    specs = jmodel.param_specs()
    batch = {"tokens": jnp.asarray(_tokens()["tokens"])}
    master = state["opt"]["master"]
    out = {}
    for remat in REMATS:
        def loss(m, b, remat=remat):
            return jmodel.loss(jstep.cast_params(m, specs), b,
                               remat=remat)[0]
        vg = jax.value_and_grad(loss)
        out[remat] = _compiled(vg, master, batch)(master, batch)
    return out


def _port_grads(tmodel, state, tokens, remat):
    params = tstep.cast_params(state["opt"]["master"], tmodel.param_specs())
    loss, parts = tmodel.loss(params, {"tokens": torch.from_numpy(tokens)},
                              remat=remat)
    loss.backward()
    loss = loss.detach()
    grads = {path_str(p): leaf.grad.double().numpy()
             for p, leaf in tree_leaves_with_path(state["opt"]["master"])}
    return float(loss), grads


@pytest.mark.parametrize("remat", REMATS)
def test_loss_and_grads_match_reference(gemma, reference_grads, remat):
    _, tmodel, _, jstate = gemma
    state = train_state_from_numpy(_np_tree(jstate), device="cpu")
    loss, grads = _port_grads(tmodel, state, _tokens()["tokens"], remat)
    jloss, jgrads = reference_grads[remat]
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    jgrads = _flat(jgrads)
    assert set(grads) == set(jgrads)
    worst = max((_rel_l2(grads[p], jgrads[p]), p) for p in grads)
    print(f"remat {remat}: loss {loss:.7f} vs {float(jloss):.7f}; largest "
          f"grad relative L2 {worst[0]:.3e} ({worst[1]})")
    assert worst[0] <= GRAD_RTOL, worst
    assert all(np.any(g != 0) for g in grads.values())


def test_train_state_crosses_the_bridge():
    """The reference's states (AdamW with the int8 residual, Adafactor's
    factored and full statistics) land leaf for leaf, dtypes kept, in
    the port's own layout, master leaves requiring grad."""
    jmodel = build_model(jax_reduced_config("gemma-2b"))
    tmodel = Model(get_reduced_config("gemma-2b"))
    for name, comp in (("adamw", "int8"), ("adafactor", "none")):
        tc = jstep.TrainConfig(optimizer=jopt.OptimizerConfig(name=name),
                               grad_compression=comp)
        jstate = jstep.init_train_state(jmodel, jax.random.PRNGKey(1), tc)
        state = train_state_from_numpy(_np_tree(jstate), device="cpu")
        own = tstep.init_train_state(
            tmodel, torch.Generator().manual_seed(0),
            tstep.TrainConfig(optimizer=topt.OptimizerConfig(name=name),
                              grad_compression=comp), "cpu")
        for tree in (state, own):
            layout = {path_str(p): (tuple(t.shape), t.dtype)
                      for p, t in tree_leaves_with_path(tree)}
            assert layout == {path_str(p): (tuple(t.shape), t.dtype)
                              for p, t in tree_leaves_with_path(state)}
        want = _flat(jstate)
        got = _flat(state)
        assert set(got) == set(want)
        for p in want:
            np.testing.assert_array_equal(got[p], want[p])
        assert state["step"].dtype == torch.int32
        assert all(t.requires_grad for _, t in
                   tree_leaves_with_path(state["opt"]["master"]))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference(name):
    jmodel = build_model(jax_reduced_config("gemma-2b"))
    params = jmodel.init(jax.random.PRNGKey(2))
    cfg = dict(name=name, lr=3e-3, warmup_steps=2, total_steps=10,
               grad_clip=1.0)
    jcfg, tcfg = jopt.OptimizerConfig(**cfg), topt.OptimizerConfig(**cfg)
    jstate = jopt.init_opt_state(jcfg, params)
    tstate = params_from_numpy(_np_tree(jstate), device="cpu")
    update = jax.jit(functools.partial(jopt.apply_updates, jcfg))
    rng = np.random.default_rng(0)
    for step in range(3):
        # step 1's grads are large enough that clipping engages
        scale = 10.0 if step == 1 else 0.01
        grads = jax.tree_util.tree_map(
            lambda p: (scale * rng.standard_normal(p.shape)).astype(
                np.float32), params)
        jstate, jm = update(grads, jstate, jnp.int32(step))
        tgrads = params_from_numpy(grads, device="cpu")
        with torch.no_grad():
            tstate, tm = topt.apply_updates(
                tcfg, tgrads, tstate, torch.tensor(step, dtype=torch.int32))
        for key in ("grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                OPT_RTOL * abs(float(jm[key])), (step, key)
        want, got = _flat(jstate), _flat(tstate)
        assert set(got) == set(want)
        worst = 0.0
        for p in want:
            scale_p = np.abs(want[p]).max()
            err = np.abs(got[p] - want[p]).max()
            worst = max(worst, err / scale_p if scale_p else err)
        print(f"{name} step {step}: largest error {worst:.2e} of a leaf's "
              "largest entry")
        assert worst <= OPT_RTOL, (step, worst)


@pytest.mark.parametrize("schedule,warmup", [
    ("cosine", 5), ("cosine", 0), ("wsd", 10), ("wsd", 0), ("constant", 3)])
def test_schedule_matches_reference(schedule, warmup):
    cfg = dict(lr=3e-4, schedule=schedule, warmup_steps=warmup,
               total_steps=100, stable_fraction=0.7, min_lr_ratio=0.1)
    jf = jopt.schedule_fn(jopt.OptimizerConfig(**cfg))
    tf = topt.schedule_fn(topt.OptimizerConfig(**cfg))
    steps = list(range(0, 120, 3)) + [99, 100, 101]
    got = np.array([float(tf(torch.tensor(s, dtype=torch.int32)))
                    for s in steps])
    want = np.array([float(jf(jnp.int32(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=OPT_RTOL, atol=0)


def test_int8_compression_is_the_reference_bit_for_bit():
    rng = np.random.default_rng(3)
    cases = [(rng.standard_normal((7, 33)) * 1e-3,
              rng.standard_normal((7, 33)) * 1e-5),
             (rng.standard_normal(64) * 50.0, np.zeros(64)),
             (np.zeros((4, 4)), np.zeros((4, 4)))]
    for g, r in cases:
        g, r = g.astype(np.float32), r.astype(np.float32)
        jd, jr = jstep._compress_int8(jnp.asarray(g), jnp.asarray(r))
        td, tr = tstep._compress_int8(torch.from_numpy(g),
                                      torch.from_numpy(r))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def _captured_grads(monkeypatch, tmodel, jstate, cfg, tokens):
    """One port step's loss and the grads it hands the optimizer."""
    seen = {}

    def capture(opt_cfg, grads, state, step):
        seen.update((path_str(p), g.double().numpy())
                    for p, g in tree_leaves_with_path(grads))
        return state, {}
    monkeypatch.setattr(tstep, "optimizer_update", capture)
    state = train_state_from_numpy(_np_tree(jstate), device="cpu")
    _, metrics = tstep.make_train_step(tmodel, cfg)(
        state, {"tokens": torch.from_numpy(tokens)})
    return float(metrics["loss"]), seen


@pytest.mark.parametrize("accum_dtype", ["float32", "bfloat16"])
def test_accumulation_matches_one_microbatch(gemma, monkeypatch,
                                             accum_dtype):
    _, tmodel, _, jstate = gemma
    tokens = _tokens()["tokens"]
    out = {}
    for accum in (1, 2):
        cfg = tstep.TrainConfig(accum_steps=accum, remat="none",
                                accum_dtype=accum_dtype)
        out[accum] = _captured_grads(monkeypatch, tmodel, jstate, cfg,
                                     tokens)
    (l1, g1), (l2, g2) = out[1], out[2]
    assert abs(l2 - l1) <= ACCUM_LOSS_RTOL * abs(l1)
    worst = max(_rel_l2(g2[p], g1[p]) for p in g1)
    print(f"accum {accum_dtype}: loss {l1:.7f} / {l2:.7f}, largest grad "
          f"relative L2 {worst:.3e}")
    assert worst <= ACCUM_GRAD_RTOL


@pytest.mark.parametrize("name,accum,compression", [
    ("adamw", 2, "none"), ("adafactor", 1, "int8")])
def test_loss_trajectory_follows_reference(name, accum, compression):
    """Five whole steps on both sides from one bridged state, batch i of
    the pipeline at step i; remat "full"."""
    jmodel = build_model(jax_reduced_config("gemma-2b"))
    tmodel = Model(get_reduced_config("gemma-2b"))
    ocfg = dict(name=name, lr=1e-2, warmup_steps=1, total_steps=5,
                schedule="wsd")
    jtc = jstep.TrainConfig(optimizer=jopt.OptimizerConfig(**ocfg),
                            accum_steps=accum, grad_compression=compression)
    ttc = tstep.TrainConfig(optimizer=topt.OptimizerConfig(**ocfg),
                            accum_steps=accum, grad_compression=compression)
    jstate = jstep.init_train_state(jmodel, jax.random.PRNGKey(4), jtc)
    state = train_state_from_numpy(_np_tree(jstate), device="cpu")
    batches = [_tokens(i) for i in range(5)]
    jbatch = {"tokens": jnp.asarray(batches[0]["tokens"])}
    jfn = _compiled(jstep.make_train_step(jmodel, jtc), jstate, jbatch)
    tfn = tstep.make_train_step(tmodel, ttc)
    got, want = [], []
    for b in batches:
        jstate, jm = jfn(jstate, {"tokens": jnp.asarray(b["tokens"])})
        state, tm = tfn(state, {"tokens": torch.from_numpy(b["tokens"])})
        want.append(float(jm["loss"]))
        got.append(float(tm["loss"]))
    print(f"{name}: port {got}, reference {want}")
    np.testing.assert_allclose(got, want, rtol=TRAJECTORY_RTOL)
    assert got[-1] < got[0]
    assert int(state["step"]) == 5
    if compression == "int8":
        assert sum(float(t.abs().sum()) for _, t in
                   tree_leaves_with_path(state["ef"])) > 0


@pytest.mark.parametrize("remat,b1,b2", [
    ("none", 2 * (9 + 18), 2 * 3),
    ("full", 2 * (9 + 9 + 18), 2 * (3 + 3)),
    ("dots", 2 * (9 + 18), 2 * (3 + 3))])
def test_kernel_calls_per_step(gemma, monkeypatch, remat, b1, b2):
    """What one accum-2 step over three layers calls where the card
    launches: B1 three GEMMs a layer forward, each recomputed under
    "full" (saved under "dots"), two products each backward; B2 once a
    layer forward and again under remat (its backward is the plain
    version's gradient, not counted)."""
    _, tmodel, _, jstate = gemma
    calls = {"b1": 0, "b2": 0}

    def counted(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call
    monkeypatch.setattr(bm, "_launch", counted("b1", bm._launch))
    monkeypatch.setattr(fa, "_launch", counted("b2", fa._launch))
    state = train_state_from_numpy(_np_tree(jstate), device="cpu")
    cfg = tstep.TrainConfig(accum_steps=2, remat=remat)
    tstep.make_train_step(tmodel, cfg)(
        state, {"tokens": torch.from_numpy(_tokens()["tokens"])})
    assert calls == {"b1": b1, "b2": b2}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_starcoder2_loss_decreases(name):
    """The reference's ``test_loss_decreases`` on the port."""
    cfg = get_reduced_config("starcoder2-3b")
    model = Model(cfg)
    tc = tstep.TrainConfig(optimizer=topt.OptimizerConfig(
        name=name, lr=3e-3, warmup_steps=2, total_steps=12))
    state = tstep.init_train_state(model, torch.Generator().manual_seed(0),
                                   tc, "cpu")
    step = tstep.make_train_step(model, tc)
    batch = torch_sample_inputs(
        cfg, ShapeConfig("smoke", seq_len=SEQ, global_batch=BATCH,
                         mode="train"), device="cpu")
    losses = []
    for _ in range(12):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses


@pytest.mark.parametrize("batch,seq", [(4, 8), (4, 16)])
def test_deepseek_loss_with_aux_matches_reference(monkeypatch, batch, seq):
    """Reduced deepseek-v2-lite-16b (a dense first layer, then capacity
    MoE layers) on the reference's own initial weights: the loss, its
    cross-entropy and the summed load-balance term within LOSS_RTOL.  At
    4 x 16 XLA's CPU products round an MLA product one bf16 ulp apart
    from the port's (the MoE-free clone's logits part there too), and a
    router whose k-th and (k+1)-th probabilities sit within ROUTER_TIE
    then picks another expert: there, as in
    ``test_torch_frontends.test_forward_matches_reference``, the loss is
    held to MOE_TIE_RTOL and the tie must have been seen."""
    jcfg = jax_reduced_config("deepseek-v2-lite-16b")
    jmodel = build_model(jcfg)
    tmodel = Model(get_reduced_config("deepseek-v2-lite-16b"))
    params = jmodel.init(jax.random.PRNGKey(0))
    batch = make_sample_inputs(jcfg, JaxShapeConfig(
        "smoke", seq_len=seq, global_batch=batch, mode="train"))
    jloss, jparts = _compiled(lambda p, b: jmodel.loss(p, b), params,
                              batch)(params, batch)
    gaps = []
    real = moe_mod.route_tokens

    def recording(p, xg, moe):
        out = real(p, xg, moe)
        top = out[0].sort(dim=-1, descending=True).values
        gaps.append(float((top[..., moe.top_k - 1]
                           - top[..., moe.top_k]).min()))
        return out
    monkeypatch.setattr(moe_mod, "route_tokens", recording)
    tparams = params_from_numpy(_np_tree(params), device="cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, parts = tmodel.loss(tparams, tbatch)
    assert float(parts["aux"]) > 0
    rtol = LOSS_RTOL if seq == 8 else MOE_TIE_RTOL
    if seq != 8:
        assert min(gaps) < ROUTER_TIE, gaps
    for got, want in ((loss, jloss), (parts["ce"], jparts["ce"]),
                      (parts["aux"], jparts["aux"])):
        assert abs(float(got) - float(want)) <= rtol * abs(float(want)), \
            (float(got), float(want))


@pytest.mark.parametrize("source", ["synthetic", "file", "shards"])
def test_pipeline_batches_equal_reference(tmp_path, source):
    base = dict(vocab_size=1000, seq_len=8, global_batch=8, seed=3)
    cases = [{}]
    if source == "file":
        path = tmp_path / "tokens.bin"
        np.random.default_rng(0).integers(0, 65535, 517).astype(
            np.uint16).tofile(path)
        cases = [dict(source="file", path=str(path), dtype="uint16")]
    elif source == "shards":
        cases = [dict(num_shards=2, shard_index=i) for i in range(2)]
    for extra in cases:
        ref = JaxTokenPipeline(JaxDataConfig(**base, **extra))
        port = TokenPipeline(DataConfig(**base, **extra))
        for step in (0, 1, 5):
            want, got = ref.batch(step)["tokens"], port.batch(step)["tokens"]
            assert got.dtype == np.int32 == want.dtype
            np.testing.assert_array_equal(got, want)
        it = iter(port)
        np.testing.assert_array_equal(next(it)["tokens"],
                                      ref.batch(0)["tokens"])


def test_launch_train_main_on_the_cpu(capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", "gemma-2b", "--reduced", "--steps", "4",
                      "--global-batch", "4", "--seq-len", "16",
                      "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[train] gemma-2b-reduced: loss ")
    assert line.endswith(" on cpu")
    first, last = out["losses"][0][1], out["losses"][-1][1]
    assert last < first
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--arch", "gemma-2b", "--reduced", "--steps", "1"])


def _same_grads(fn_a, fn_b, inputs):
    """Outputs and grads of two functions of the same leaves, bit for
    bit."""
    a = [t.detach().clone().requires_grad_(t.requires_grad) for t in inputs]
    b = [t.detach().clone().requires_grad_(t.requires_grad) for t in inputs]
    out_a, out_b = fn_a(*a), fn_b(*b)
    assert out_a.grad_fn is not None
    assert torch.equal(out_a, out_b)
    dy = torch.randn(out_a.shape, generator=torch.Generator().manual_seed(1))
    out_a.backward(dy.to(out_a.dtype))
    out_b.backward(dy.to(out_b.dtype))
    for x, y in zip(a, b):
        if x.requires_grad:
            assert torch.equal(x.grad, y.grad)


@pytest.mark.parametrize("needs", [(True, True), (True, False),
                                   (False, True)])
def test_block_matmul_autograd_equals_plain(needs):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(37, 96, generator=g).bfloat16().requires_grad_(needs[0])
    w = (torch.randn(96, 130, generator=g) * 0.1).bfloat16() \
        .requires_grad_(needs[1])
    _same_grads(bm.block_matmul_2d, bm.matmul_plain, [x, w])
    with torch.no_grad():
        assert bm.block_matmul_2d(x, w).grad_fn is None


@pytest.mark.parametrize("kv_heads,window,softcap,offset", [
    (1, None, None, 0), (2, 5, None, 3), (1, None, 30.0, "rows")])
def test_flash_attention_autograd_equals_plain(kv_heads, window, softcap,
                                               offset):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 6, 4, 32, generator=g).bfloat16().requires_grad_()
    k = torch.randn(2, 9, kv_heads, 32, generator=g).bfloat16() \
        .requires_grad_()
    v = torch.randn(2, 9, kv_heads, 32, generator=g).bfloat16() \
        .requires_grad_()
    off = torch.tensor([0, 3]) if offset == "rows" else offset
    kw = dict(offset=off, kv_valid_len=torch.tensor([9, 7]), window=window,
              softcap=softcap)
    _same_grads(functools.partial(fa.flash_attention, **kw),
                functools.partial(fa.attention_plain, **kw), [q, k, v])
    with torch.no_grad():
        assert fa.flash_attention(q, k, v, **kw).grad_fn is None
    # a gradient for the keys and values only
    _same_grads(functools.partial(fa.flash_attention, **kw),
                functools.partial(fa.attention_plain, **kw),
                [q.detach(), k, v])


@pytest.mark.parametrize("chunk,init,outputs", [
    (4, True, "both"), (4, False, "y"), (16, True, "state")])
def test_ssd_scan_autograd_equals_plain(chunk, init, outputs):
    """B4's autograd path (the kernel forward, the plain version's
    gradient recomputed) against autograd of the plain version: L 11 is
    no multiple of the chunk (the last chunk cut short), B and C come in
    G 2 groups over H 4 heads, the carried state given or not, and the
    gradient taken of y, of the final state or of both."""
    g = torch.Generator().manual_seed(2)
    bsz, l, h, p, groups, n = 2, 11, 4, 8, 2, 16
    x = torch.randn(bsz, l, h, p, generator=g).bfloat16()
    dt = torch.rand(bsz, l, h, generator=g) * 0.5
    a = -torch.rand(h, generator=g) - 0.1
    b = torch.randn(bsz, l, groups, n, generator=g).bfloat16()
    c = torch.randn(bsz, l, groups, n, generator=g).bfloat16()
    h0 = torch.randn(bsz, h, p, n, generator=g)
    ins = [x, dt, a, b, c] + ([h0] if init else [])
    dy = torch.randn(x.shape, generator=g).bfloat16()
    ds = torch.randn(bsz, h, p, n, generator=g)
    grads = []
    for fn in (ssd.ssd_scan, ssd.ssd_scan_plain):
        leaves = [t.clone().requires_grad_() for t in ins]
        y, state = fn(*leaves[:5], chunk_size=chunk,
                      initial_state=leaves[5] if init else None)
        assert (type(y.grad_fn).__name__ == "SsdScanGradBackward") == \
            (fn is ssd.ssd_scan)
        grads.append((y.detach(), state.detach()))
        outs = {"both": ([y, state], [dy, ds]), "y": ([y], [dy]),
                "state": ([state], [ds])}[outputs]
        torch.autograd.backward(*outs)
        grads.append([t.grad for t in leaves])
    (y_k, s_k), g_k, (y_p, s_p), g_p = grads
    assert torch.equal(y_k, y_p) and torch.equal(s_k, s_p)
    # the final state reads no C: C's gradient is None on both sides then
    assert [t is None for t in g_k] == [t is None for t in g_p] == \
        [outputs == "state" and i == 4 for i in range(len(ins))]
    for got, want in zip(g_k, g_p):
        assert got is None or torch.equal(got, want)
    with torch.no_grad():
        y, _ = ssd.ssd_scan(*ins[:5], chunk_size=chunk)
        assert y.grad_fn is None


def test_mamba2_loss_and_grads_match_reference():
    """Reduced mamba2-780m (its chunked scans through ``ssd_scan``'s
    autograd path) from one bridged train state: the loss within
    LOSS_RTOL of the reference's ``Model.loss`` (which scans through its
    plain ``ssd_reference``), every leaf's gradient within GRAD_RTOL
    relative L2 of ``jax.value_and_grad``'s, remat "full"."""
    jmodel = build_model(jax_reduced_config("mamba2-780m"))
    tmodel = Model(get_reduced_config("mamba2-780m"))
    tc = jstep.TrainConfig(optimizer=jopt.OptimizerConfig(
        lr=1e-2, warmup_steps=0, total_steps=8))
    jstate = jstep.init_train_state(jmodel, jax.random.PRNGKey(5), tc)
    tokens = _tokens(vocab=jmodel.cfg.vocab_size)["tokens"]
    specs = jmodel.param_specs()
    master = jstate["opt"]["master"]

    def loss(m, b):
        return jmodel.loss(jstep.cast_params(m, specs), b, remat="full")[0]
    batch = {"tokens": jnp.asarray(tokens)}
    jloss, jgrads = _compiled(jax.value_and_grad(loss), master, batch)(
        master, batch)
    calls = collections.Counter()
    real = ssd._launch

    def counted(*args):
        calls["b4"] += 1
        return real(*args)
    ssd._launch = counted
    try:
        state = train_state_from_numpy(_np_tree(jstate), device="cpu")
        got, grads = _port_grads(tmodel, state, tokens, "full")
    finally:
        ssd._launch = real
    # each layer's scan once forward and once more under remat; the
    # backward recomputes the plain version and launches nothing
    assert calls["b4"] == 2 * tmodel.cfg.num_layers
    assert abs(got - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    jgrads = _flat(jgrads)
    assert set(grads) == set(jgrads)
    worst = max((_rel_l2(grads[p], jgrads[p]), p) for p in grads)
    print(f"mamba2: loss {got:.7f} vs {float(jloss):.7f}; largest grad "
          f"relative L2 {worst[0]:.3e} ({worst[1]})")
    assert worst[0] <= GRAD_RTOL, worst
    assert all(np.any(g != 0) for g in grads.values())


def test_remat_rejects_unknown_modes_and_caches():
    model = Model(dataclasses.replace(get_reduced_config("gemma-2b"),
                                      num_layers=1))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
    with pytest.raises(ValueError, match="remat"):
        model.loss(params, tokens, remat="everything")
    with pytest.raises(ValueError, match="cache"):
        model._run_blocks(params, torch.zeros((1, 4, 128)),
                          positions=torch.zeros((1, 4), dtype=torch.int64),
                          cache=model.init_cache(1, 8, "cpu"), t=0,
                          remat="full")
