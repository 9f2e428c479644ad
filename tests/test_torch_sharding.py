"""The port's mesh layer against the JAX package's, on the CPU.

``repro_torch.dist.sharding`` derives the reference's PartitionSpecs
entry for entry for every param, cache, input and train-state leaf of
all ten configs (every shape; train and serve rules, sequence parallel
on and off; fake 16 x 16 and 2 x 16 x 16 meshes: objects whose
``.shape`` maps axis names to sizes, as ``tests/test_sharding.py``
uses), and the same per-device bytes; ``dist.state_sharding`` gives the
reference's optimizer-state specs path for path; ``hint`` returns its
argument itself outside ``use_rules`` and, inside one over a 1 x 1 gloo
mesh, redistributes a DTensor to the placements of the spec the
reference's ``hint`` constrains to on an ``Auto``-axis JAX mesh; a
reduced gemma-2b decode step on DTensors under the rules gives the plain
step's logits bit for bit; the tied embedding's gradient on DTensors
equals the plain one, on its own placements (one and two ranks);
``map_axes``, ``Model.abstract`` and
``abstract_train_state`` give the reference's trees' shapes and dtypes;
the modules export the reference's names; and importing the port
initialises no process group.
"""
import importlib
import inspect
import os
import pathlib
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AxisType  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor  # noqa: E402

import repro.dist  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.dist import sharding as ref_shd  # noqa: E402
from repro.dist import state_sharding as ref_state  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models.frontends import input_specs as ref_input_specs  # noqa: E402
from repro.models.params import ParamSpec as RefParamSpec  # noqa: E402
from repro.models.params import map_axes as ref_map_axes  # noqa: E402
from repro.training.optimizer import OptimizerConfig as RefOptConfig  # noqa: E402
from repro.training.train_step import TrainConfig as RefTrainConfig  # noqa: E402
from repro.training.train_step import \
    abstract_train_state as ref_abstract_train_state  # noqa: E402
import repro_torch.dist  # noqa: E402
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.dist import state_sharding  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, \
    make_production_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.frontends import input_specs  # noqa: E402
from repro_torch.models.params import map_axes, path_str, \
    tree_leaves_with_path, tree_map_with_path  # noqa: E402
from repro_torch.training.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.training.train_step import TrainConfig, \
    abstract_train_state  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: the test
    runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """A mesh-shape lookup with no devices (``tests/test_sharding.py``)."""

    def __init__(self, **shape):
        self.shape = dict(shape)


MESHES = {"16x16": FakeMesh(data=16, model=16),
          "2x16x16": FakeMesh(pod=2, data=16, model=16)}


def _ref_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefParamSpec))
    return {"/".join(k.key for k in p): leaf for p, leaf in flat}


def _port_leaves(tree) -> dict:
    return {path_str(p): leaf for p, leaf in tree_leaves_with_path(tree)}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return jnp.dtype(dtype).name


def _spec_trees(arch: str, shape_name: str, mode: str):
    """-> [(name, port ParamSpec tree, reference tree, table)] of one
    (arch, shape) cell under one mode: params, inputs, cache (serving
    shapes) and the train state under both optimizers."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    shape, rshape = SHAPES[shape_name], REF_SHAPES[shape_name]
    model, rmodel = build_model(cfg), ref_build_model(rcfg)
    out = [("params", model.param_specs(), rmodel.param_specs(), "params"),
           ("inputs", input_specs(cfg, shape), ref_input_specs(rcfg, rshape),
            "acts")]
    if shape.mode != "train":
        out.append(("cache", model.cache_specs(shape.global_batch,
                                               shape.seq_len),
                    rmodel.cache_specs(rshape.global_batch, rshape.seq_len),
                    "acts"))
    elif mode == "train":
        for opt in ("adamw", "adafactor"):
            out.append((f"state/{opt}", state_sharding.train_state_specs(
                OptimizerConfig(name=opt), model.param_specs()),
                ref_state.train_state_specs(RefOptConfig(name=opt),
                                            rmodel.param_specs()),
                "params"))
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_and_device_bytes_equal_the_reference(arch):
    checked = 0
    for shape_name in SHAPES:
        for mode in ("train", "serve"):
            trees = _spec_trees(arch, shape_name, mode)
            for sp in (False, True):
                rules = shd.make_rules(mode, seq_parallel=sp)
                rrules = ref_shd.make_rules(mode, seq_parallel=sp)
                assert (rules.params, rules.acts) == \
                    (rrules.params, rrules.acts)
                for mesh_name, mesh in MESHES.items():
                    for name, tree, rtree, table in trees:
                        port, ref = _port_leaves(tree), _ref_leaves(rtree)
                        assert port.keys() == ref.keys(), (arch, name)
                        for path, s in port.items():
                            r = ref[path]
                            assert (s.shape, s.axes) == (r.shape, r.axes)
                            got = shd.pspec_for(s.shape, s.axes,
                                                getattr(rules, table), mesh)
                            want = ref_shd.pspec_for(
                                r.shape, r.axes, getattr(rrules, table), mesh)
                            assert tuple(got) == tuple(want), \
                                (arch, shape_name, mode, sp, mesh_name, path)
                            checked += 1
                        pspecs = tree_map_with_path(
                            lambda _, s: shd.pspec_for(
                                s.shape, s.axes, getattr(rules, table),
                                mesh), tree)
                        rpspecs = jax.tree_util.tree_map(
                            lambda r: ref_shd.pspec_for(
                                r.shape, r.axes, getattr(rrules, table),
                                mesh), rtree,
                            is_leaf=lambda x: isinstance(x, RefParamSpec))
                        assert shd.device_bytes(pspecs, tree, mesh) == \
                            ref_shd.device_bytes(rpspecs, rtree, mesh), \
                            (arch, shape_name, name, mesh_name)
    assert checked > 500


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_pspecs_follow_the_reference(arch):
    specs = build_model(get_config(arch)).param_specs()
    rspecs = ref_build_model(ref_get_config(arch)).param_specs()
    for mode in ("train", "serve"):
        for mesh in MESHES.values():
            got = _port_leaves(shd.param_pspecs(specs, shd.make_rules(mode),
                                                mesh))
            flat, _ = jax.tree_util.tree_flatten_with_path(
                ref_shd.param_pspecs(rspecs, ref_shd.make_rules(mode), mesh),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            want = {"/".join(k.key for k in p): tuple(ps) for p, ps in flat}
            assert {p: tuple(ps) for p, ps in got.items()} == want


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_state_specs_match_the_reference_path_for_path(opt):
    for arch in ARCH_NAMES:
        specs = build_model(get_config(arch)).param_specs()
        rspecs = ref_build_model(ref_get_config(arch)).param_specs()
        for fn, rfn in ((state_sharding.opt_state_specs,
                         ref_state.opt_state_specs),
                        (state_sharding.train_state_specs,
                         ref_state.train_state_specs)):
            port = _port_leaves(fn(OptimizerConfig(name=opt), specs))
            ref = _ref_leaves(rfn(RefOptConfig(name=opt), rspecs))
            assert port.keys() == ref.keys()
            for path, s in port.items():
                r = ref[path]
                assert (s.shape, s.axes, _dtype_name(s.dtype), s.init) == \
                    (r.shape, r.axes, _dtype_name(r.dtype), r.init), path


def test_pspec_rules_of_the_reference_tests():
    """``tests/test_sharding.py``'s cases, on the port."""
    mesh = FakeMesh(data=16, model=16)
    rules = shd.make_rules("train").params
    assert shd.pspec_for((1024, 8, 128), ("embed", "kv_heads", "head_dim"),
                         rules, mesh) == shd.P("data")
    assert shd.pspec_for((1024, 128, 128), ("embed", "heads", "head_dim"),
                         rules, mesh) == shd.P(("data",), "model")
    spec = shd.pspec_for((64, 64), ("a", "b"), {"a": "model", "b": "model"},
                         mesh)
    assert [e for e in spec if e is not None] == ["model"]
    pod = FakeMesh(pod=2, data=16, model=16)
    assert shd.pspec_for((256, 128), ("batch", None),
                         {"batch": ("pod", "data")}, pod) == \
        shd.P(("pod", "data"))
    assert shd.pspec_for((2, 128), ("batch", None),
                         {"batch": ("pod", "data")}, pod) == shd.P(("pod",))
    specs = {"w": state_sharding.ParamSpec((1024, 256), torch.bfloat16,
                                           ("embed", "mlp"))}
    pspecs = shd.param_pspecs(specs, shd.make_rules("train"), mesh)
    assert shd.device_bytes(pspecs, specs, mesh) == 1024 * 256 * 2 // 256


def test_placements_shard_each_named_mesh_dim():
    mesh = FakeMesh(pod=2, data=16, model=16)
    assert shd.shardings_of({"a": shd.P(("pod", "data"), None, "model"),
                             "b": shd.P()}, mesh) == {
        "a": (Shard(0), Shard(0), Shard(2)),
        "b": (Replicate(), Replicate(), Replicate())}
    with pytest.raises(ValueError, match="major-first"):
        shd.shardings_of(shd.P(("data", "pod")), mesh)


@pytest.fixture(scope="module")
def gloo():
    """A gloo process group of one rank (an in-memory store) and the 1 x 1
    debug mesh on the CPU; torn down after the module."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_debug_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_debug_and_production_meshes(gloo):
    assert gloo.mesh_dim_names == ("data", "model")
    assert tuple(gloo.shape) == (1, 1)
    assert shd.mesh_axis_sizes(gloo) == {"data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        make_production_mesh(multi_pod=True)


def test_hint_is_the_identity_outside_use_rules(gloo):
    x = torch.ones(4, 4)
    assert shd.hint(x, ("batch", None)) is x
    d = distribute_tensor(x, gloo, [Replicate(), Replicate()])
    assert shd.hint(d, ("batch", None)) is d
    with shd.use_rules(gloo, shd.make_rules("train")):
        assert shd.hint(x, ("batch", None)) is x    # a plain tensor


def test_hint_redistributes_to_the_reference_spec(gloo):
    rules, rrules = shd.make_rules("train"), ref_shd.make_rules("train")
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)

    @jax.jit
    def f(x):
        with ref_shd.use_rules(jmesh, rrules):
            return ref_shd.hint(x, ("batch", "embed")) * 2
    x = np.arange(32, dtype=np.float32).reshape(4, 8)
    assert f(jnp.asarray(x)).shape == (4, 8)
    assert "sharding" in f.lower(jnp.asarray(x)).as_text()
    for axes in (("batch", "embed"), ("batch", "seq", "vocab"),
                 ("expert", "groups", None, "embed")):
        shape = (4, 8, 16, 2)[:len(axes)]
        want = ref_shd.pspec_for(shape, axes, rrules.acts, jmesh)
        d = distribute_tensor(torch.zeros(shape), gloo,
                              [Replicate(), Replicate()])
        with shd.use_rules(gloo, rules):
            got = shd.hint(d, axes)
        assert isinstance(got, DTensor)
        assert tuple(got.placements) == shd.spec_placements(
            shd.P(*tuple(want)), gloo)
    assert tuple(got.placements) == (Shard(1), Shard(0))


def test_adafactor_step_on_sharded_leaves_equals_the_plain_step(gloo):
    """Adafactor over DTensor leaves of the 1 x 1 mesh (a factored matrix
    sharded on both mesh dims, its gradient a partial sum over "data"; a
    vector and a small matrix with full statistics), the weight decay
    added out of place as the reference adds it: two steps give the
    plain tensors' masters and statistics bit for bit."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.training import optimizer as topt

    g = torch.Generator().manual_seed(0)
    shapes = {"w": (8, 16), "b": (16,), "v": (3, 4)}
    place = {"w": [Shard(0), Shard(1)], "b": [Replicate(), Shard(0)],
             "v": [Shard(0), Replicate()]}
    params = {k: torch.randn(sh, generator=g) for k, sh in shapes.items()}
    grads = [{k: torch.randn(sh, generator=g) for k, sh in shapes.items()}
             for _ in range(2)]
    cfg = OptimizerConfig(name="adafactor", lr=3e-3, warmup_steps=0,
                          total_steps=10, weight_decay=0.1)
    plain = topt.init_opt_state(cfg, {k: t.clone()
                                      for k, t in params.items()})
    sharded = topt.init_opt_state(cfg, {k: t.clone()
                                        for k, t in params.items()})
    sharded["master"] = {k: distribute_tensor(t.clone(), gloo, place[k])
                         for k, t in params.items()}
    sharded["stats"] = {k: {n: distribute_tensor(t, gloo, [Replicate()] * 2)
                            for n, t in st.items()}
                        for k, st in sharded["stats"].items()}
    grad_place = dict(place, w=[Partial(), Shard(1)])
    with torch.no_grad(), implicit_replication():
        for step, gr in enumerate(grads):
            plain, _ = topt.apply_updates(
                cfg, {k: t.clone() for k, t in gr.items()}, plain,
                torch.tensor(step, dtype=torch.int32))
            sharded, _ = topt.apply_updates(
                cfg, {k: DTensor.from_local(t.clone(), gloo, grad_place[k],
                                            run_check=False)
                      for k, t in gr.items()}, sharded,
                distribute_tensor(torch.tensor(step, dtype=torch.int32),
                                  gloo, [Replicate()] * 2))
    for k in shapes:
        got = sharded["master"][k]
        assert isinstance(got, DTensor) and \
            tuple(got.placements) == tuple(place[k])
        assert torch.equal(got.full_tensor(), plain["master"][k])
        for n, t in plain["stats"][k].items():
            assert torch.equal(sharded["stats"][k][n].full_tensor(), t)


def test_ring_write_on_a_sharded_cache_equals_the_indexed_write(gloo):
    """The hybrid's ring write (``rglru._ring_write``): on a DTensor cache
    sharded over the batch (the dry-run's decode cells) it writes, as a
    masked copy, what the indexed write puts in a plain tensor (under
    ``implicit_replication``, as the dry-run traces)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import rglru
    g = torch.Generator().manual_seed(3)
    bidx, slot = torch.arange(4), torch.tensor([0, 5, 2, 7])
    for shape, dtype in (((4, 8, 2, 16), torch.bfloat16),
                         ((4, 8), torch.int32)):
        if dtype.is_floating_point:
            leaf = torch.randn(shape, generator=g).to(dtype)
            new = torch.randn((4,) + shape[2:], generator=g).to(dtype)
        else:
            leaf = torch.randint(-1, 100, shape, generator=g, dtype=dtype)
            new = torch.randint(0, 100, (4,), generator=g, dtype=dtype)
        want = leaf.clone()
        rglru._ring_write(want, bidx, slot, new)
        placed = [Shard(0), Replicate()]
        sharded = distribute_tensor(leaf.clone(), gloo, placed)
        with implicit_replication():
            rglru._ring_write(sharded, bidx, slot,
                              distribute_tensor(new, gloo, placed))
        assert tuple(sharded.placements) == tuple(placed)
        assert torch.equal(sharded.full_tensor(), want)
        assert not torch.equal(want, leaf)


# The decode step runs in a child process: ``register_dtensor_rules``
# changes DTensor's rules for the rest of the process it runs in.
DECODE_ON_DTENSORS = """
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, \\
    distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_reduced_config
from repro_torch.dist import sharding as shd
from repro_torch.launch.dryrun import register_dtensor_rules
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import build_model
from repro_torch.models.params import tree_leaves_with_path, \\
    tree_map_with_path

torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                        world_size=1)
try:
    mesh = make_debug_mesh(device="cpu")
    register_dtensor_rules()
    cfg = get_reduced_config("gemma-2b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rules = shd.make_rules("serve")
    placed = shd.shardings_of(
        shd.param_pspecs(model.param_specs(), rules, mesh), mesh)
    dparams = tree_map_with_path(
        lambda _, t, pl: distribute_tensor(t, mesh, list(pl)), params,
        placed)
    cache = model.init_cache(2, 16, "cpu")
    cplaced = tree_map_with_path(
        lambda _, s: shd.spec_placements(
            shd.pspec_for(s.shape, s.axes, rules.acts, mesh), mesh),
        model.cache_specs(2, 16))
    dcache = tree_map_with_path(
        lambda _, t, pl: distribute_tensor(t.clone(), mesh, list(pl)),
        cache, cplaced)
    tokens = torch.tensor([3, 7], dtype=torch.int32)
    with torch.no_grad():
        want, _ = model.decode_step(params, {"tokens": tokens}, cache, 5)
        with shd.use_rules(mesh, rules), implicit_replication():
            got, _ = model.decode_step(
                dparams, {"tokens": distribute_tensor(
                    tokens, mesh, [Shard(0), Replicate()])}, dcache, 5)
    assert isinstance(got, DTensor)
    assert torch.equal(got.full_tensor(), want)
    for (_, a), (_, b) in zip(tree_leaves_with_path(cache),
                              tree_leaves_with_path(dcache)):
        assert torch.equal(a, b.full_tensor())
finally:
    dist.destroy_process_group()
print("DECODE_ON_DTENSORS_OK")
"""


def test_decode_on_dtensors_equals_the_plain_step():
    """Reduced gemma-2b: params and cache as DTensors placed by the serve
    rules on the 1 x 1 mesh, a decode step under ``use_rules`` (every
    hint redistributes) gives the plain step's logits and cache bit for
    bit, under the dry-run's DTensor rules (a view may redistribute, as
    a reshape may)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, "-c", DECODE_ON_DTENSORS],
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
        capture_output=True, text=True, timeout=240, cwd=root)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "DECODE_ON_DTENSORS_OK" in res.stdout


# One rank of a gloo world of ``world`` ranks (a file store), the mesh
# ``world`` x 1 on the CPU; run as ``python -c SCRIPT rank world store``.
TIED_EMBEDDING_GRAD = """
import sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_reduced_config
from repro_torch.dist import sharding as shd
from repro_torch.dist.placement import grad_in_place_of
from repro_torch.launch.dryrun import register_dtensor_rules
from repro_torch.models import build_model, layers
from repro_torch.models.params import tree_leaves_with_path, \\
    tree_map_with_path
from repro_torch.training.train_step import cast_to_specs

rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
try:
    mesh = init_device_mesh("cpu", (world, 1),
                            mesh_dim_names=("data", "model"))
    register_dtensor_rules()
    cfg = get_reduced_config("gemma-2b")
    assert cfg.tie_embeddings
    rules = shd.make_rules("train")
    model = build_model(cfg)
    specs = model.param_specs()
    placed = shd.shardings_of(shd.param_pspecs(specs, rules, mesh), mesh)
    tokens = torch.randint(0, cfg.vocab_size, (2 * world, 16),
                           generator=torch.Generator().manual_seed(1))
    dtokens = distribute_tensor(tokens, mesh, [Shard(0), Replicate()])
    plain = torch.ones(3, requires_grad=True)
    assert grad_in_place_of(plain) is plain
    master = tree_map_with_path(
        lambda _, t: t.float().requires_grad_(True),
        model.init(torch.Generator().manual_seed(0), "cpu"))
    dmaster = tree_map_with_path(
        lambda _, t, pl: distribute_tensor(t.detach().clone(), mesh,
                                           list(pl)).requires_grad_(True),
        master, placed)
    emb, demb = master["embed"]["embedding"], dmaster["embed"]["embedding"]
    if world == 1:
        loss, _ = model.loss(cast_to_specs(master, specs),
                             {"tokens": tokens})
        loss.backward()
        with shd.use_rules(mesh, rules), implicit_replication():
            dloss, _ = model.loss(cast_to_specs(dmaster, specs),
                                  {"tokens": dtokens})
            dloss.backward()
        assert torch.equal(dloss.full_tensor(), loss)
        for (p, a), (_, b) in zip(tree_leaves_with_path(master),
                                  tree_leaves_with_path(dmaster)):
            assert torch.equal(b.grad.full_tensor(), a.grad), p
        # the lookup's own gradient lies elsewhere; through the alias it
        # reaches the parameter on the parameter's placements
        for hooked in (False, True):
            leaf = distribute_tensor(emb.detach().clone(), mesh,
                                     list(demb.placements))
            leaf.requires_grad_(True)
            with implicit_replication():
                src = grad_in_place_of(leaf) if hooked else leaf
                src[dtokens].sum().backward()
            assert (tuple(leaf.grad.placements)
                    == tuple(demb.placements)) == hooked
        assert tuple(demb.grad.placements) == tuple(demb.placements)
    else:
        # the embedding replicated and the batch split over "data": both
        # reads' gradients arrive as partial sums over the ranks, which
        # the alias must reduce
        def tied(p, tok):
            x = layers.embed(p, tok, cfg)
            return layers.unembed(p, x, cfg).square().mean()

        def replicated():
            leaf = distribute_tensor(emb.detach().clone(), mesh,
                                     [Replicate(), Replicate()])
            return leaf.requires_grad_(True)
        tied({"embedding": emb}, tokens).backward()
        rep, raw = replicated(), replicated()
        x = distribute_tensor(
            torch.randn(2 * world, 16, cfg.d_model,
                        generator=torch.Generator().manual_seed(2)),
            mesh, [Shard(0), Replicate()])
        with implicit_replication():
            tied({"embedding": rep}, dtokens).backward()
            torch.einsum("bsm,vm->bsv", x, raw).square().sum().backward()
        assert tuple(raw.grad.placements) != tuple(raw.placements)
        assert tuple(rep.grad.placements) == tuple(rep.placements)
        torch.testing.assert_close(rep.grad.full_tensor(), emb.grad,
                                   rtol=1e-5, atol=1e-9)
finally:
    dist.destroy_process_group()
print("TIED_EMBEDDING_GRAD_OK")
"""


@pytest.mark.parametrize("world", [1, 2])
def test_tied_embedding_grad_on_dtensors_equals_the_plain_grad(world,
                                                               tmp_path):
    """``dist.placement.grad_in_place_of`` on the tied embedding's two
    reads (``layers.embed`` and ``layers.unembed``), under the train rules
    and the dry-run's DTensor rules; the identity on a plain tensor.  One
    rank (the 1 x 1 mesh): reduced gemma-2b's loss on DTensor masters
    gives every leaf's gradient of the plain tensors bit for bit, the
    embedding's on the embedding's own placements, which the lookup's
    gradient alone does not lie on.  Two ranks (a 2 x 1 mesh, the batch
    split over "data", the embedding replicated, so each read's gradient
    is a partial sum over the ranks): the embedding's two reads alone, in
    fp32, give the plain gradient to fp32 rounding (rtol 1e-5), on the
    embedding's placements, where the unembedding's product alone leaves
    its gradient a partial sum."""
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", TIED_EMBEDDING_GRAD, str(rank), str(world),
         store], env=env, cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(world)]
    try:
        outs = [proc.communicate(timeout=240) for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err[-3000:]
        assert "TIED_EMBEDDING_GRAD_OK" in out


def test_map_axes_and_abstract_trees_follow_the_reference():
    for arch in ARCH_NAMES:
        model, rmodel = build_model(get_config(arch)), \
            ref_build_model(ref_get_config(arch))
        flat, _ = jax.tree_util.tree_flatten_with_path(
            ref_map_axes(rmodel.param_specs(), lambda axes: [axes]),
            is_leaf=lambda x: isinstance(x, list))
        assert _port_leaves(map_axes(model.param_specs(), lambda a: [a])) == \
            {"/".join(k.key for k in p): v for p, v in flat}
        got = _port_leaves(model.abstract())
        want = _ref_leaves(rmodel.abstract())
        assert got.keys() == want.keys()
        for path, t in got.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), _dtype_name(t.dtype)) == \
                (tuple(want[path].shape), _dtype_name(want[path].dtype))
    for opt in ("adamw", "adafactor"):
        model = build_model(get_config("gemma-2b"))
        rmodel = ref_build_model(ref_get_config("gemma-2b"))
        got = _port_leaves(abstract_train_state(
            model, TrainConfig(optimizer=OptimizerConfig(name=opt))))
        want = _ref_leaves(ref_abstract_train_state(
            rmodel, RefTrainConfig(optimizer=RefOptConfig(name=opt))))
        assert got.keys() == want.keys()
        for path, t in got.items():
            assert (tuple(t.shape), _dtype_name(t.dtype)) == \
                (tuple(want[path].shape), _dtype_name(want[path].dtype))


def _public_defs(module) -> set:
    return {n for n, v in vars(module).items() if not n.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == module.__name__}


@pytest.mark.parametrize("name", [
    "dist", "dist.sharding", "dist.state_sharding", "dist.fault_tolerance",
    "launch.mesh", "launch.hlo_stats", "launch.dryrun",
    "checkpoint.elastic", "checkpoint"])
def test_modules_export_the_reference_names(name):
    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    assert getattr(port, "__all__", None) == getattr(ref, "__all__", None)
    missing = {n for n in _public_defs(ref) if not hasattr(port, n)}
    assert not missing, missing
    if name == "dist":
        subs = {m.name for m in pkgutil.iter_modules(repro.dist.__path__)}
        # and ``placement``, the leaf of ``sharding`` (one tensor's spec
        # and ``hint``) that the kernels and the models import
        assert subs | {"placement"} == {
            m.name for m in pkgutil.iter_modules(repro_torch.dist.__path__)}


def test_importing_the_port_initialises_no_process_group():
    """Every port module imported: no process group, PyTorch's fake
    process group not imported; only ``launch/mesh.py`` names it."""
    root = pathlib.Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, sys\n"
        "import torch.distributed as dist\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'repro_torch.launch.dryrun' in sys.modules\n"
        "assert not dist.is_initialized()\n"
        "assert 'torch.testing._internal.distributed.fake_pg' not in "
        "sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=root, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    naming = sorted(str(p.relative_to(root)) for p in
                    (root / "src" / "repro_torch").rglob("*.py")
                    if "fake_pg" in p.read_text())
    assert naming == ["src/repro_torch/launch/mesh.py"]
