"""The port's elastic restore, fault tolerance and collective arithmetic
against the JAX package's, on the CPU.

``reshard_plan`` gives the reference's report (leaves, moved bytes at the
reference's two bytes an element, indivisible dims) on the reference
test's trees and on every config's train state, 16 x 16 to 2 x 16 x 16
and on to a mesh the specs cannot divide; ``elastic_restore`` onto a
1 x 1 gloo mesh gives back, bit for bit, the tree the reference's
``elastic_restore`` gives back (each package saving in its own format),
as DTensors with the specs' placements, each rank's shard cut from the
host leaf; seeded beat/sweep sequences and
straggler checks give the reference's answers; the collective events of
``tests/test_sharding.py``'s HLO sample give the reference's counts,
payloads and link bytes, and the recorder maps real functional
collectives (and a point-to-point send) to those names with their
groups' sizes.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.distributed._functional_collectives as funcol  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro.checkpoint import Checkpointer as RefCheckpointer  # noqa: E402
from repro.checkpoint import elastic_restore as ref_elastic_restore  # noqa: E402
from repro.checkpoint import reshard_plan as ref_reshard_plan  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.dist import sharding as ref_shd  # noqa: E402
from repro.dist import state_sharding as ref_state  # noqa: E402
from repro.dist.fault_tolerance import HeartbeatMonitor as RefMonitor  # noqa: E402
from repro.dist.fault_tolerance import StragglerPolicy as RefPolicy  # noqa: E402
from repro.launch import hlo_stats as ref_hlo  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models.params import ParamSpec as RefParamSpec  # noqa: E402
from repro.training.optimizer import OptimizerConfig as RefOptConfig  # noqa: E402
from repro_torch.checkpoint import Checkpointer, elastic_restore, \
    reshard_plan  # noqa: E402
from repro_torch.checkpoint.elastic import _local_shard  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.dist import state_sharding  # noqa: E402
from repro_torch.dist.fault_tolerance import HeartbeatMonitor, \
    StragglerPolicy  # noqa: E402
from repro_torch.launch import hlo_stats  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.params import tree_map_with_path  # noqa: E402
from repro_torch.training.optimizer import OptimizerConfig  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: the test
    runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


class FakeMesh:
    def __init__(self, **shape):
        self.shape = dict(shape)


def _same_report(got, want):
    assert (got.n_leaves, got.moved_bytes, got.incompatible) == \
        (want.n_leaves, want.moved_bytes, want.incompatible)


def test_reshard_plan_on_the_reference_test_trees():
    pspecs = {"w": shd.P(None, None), "scale": shd.P(None),
              "nested": {"step": shd.P()}}
    rpspecs = {"w": JP(None, None), "scale": JP(None),
               "nested": {"step": JP()}}
    shapes = {"w": (8, 16), "scale": (16,), "nested": {"step": ()}}
    a, b = FakeMesh(data=1, model=1), FakeMesh(data=1)
    _same_report(reshard_plan(pspecs, a, b, shapes),
                 ref_reshard_plan(rpspecs, a, b, shapes))
    pspecs = {"w": shd.P("data", "model"), "scale": shd.P("model")}
    rpspecs = {"w": JP("data", "model"), "scale": JP("model")}
    shapes = {"w": (8, 16), "scale": (12,)}
    a, b = FakeMesh(data=2, model=4), FakeMesh(data=4, model=8)
    got = reshard_plan(pspecs, a, b, shapes)
    _same_report(got, ref_reshard_plan(rpspecs, a, b, shapes))
    assert got.moved_bytes == (8 * 16 + 12) * 2 and got.incompatible == [
        "leaf0: dim 12 % 8 != 0"]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_reshard_plan_of_each_train_state(arch):
    """16 x 16 to 2 x 16 x 16, then the 2 x 16 x 16 specs onto a mesh they
    do not divide (moved bytes and indivisible dims)."""
    specs = state_sharding.train_state_specs(
        OptimizerConfig(name="adafactor"),
        build_model(get_config(arch)).param_specs())
    rspecs = ref_state.train_state_specs(
        RefOptConfig(name="adafactor"),
        ref_build_model(ref_get_config(arch)).param_specs())
    is_spec = {"is_leaf": lambda x: isinstance(x, RefParamSpec)}
    shapes = tree_map_with_path(lambda _, s: s.shape, specs)
    rshapes = jax.tree_util.tree_map(lambda s: s.shape, rspecs, **is_spec)
    moves = [(FakeMesh(data=16, model=16),
              FakeMesh(pod=2, data=16, model=16)),
             (FakeMesh(pod=2, data=16, model=16),
              FakeMesh(pod=4, data=16, model=12))]
    for old, new in moves:
        rules, rrules = shd.make_rules("train"), ref_shd.make_rules("train")
        pspecs = tree_map_with_path(
            lambda _, s: shd.pspec_for(s.shape, s.axes, rules.params, old),
            specs)
        rpspecs = jax.tree_util.tree_map(
            lambda s: ref_shd.pspec_for(s.shape, s.axes, rrules.params, old),
            rspecs, **is_spec)
        got = reshard_plan(pspecs, old, new, shapes)
        _same_report(got, ref_reshard_plan(rpspecs, old, new, rshapes))
    assert got.moved_bytes > 0


def _numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "scale": rng.standard_normal(16).astype(np.float32),
            "emb": rng.standard_normal((6, 4)).astype(np.float32),
            "nested": {"step": np.asarray(7, np.int32)}}


def test_elastic_restore_is_the_reference_bit_for_bit(tmp_path, gloo):
    host = _numpy_tree()
    rtree = {"w": jnp.asarray(host["w"], jnp.bfloat16),
             "scale": jnp.asarray(host["scale"]),
             "emb": jnp.asarray(host["emb"], jnp.bfloat16),
             "nested": {"step": jnp.asarray(host["nested"]["step"])}}
    tree = {"w": torch.from_numpy(host["w"]).bfloat16(),
            "scale": torch.from_numpy(host["scale"]),
            "emb": torch.from_numpy(host["emb"]).bfloat16(),
            "nested": {"step": torch.from_numpy(host["nested"]["step"])}}
    pspecs = {"w": shd.P("data", "model"), "scale": shd.P(None),
              "emb": shd.P(None, "model"), "nested": {"step": shd.P()}}
    rpspecs = {"w": JP("data", "model"), "scale": JP(None),
               "emb": JP(None, "model"), "nested": {"step": JP()}}
    ref = RefCheckpointer(str(tmp_path / "ref"))
    ref.save(3, rtree)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    rrestored, rstep = ref_elastic_restore(ref, rtree, rpspecs, jmesh)
    port = Checkpointer(str(tmp_path / "port"))
    port.save(3, tree)
    like = tree_map_with_path(
        lambda _, t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)
    restored, step = elastic_restore(port, like, pspecs, gloo)
    assert step == rstep == 3
    want = {"w": (Shard(0), Shard(1)), "scale": (Replicate(), Replicate()),
            "emb": (Replicate(), Shard(1)),
            "nested": {"step": (Replicate(), Replicate())}}
    for path in (("w",), ("scale",), ("emb",), ("nested", "step")):
        got, ref_leaf = restored, rrestored
        placements = want
        for key in path:
            got, ref_leaf, placements = got[key], ref_leaf[key], \
                placements[key]
        assert isinstance(got, DTensor)
        assert tuple(got.placements) == placements
        full = got.full_tensor()
        ref_np = np.asarray(ref_leaf)
        assert str(full.dtype).rsplit(".", 1)[-1] == ref_np.dtype.name
        if full.dtype == torch.bfloat16:
            assert np.array_equal(full.view(torch.int16).numpy(),
                                  ref_np.view(np.int16)), path
        else:
            assert np.array_equal(full.numpy(), ref_np), path


class RankView:
    """A mesh of the given dim sizes as one rank sees it."""

    def __init__(self, sizes, coord):
        self.sizes, self.coord = sizes, coord

    def size(self, i):
        return self.sizes[i]

    def get_coordinate(self):
        return list(self.coord)


def test_restore_cuts_each_ranks_own_shard_on_the_host():
    """On a 2 x 2 x 2 ("pod", "data", "model") mesh each rank's shard,
    cut from the restored host leaf, is its own block, pod major over
    data as JAX's ``NamedSharding`` places it; a replicated leaf is whole
    on every rank."""
    full = torch.arange(8 * 6).reshape(8, 6)
    mesh = FakeMesh(pod=2, data=2, model=2)
    sharded = shd.spec_placements(shd.P(("pod", "data"), "model"), mesh)
    whole = shd.spec_placements(shd.P(), mesh)
    for p in range(2):
        for d in range(2):
            for m in range(2):
                rank = RankView((2, 2, 2), (p, d, m))
                row = (p * 2 + d) * 2
                assert torch.equal(_local_shard(full, sharded, rank),
                                   full[row:row + 2, m * 3:m * 3 + 3])
                assert torch.equal(_local_shard(full, whole, rank), full)


def test_fault_tolerance_matches_the_reference_on_seeded_sequences():
    rng = np.random.default_rng(0)
    for _ in range(20):
        deadline = float(rng.uniform(0.5, 5.0))
        port, ref = HeartbeatMonitor(deadline), RefMonitor(deadline)
        now = 0.0
        for _ in range(60):
            now += float(rng.exponential(0.7))
            if rng.random() < 0.7:
                w = int(rng.integers(0, 12))
                port.beat(w, now)
                ref.beat(w, now)
            else:
                assert port.sweep(now) == ref.sweep(now)
            assert port.alive() == ref.alive()
    for factor in (1.5, 2.0, 4.0):
        port, ref = StragglerPolicy(factor), RefPolicy(factor)
        for pred, elapsed in rng.uniform(0.0, 10.0, (200, 2)):
            assert port.is_straggler(pred, elapsed) == \
                ref.is_straggler(pred, elapsed)
            assert port.redo_cost(pred) == ref.redo_cost(pred)
    assert StragglerPolicy().factor == RefPolicy().factor


# tests/test_sharding.py's HLO sample as events: (op, result bytes, group)
HLO_SAMPLE = """
HloModule test
  %ar = bf16[16,1024]{1,0} all-reduce(bf16[16,1024] %x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = bf16[64,512]{1,0} all-gather(bf16[16,512] %y), replica_groups=[8,4]<=[32], dimensions={0}
  %rs = f32[8,128]{1,0} reduce-scatter(f32[32,128] %z), replica_groups={{0,1,2,3}}, to_apply=%add
  %cp = bf16[4,4]{1,0} collective-permute(bf16[4,4] %w), source_target_pairs={{0,1}}
  %dot = bf16[4,4]{1,0} dot(bf16[4,4] %a, bf16[4,4] %b)
"""
EVENTS = [("all-reduce", 16 * 1024 * 2, 4), ("all-gather", 64 * 512 * 2, 4),
          ("reduce-scatter", 8 * 128 * 4, 4), ("collective-permute", 32, None),
          ("dot", 32, None)]


def test_collective_arithmetic_is_the_reference():
    got = hlo_stats.parse_collectives(EVENTS)
    want = ref_hlo.parse_collectives(HLO_SAMPLE)
    assert got.counts == want.counts
    assert got.payload_bytes == want.payload_bytes
    assert got.link_bytes == want.link_bytes
    assert got.total_payload() == want.total_payload()
    assert hlo_stats._OPS == ref_hlo._OPS
    for op in ref_hlo._OPS:
        for rb, n in ((0, 1), (4096, 1), (4096, 2), (1000, 16), (77, 256)):
            assert hlo_stats._link_bytes(op, rb, n) == \
                ref_hlo._link_bytes(op, rb, n)
        assert hlo_stats.count_op(EVENTS, op) == want.counts[op]


def test_recorder_names_functional_collectives(gloo):
    group = dist.group.WORLD
    x = torch.ones(4, 8)
    with hlo_stats.CollectiveRecorder() as rec:
        funcol.all_reduce(x, "sum", group).wait()
        funcol.all_gather_single(x, 0, group).wait()
        funcol.reduce_scatter_single(x, "sum", 0, group).wait()
        funcol.all_to_all_single(x, None, None, group).wait()
        y = x + 1
    assert rec.events == [("all-reduce", 128, 1), ("all-gather", 128, 1),
                          ("reduce-scatter", 128, 1), ("all-to-all", 128, 1)]
    stats = rec.collective_summary()
    assert stats.link_bytes == 0.0          # one rank: nothing on a link
    assert torch.equal(y, x + 1)


FAKE_WORLD_CODE = """
import json, torch, torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import init_fake_world
init_fake_world(4)
x = torch.ones(4, 8)
with hlo_stats.CollectiveRecorder() as rec:
    funcol.all_reduce(x, "sum", dist.group.WORLD).wait()
    funcol.all_gather_single(x, 0, dist.group.WORLD).wait()
    dist.send(x, dst=1)
st = rec.collective_summary()
print(json.dumps({"events": rec.events, "link": st.link_bytes}))
dist.destroy_process_group()
"""


def test_recorder_on_a_fake_world_of_four():
    """Group sizes from the fake world's group, and a send recorded as
    the point-to-point ``collective-permute`` (its tensor's bytes)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", FAKE_WORLD_CODE],
                          capture_output=True, text=True, env=env, cwd=root,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [tuple(e) for e in got["events"]] == [
        ("all-reduce", 128, 4), ("all-gather", 512, 4),
        ("collective-permute", 128, 1)]
    assert got["link"] == 2 * 3 / 4 * 128 + 3 / 4 * 512 + 128
