"""Multi-pod dry-run of the port: trace every (arch x shape x mesh) cell
over a fake world of 256 (or 512) ranks, in one process, with no device.

For each runnable cell this script:
  1. initialises the ``"fake"`` process group (``launch.mesh``) and the
     production ``DeviceMesh``: 16 x 16 ("data", "model") or 2 x 16 x 16
     ("pod", "data", "model") ranks standing in for H100s;
  2. builds params (or the train state), batch and cache as DTensors
     whose local shards are fake CPU tensors (shapes and dtypes, no
     storage), placed by the logical-axis rules (``dist.sharding``);
  3. runs the train step, ``prefill`` or ``decode_step`` under
     ``use_rules`` (every ``hint`` in the model redistributes) and
     ``implicit_replication`` (the constants the model makes mid-step
     count as replicated), with a ``FlopCounterMode`` and the collective
     recorder (``launch.hlo_stats``) active; factory ops that take no
     tensor (``arange``, ``full``, ...) make fake tensors, so a 32k x 32k
     mask allocates nothing;
  4. appends a JSON record to ``results/torch_dryrun_<mesh>.jsonl`` with
     the reference's keys: ``memory`` (the local shard bytes of the
     arguments and outputs, summed), ``cost.flops`` (the FLOPs of the
     step's global ops), ``collectives`` (what DTensor issued, under the
     reference's names and ring factors) and ``trace_s`` in place of the
     reference's ``lower_s`` and ``compile_s``.  Nothing measures a
     temporary buffer, so no ``temp_size_in_bytes`` is written.

It runs no kernel and no plain version on real data: every kernel
wrapper sees CPU (fake) tensors and runs its plain version's ops, which
only propagate shapes.  A cell that DTensor cannot trace records
``status: "error"`` with the failing op, as the reference records its
compile errors.  Decode cells read a full cache: the step's position is
the last one (``seq_len - 1``), a host int.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape decode_32k
  python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
import torch.distributed.tensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode, \
    _get_current_dispatch_mode_stack
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, get_shape, \
    shape_applicable
from repro_torch.dist import sharding as shd
from repro_torch.dist.placement import _entry_axes, mesh_axis_sizes, \
    spec_placements
from repro_torch.dist.state_sharding import train_state_specs
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.frontends import input_specs
from repro_torch.models.params import tree_leaves_with_path, \
    tree_map_with_path
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_step import TrainConfig, make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results")

# Per-arch training knobs: (optimizer, accum_steps, accum_dtype), the
# reference's.
TRAIN_KNOBS: dict[str, tuple[str, int, str]] = {
    "llama3-405b": ("adafactor", 16, "bfloat16"),
    "arctic-480b": ("adafactor", 16, "bfloat16"),
    "deepseek-v2-lite-16b": ("adamw", 4, "float32"),
    "gemma-2b": ("adamw", 8, "float32"),
    "minicpm-2b": ("adamw", 8, "float32"),
    "qwen2-vl-2b": ("adamw", 8, "float32"),
    "musicgen-large": ("adamw", 2, "float32"),
    "starcoder2-3b": ("adamw", 4, "float32"),
    "recurrentgemma-2b": ("adamw", 8, "float32"),
    "mamba2-780m": ("adamw", 4, "float32"),
}


def train_settings_for(arch: str) -> TrainConfig:
    opt_name, accum, accum_dtype = TRAIN_KNOBS[arch]
    return TrainConfig(
        optimizer=OptimizerConfig(name=opt_name),
        accum_steps=accum, remat="full", accum_dtype=accum_dtype)


class FakeFactories(TorchDispatchMode):
    """Runs every op that takes no tensor (a factory: ``arange``,
    ``full``, ``zeros``, ...) under ``fake_mode``, so what the model makes
    mid-step is a fake tensor too; ops on DTensors go to DTensor first
    (``NotImplemented``), ops on plain tensors run as they are.  Factories
    for the meta device, and those made while a fake mode is already
    active (DTensor's own sharding propagation), are left alone.
    ``last_dtensor_op`` is the op DTensor was last given (the one a trace
    failed in, when DTensor's error does not name it)."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.last_dtensor_op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self.last_dtensor_op = func
            return NotImplemented
        if types or not _makes_fake(func, args, kwargs):
            return func(*args, **kwargs)
        with self.fake_mode:
            return func(*args, **kwargs)


_DTENSOR_DIR = os.path.dirname(torch.distributed.tensor.__file__)


def _makes_fake(func, args, kwargs) -> bool:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_leaves
    if any(isinstance(a, torch.Tensor) for a in tree_leaves((args, kwargs))):
        return False
    device = kwargs.get("device")
    if device is not None and torch.device(device).type == "meta":
        return False
    if any(isinstance(m, FakeTensorMode)
           for m in _get_current_dispatch_mode_stack()):
        return False
    # a factory DTensor's own dispatch calls (its values may be read on
    # the host) stays real
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_filename.startswith(_DTENSOR_DIR):
            return False
        frame = frame.f_back
    return True


_REGISTERED: list[bool] = []


def register_dtensor_rules() -> None:
    """Once per (dry-run) process, two changes to DTensor's rules:

    * B1's custom op (``repro_torch::block_matmul``, the matmul under
      grad) gets ``aten.mm``'s sharding strategy (row-sharded x,
      column-sharded w, a partial sum over a sharded contraction) and
      ``aten.mm``'s FLOP formula;
    * ``aten.view`` and ``aten._unsafe_view`` may redistribute their
      input, as ``aten.reshape`` may: DTensor otherwise refuses a view
      that would unflatten a dim sharded unevenly (an einsum's output
      view after its ``bmm`` chose to shard ``heads * head_dim`` over a
      mesh axis larger than ``heads``), where XLA inserts the collective.
      On fake shards the lost aliasing changes no shape or placement."""
    if _REGISTERED:
        return
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache
    from torch.distributed.tensor._ops._matrix_ops import mm_strategy
    from torch.distributed.tensor._ops._view_ops import \
        register_op_strategy_map
    from torch.distributed.tensor._ops.utils import register_op_strategy
    from torch.utils.flop_counter import mm_flop, register_flop_formula
    from repro_torch.kernels import block_matmul  # noqa: F401 (the op)
    op = torch.ops.repro_torch.block_matmul

    @register_op_strategy(op.default,
                          schema_info=RuntimeSchemaInfo(static_argnum=2))
    def _(op_schema):
        # (x, w, bm, bk, bn): aten.mm's strategy over (x, w)
        return mm_strategy(dataclasses.replace(
            op_schema, args_schema=op_schema.args_schema[:2]))

    @register_flop_formula(op)
    def _(x_shape, w_shape, *args, **kwargs):
        return mm_flop(x_shape, w_shape)

    for view in (torch.ops.aten.view.default,
                 torch.ops.aten._unsafe_view.default):
        register_op_strategy_map(view, torch.Tensor.view,
                                 schema_info=RuntimeSchemaInfo(1),
                                 strict_view=False)
    # forget what was propagated under the old rules
    _clear_sharding_prop_cache()
    _REGISTERED.append(True)


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _fake_dtensor(spec, pspec, mesh, fake_mode):
    """A DTensor of ``spec``'s global shape placed by ``pspec`` on
    ``mesh``, its local shard a fake CPU tensor."""
    sizes = mesh_axis_sizes(mesh)
    local = list(spec.shape)
    for dim, entry in enumerate(pspec):
        for a in _entry_axes(entry):
            local[dim] //= sizes[a]
    with fake_mode:
        t = torch.empty(local, dtype=spec.dtype)
    return DTensor.from_local(t, mesh, list(spec_placements(pspec, mesh)),
                              run_check=False, shape=torch.Size(spec.shape),
                              stride=_contiguous_stride(spec.shape))


def _placed(specs, table: dict, mesh, fake_mode):
    """The DTensor tree of a ParamSpec tree under one rule table."""
    return tree_map_with_path(
        lambda _, s: _fake_dtensor(
            s, shd.pspec_for(s.shape, s.axes, table, mesh), mesh, fake_mode),
        specs)


def build_dry_cell(arch: str, shape_name: str, mesh, fake_mode):
    """-> (fn, args): ``fn(*args)`` runs the cell's step on DTensors whose
    local shards are fake tensors made in ``fake_mode``."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    model = build_model(cfg)
    rules = shd.make_rules("train" if shape.mode == "train" else "serve")

    batch = _placed(input_specs(cfg, shape), rules.acts, mesh, fake_mode)
    if shape.mode == "train":
        tc = train_settings_for(arch)
        state = _placed(train_state_specs(tc.optimizer, model.param_specs()),
                        rules.params, mesh, fake_mode)
        for _, leaf in tree_leaves_with_path(state["opt"]["master"]):
            leaf.requires_grad_(True)
        step = make_train_step(model, tc)

        def fn(state, batch):
            with shd.use_rules(mesh, rules):
                return step(state, batch)
        return fn, (state, batch)

    params = _placed(model.param_specs(), rules.params, mesh, fake_mode)
    cache = _placed(model.cache_specs(shape.global_batch, shape.seq_len),
                    rules.acts, mesh, fake_mode)
    if shape.mode == "prefill":
        def fn(params, batch, cache):
            with shd.use_rules(mesh, rules), torch.no_grad():
                return model.prefill(params, batch, cache)
        return fn, (params, batch, cache)

    t = shape.seq_len - 1

    def fn(params, batch, cache):
        with shd.use_rules(mesh, rules), torch.no_grad():
            return model.decode_step(params, batch, cache, t)
    return fn, (params, batch, cache)


def _local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in a nested structure of
    dicts, lists and tuples."""
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _failing_op(exc: BaseException) -> str:
    """The aten/c10d op a DTensor trace failed in, from its message chain
    (DTensor names it: "... failed for aten.xxx.default(...)")."""
    import re
    seen = exc
    while seen is not None:
        m = re.search(r"\b((?:aten|c10d|_c10d_functional|repro_torch)"
                      r"\.[A-Za-z0-9_]+(?:\.[A-Za-z0-9_]+)?)", str(seen))
        if m:
            return m.group(1)
        seen = seen.__cause__ or seen.__context__
    return ""


def trace_cell(arch: str, shape_name: str, *, multi_pod: bool) -> dict:
    """One cell's record (the reference's ``dryrun_cell``): the default
    process group must be a fake world of the production mesh's size."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = shape_applicable(cfg, shape)
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "mode": shape.mode}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    t0 = time.time()
    factories = None
    try:
        register_dtensor_rules()
        mesh = make_production_mesh(multi_pod=multi_pod)
        from torch._subclasses.fake_tensor import FakeTensorMode
        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        fn, args = build_dry_cell(arch, shape_name, mesh, fake_mode)
        arg_bytes = _local_bytes(args)
        recorder = hlo_stats.CollectiveRecorder()
        factories = FakeFactories(fake_mode)
        t1 = time.time()
        with recorder, factories, implicit_replication(), \
                FlopCounterMode(display=False) as flops:
            out = fn(*args)
        trace_s = time.time() - t1
        coll = recorder.collective_summary()
        rec.update(
            status="ok",
            n_devices=mesh.size(),
            trace_s=round(trace_s, 1),
            memory={"argument_size_in_bytes": arg_bytes,
                    "output_size_in_bytes": _local_bytes(out)},
            cost={"flops": float(flops.get_total_flops())},
            collectives={
                "counts": coll.counts,
                "payload_bytes": coll.payload_bytes,
                "link_bytes_per_dev": coll.link_bytes,
            },
        )
        if shape.mode == "train":
            rec["train_knobs"] = dict(zip(
                ("optimizer", "accum_steps", "accum_dtype"),
                TRAIN_KNOBS[arch]))
    except Exception as e:
        last = getattr(factories, "last_dtensor_op", None)
        rec.update(status="error", error=f"{type(e).__name__}: {e}"[:2000],
                   op=_failing_op(e) or (str(last) if last else ""),
                   traceback=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list(ARCH_NAMES) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    mesh_tag = "2x16x16" if args.multi_pod else "16x16"
    out_path = args.out or os.path.abspath(
        os.path.join(RESULTS_DIR, f"torch_dryrun_{mesh_tag}.jsonl"))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)

    torch.set_num_threads(1)
    init_fake_world(512 if args.multi_pod else 256)
    records = []
    try:
        for arch in archs:
            for shape_name in shapes:
                rec = trace_cell(arch, shape_name, multi_pod=args.multi_pod)
                records.append(rec)
                with open(out_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                mem = rec.get("memory", {})
                print(f"[dryrun] {arch} x {shape_name} @ {mesh_tag}: "
                      f"{rec['status']}"
                      + (f" (trace {rec.get('trace_s')}s, args "
                         f"{mem.get('argument_size_in_bytes', 0) / 2**30:.2f}"
                         f" GiB/dev, {rec['cost']['flops']:.4g} FLOPs)"
                         if rec["status"] == "ok" else
                         f" {rec.get('reason', rec.get('error', ''))[:300]}"),
                      flush=True)
    finally:
        dist.destroy_process_group()
    return records


# the reference's names, bound without a second ``def``: the repository's
# static analyzer resolves the reference's calls of them by the function
# name being unique in the corpus
train_config_for = train_settings_for
build_cell = build_dry_cell
dryrun_cell = trace_cell


if __name__ == "__main__":
    main()
