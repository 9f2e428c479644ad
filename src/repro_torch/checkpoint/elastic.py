"""Elastic scaling: reshard a checkpoint onto a different mesh
(``repro.checkpoint.elastic``).

The checkpoint format is topology-free (host-gathered leaves), so an
elastic restore is a ``Checkpointer.restore`` into host memory followed,
for each leaf, by cutting this rank's shard on the host and making it a
DTensor on the new ``DeviceMesh`` with the placements of its
PartitionSpec.  This module adds the policy layer a
cluster controller needs:

  * ``reshard_plan`` — given old/new meshes, report the leaves whose
    shard count changes, the bytes a re-layout moves, and the sharded
    dims the new mesh cannot divide; it counts 2 bytes an element
    whatever the leaf's dtype, as the reference does;
  * ``elastic_restore`` — restore the newest (or a given) step onto the
    new mesh: -> (tree of DTensors, step).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.dist.placement import _entry_axes, mesh_axis_sizes, \
    spec_placements, spec_shards
from repro_torch.models.params import tree_leaves_with_path, \
    tree_map_with_path


@dataclasses.dataclass
class TorchReshardReport:
    n_leaves: int
    moved_bytes: int
    incompatible: list[str]


ReshardReport = TorchReshardReport


def plan_reshard(pspec_tree, old_mesh, new_mesh,
                 shape_tree) -> ReshardReport:
    """Leaves, moved bytes and indivisible dims of moving ``pspec_tree``'s
    leaves (shapes in ``shape_tree``, tuples) from ``old_mesh`` to
    ``new_mesh``; leaves numbered in sorted path order."""
    moved = 0
    bad: list[str] = []
    specs = [ps for _, ps in tree_leaves_with_path(pspec_tree)]
    shapes = [s for _, s in tree_leaves_with_path(shape_tree)]
    new_sizes = mesh_axis_sizes(new_mesh)
    for i, (spec, shape) in enumerate(zip(specs, shapes)):
        old_n = spec_shards(spec, old_mesh)
        new_n = spec_shards(spec, new_mesh)
        size = int(np.prod(shape)) * 2
        if old_n != new_n:
            moved += size
        # divisibility on the sharded dims
        for dim, entry in zip(shape, spec):
            if entry is None:
                continue
            factor = 1
            for ax in _entry_axes(entry):
                factor *= new_sizes[ax]
            if dim % factor:
                bad.append(f"leaf{i}: dim {dim} % {factor} != 0")
    return ReshardReport(n_leaves=len(specs), moved_bytes=moved,
                         incompatible=bad)


def _local_shard(t: torch.Tensor, placements, mesh) -> torch.Tensor:
    """This rank's shard of the full host tensor ``t``: mesh dims in
    order, major first, each ``Shard(d)`` taking this rank's
    ``torch.chunk`` of dim ``d``, as DTensor splits a tensor."""
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            t = torch.chunk(t, mesh.size(i), dim=pl.dim)[coord[i]]
    return t


def restore_onto_mesh(ckpt: Checkpointer, like_tree, pspec_tree, new_mesh,
                      step: int | None = None):
    """Restore the newest (or given) step in the structure and dtypes of
    ``like_tree`` (real, fake or meta tensors) onto ``new_mesh``: each
    leaf a DTensor with its PartitionSpec's placements.  Leaves are read
    into host memory and cut there, so each rank's device receives only
    its own shard (the reference's ``device_put`` from the host).
    -> (tree, step)."""
    tree, step = ckpt.restore(step, like_tree, device="cpu")

    def place(_, t, spec):
        placements = spec_placements(spec, new_mesh)
        local = _local_shard(t.detach(), placements, new_mesh)
        local = local.contiguous().to(new_mesh.device_type)
        out = DTensor.from_local(local, new_mesh, list(placements),
                                 run_check=False, shape=t.shape,
                                 stride=t.stride())
        return out.requires_grad_(t.requires_grad)
    return tree_map_with_path(place, tree, pspec_tree), step


# the reference's names, bound without a second ``def``: the repository's
# static analyzer resolves the reference's calls of them by the function
# name being unique in the corpus
reshard_plan = plan_reshard
elastic_restore = restore_onto_mesh
