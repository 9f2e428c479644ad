"""Mesh construction of the port (``repro.launch.mesh``).

Functions, not module-level constants, so that importing this module
initialises no process group.  A ``DeviceMesh`` stands in for JAX's
``Mesh``: the production meshes name their dims ``("data", "model")`` or
``("pod", "data", "model")`` as the reference's do.

:func:`init_fake_world` sets up the process group that stands in for a
pod of 256 (or two pods, 512) H100s, as the reference's 512 host devices
stand in for v5e chips: PyTorch's ``"fake"`` backend, whose collectives
return at once and move no data.  Paired with DTensors over fake tensors
(``launch.dryrun``) it traces a step at production scale in one process.
This is the only port module that imports PyTorch's fake process group.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def init_fake_world(n: int) -> None:
    """Initialise the default process group as a fake world of ``n``
    ranks, this process rank 0 (no other process, no data moved)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 ranks for one pod; 2x16x16 = 512 across two pods, on
    "cpu" over a fake world (its tensors are fake CPU tensors) and on
    "cuda" over a real one.  Needs an initialised default group of
    exactly that world size."""
    shape, names = PRODUCTION_SHAPES[bool(multi_pod)]
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"the production mesh {shape} needs a default "
                           f"process group of {n} ranks (have {have}); "
                           "see init_fake_world")
    device = "cpu" if dist.get_backend() == "fake" else "cuda"
    return init_device_mesh(device, shape, mesh_dim_names=names)


def debug_mesh(data: int = 1, model: int = 1, device=None) -> DeviceMesh:
    """Tiny ("data", "model") mesh over the ranks of the initialised
    default group (tests: a gloo group of one rank on "cpu"; the card: an
    NCCL group of one rank on "cuda", the default)."""
    if not dist.is_initialized():
        raise RuntimeError("make_debug_mesh needs an initialised default "
                           "process group")
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return init_device_mesh(str(device or "cuda"), (data, model),
                            mesh_dim_names=("data", "model"))


# the reference's names, bound without a second ``def``: the repository's
# static analyzer resolves the reference's calls of them by the function
# name being unique in the corpus
make_production_mesh = production_mesh
make_debug_mesh = debug_mesh
