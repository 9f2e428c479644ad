"""Partition specs, their DTensor placements, and the in-model ``hint``
annotation point: the leaf of ``dist.sharding`` that the kernels and the
models import (it imports no model code).

``pspec_for`` turns (shape, axes, rules, mesh) into a
:class:`PartitionSpec` — per tensor dim ``None`` (replicated), one mesh
axis name, or a tuple of names (sharded over their product, major
first) — enforcing the reference's rules:

  * divisibility — a mesh axis whose size does not divide the dim is not
    used (a tuple rule keeps the longest prefix whose product divides);
  * single use — each mesh axis appears at most once per spec;
  * GQA TP fallback — when a tensor-parallel (scalar) rule exists but the
    dim cannot shard over it (e.g. kv_heads=8 on model=16), the whole
    tensor falls back to plain data-parallel sharding: the model axis is
    everywhere replicated and only data-family axes survive, collapsed to
    their scalar form;
  * trailing ``None`` entries are dropped.

A mesh is a ``torch.distributed`` ``DeviceMesh`` (axes by its
``mesh_dim_names``) or any object whose ``.shape`` maps axis names to
sizes.  ``spec_placements`` turns a spec into DTensor placements, one
per mesh dim: ``Shard(d)`` on each mesh axis that tensor dim ``d`` names,
``Replicate()`` on the others (an entry ``("pod", "data")`` shards one
dim over both mesh dims, pod major, as JAX's ``NamedSharding`` does).

``hint`` is the in-model annotation point: a no-op outside a
``use_rules`` context (it returns the very object it was given, after one
Python list check), a ``redistribute`` of a DTensor to the rule's
placements inside one; a plain tensor passes unchanged.  So the same
model code runs unsharded on one card and sharded on a mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

from torch.distributed.tensor import DTensor, Replicate, Shard


# data-family mesh axes (pure replication of the batch): the GQA fallback
# keeps these and drops tensor-parallel axes
DATA_AXES = ("pod", "data")


class PartitionSpec(tuple):
    """One tensor's spec: per dim ``None``, a mesh axis name or a tuple of
    names (JAX's ``PartitionSpec``, as a tuple).  A one-name tuple is
    stored as the name, as JAX stores it: ``P(("data",), "model") ==
    P("data", "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class TorchRuleSet:
    """One mode's rule tables: ``params`` for weights/optimizer state,
    ``acts`` for activations and caches."""
    name: str
    params: dict[str, Any]
    acts: dict[str, Any]


RuleSet = TorchRuleSet


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (by ``mesh_dim_names``) or
    of an object whose ``.shape`` maps names to sizes; {} otherwise."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    try:
        return dict(mesh.shape)
    except (TypeError, ValueError, AttributeError):
        return {}


def partition_spec(shape: tuple[int, ...], axes: tuple, rules: dict,
                   mesh) -> PartitionSpec:
    """PartitionSpec for one tensor under ``rules`` on ``mesh``."""
    sizes = mesh_axis_sizes(mesh)
    entries: list = []
    used: set[str] = set()
    tp_dropped = False
    for dim, ax in zip(shape, axes):
        rule = rules.get(ax) if ax is not None else None
        if rule is None:
            entries.append(None)
            continue
        if isinstance(rule, str):
            size = sizes.get(rule)
            if size and rule not in used and dim % size == 0:
                entries.append(rule)
                used.add(rule)
            else:
                entries.append(None)
                if size and rule not in used:
                    tp_dropped = True       # axis exists but cannot divide
        else:                               # tuple rule: product sharding
            sel: list[str] = []
            prod = 1
            for r in rule:
                size = sizes.get(r)
                if not size or r in used:
                    continue
                if dim % (prod * size) != 0:
                    break                   # drop trailing axes
                sel.append(r)
                prod *= size
            used.update(sel)
            entries.append(tuple(sel) if sel else None)
    if tp_dropped:
        # GQA TP fallback: replicate over the unusable tensor-parallel
        # axis; keep only data-family sharding, in scalar form.
        out: list = []
        for e in entries:
            if isinstance(e, tuple):
                kept = [a for a in e if a in DATA_AXES]
                e = kept[0] if len(kept) == 1 else (tuple(kept) or None)
            elif e is not None and e not in DATA_AXES:
                e = None
            out.append(e)
        entries = out
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)

def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_placements(spec, mesh) -> tuple:
    """DTensor placements, one per mesh dim, of one PartitionSpec."""
    names = list(getattr(mesh, "mesh_dim_names", None)
                 or mesh_axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in _entry_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names mesh axes out of "
                             f"the mesh's major-first order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)

def spec_shards(spec, mesh) -> int:
    """How many shards ``spec`` cuts a tensor into on ``mesh``."""
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for entry in spec:
        for a in _entry_axes(entry):
            n *= sizes[a]
    return n

# --------------------------------------------------------------------------
# hint: in-model sharding annotations
# --------------------------------------------------------------------------
_ACTIVE: list[tuple[Any, RuleSet]] = []


@contextlib.contextmanager
def rules_in_force(mesh, rules: RuleSet):
    """Activate (mesh, rules) so ``hint`` redistributes DTensors."""
    _ACTIVE.append((mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.pop()


def constrain(x, axes: tuple):
    """``x`` redistributed to the active rules' placements for its
    logical ``axes``; ``x`` itself outside a ``use_rules`` context (the
    serving engine, single-card runs) or when it is a plain tensor."""
    if not _ACTIVE:
        return x
    if not isinstance(x, DTensor):
        return x
    mesh, rules = _ACTIVE[-1]
    spec = partition_spec(tuple(x.shape), axes, rules.acts, mesh)
    placements = spec_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def grad_in_place_of(x):
    """``x`` itself, but for a DTensor that requires grad: an alias of it
    whose gradient is redistributed to ``x``'s own placements before it
    reaches ``x``.  A parameter read in two places (a tied embedding: the
    lookup and the unembedding) gets one gradient from each, and autograd
    adds them; a lookup's gradient is a partial sum over the batch's mesh
    axis, which some torch versions' DTensor cannot add to a sharded one.
    Placed alike, they add with no redistribution.  On a plain tensor
    (one card, the serving engine) nothing changes."""
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    mesh, placements = x.device_mesh, tuple(x.placements)
    alias = x.view_as(x)

    def placed(grad):
        if isinstance(grad, DTensor) and tuple(grad.placements) != \
                placements:
            return grad.redistribute(mesh, placements)
        return grad
    alias.register_hook(placed)
    return alias


# the reference's names, bound without a second ``def``: the repository's
# static analyzer resolves the reference's calls of them (``hint`` sits on
# its hot slice) by the function name being unique in the corpus
pspec_for = partition_spec
use_rules = rules_in_force
hint = constrain
