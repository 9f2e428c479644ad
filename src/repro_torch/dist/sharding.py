"""Logical-axis -> mesh-axis sharding rules over whole trees
(``repro.dist.sharding``).

Models declare *logical* axes on every tensor (``models.params``); a
:class:`RuleSet` maps those names onto mesh axes for one execution mode.
One tensor's spec, its placements and the in-model ``hint`` live in
``dist.placement`` (re-exported here); this module adds the rule tables
and the tree-level functions: ``param_pspecs``, ``shardings_of`` (a
placement tuple per leaf) and ``device_bytes``.
"""
from __future__ import annotations

# one tensor's spec, placements and ``hint``, re-exported
from repro_torch.dist.placement import DATA_AXES, P, PartitionSpec, \
    RuleSet, TorchRuleSet, constrain, hint, mesh_axis_sizes, \
    partition_spec, pspec_for, rules_in_force, spec_placements, \
    spec_shards, use_rules  # noqa: F401
from repro_torch.models.params import tree_leaves_with_path, \
    tree_map_with_path


def rule_tables(mode: str, seq_parallel: bool = False) -> RuleSet:
    """Rule tables for ``mode`` in {"train", "serve"}, the same on one
    pod and on two (the "pod" axis is simply absent from a single-pod
    mesh).

    Weights: FSDP over the data family + tensor parallel over "model".
    Activations: batch over the data family; logits vocab over "model".
    ``seq_parallel`` additionally shards activation/cache sequence axes
    over "model" (context-parallel decode for kv_heads=1 archs, where the
    model axis is otherwise idle)."""
    params = {
        "embed": ("pod", "data"),
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "expert": "model",
        "kv_lora": "model",
        "inner": "model",
    }
    acts = {
        "batch": ("pod", "data"),
        "groups": ("pod", "data"),
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "expert": "model",
    }
    if seq_parallel:
        acts["seq"] = "model"
    return RuleSet(name=mode, params=params, acts=acts)


def param_partition_specs(specs, rules: RuleSet, mesh):
    """PartitionSpec tree for a ParamSpec tree under the params rules."""
    return tree_map_with_path(
        lambda _, s: partition_spec(s.shape, s.axes, rules.params, mesh),
        specs)


def placements_of(pspecs, mesh):
    """Placement tree (a tuple per leaf, one entry per mesh dim) from a
    PartitionSpec tree."""
    return tree_map_with_path(lambda _, ps: spec_placements(ps, mesh),
                              pspecs)


def per_device_bytes(pspecs, specs, mesh) -> int:
    """Total per-device bytes of a ParamSpec tree under the given
    pspecs (each leaf's bytes floor-divided by its shard count)."""
    total = 0
    for (_, ps), (_, sp) in zip(tree_leaves_with_path(pspecs),
                                tree_leaves_with_path(specs)):
        total += sp.size * sp.dtype.itemsize // spec_shards(ps, mesh)
    return total


# the reference's names, bound without a second ``def``: the repository's
# static analyzer resolves the reference's calls of them by the function
# name being unique in the corpus
make_rules = rule_tables
param_pspecs = param_partition_specs
shardings_of = placements_of
device_bytes = per_device_bytes
