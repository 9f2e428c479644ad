"""Parameter specs and parameter trees of the PyTorch port.

Models declare their parameters as nested dicts of :class:`ParamSpec`
(shape, dtype, logical axes, initializer), keyed exactly like the JAX
package's trees (``repro.models.params``), so a path string such as
``blocks/dense/mlp/w_up`` names the same tensor in both packages.
``init_params`` materializes a tree on a device from a
``torch.Generator``: it reproduces the reference initializer's
*distribution* (fan-in scaled normal, 0.02 for embeddings, ones and
zeros), not its bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np
import torch

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    axes: tuple[str | None, ...] = ()
    init: str = "normal"          # normal | zeros | ones | embed
    init_scale: float | None = None  # stddev override

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} rank mismatch with shape {self.shape}")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def path_str(path: tuple[str, ...]) -> str:
    """``"/"``-joined dict keys (the reference's ``_path_str`` form)."""
    return "/".join(path)


def tree_leaves_with_path(tree: PyTree, prefix: tuple[str, ...] = ()
                          ) -> Iterator[tuple[tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested-dict tree, keys sorted at every
    level (the order JAX flattens dicts in)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves_with_path(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def tree_map_with_path(fn: Callable, tree: PyTree, *rest: PyTree,
                       prefix: tuple[str, ...] = ()) -> PyTree:
    """Map ``fn(path, leaf, *rest_leaves)`` over nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      prefix=prefix + (k,))
                for k, v in tree.items()}
    return fn(prefix, tree, *rest)


def std_of(spec: ParamSpec) -> float:
    """Standard deviation of a normal-initialized spec."""
    if spec.init_scale is not None:
        return spec.init_scale
    if spec.init == "embed":
        return 0.02
    fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.size, 1)
    # stacked-layer params: fan-in excludes the leading "layers" axis
    if spec.axes and spec.axes[0] == "layers" and len(spec.shape) >= 3:
        fan_in = spec.shape[1]
    return float(fan_in) ** -0.5


def init_params(specs: PyTree, generator: torch.Generator,
                device) -> PyTree:
    """Materialize a parameter tree on ``device``, drawing every normal
    leaf from ``generator`` (which must live on ``device``) in sorted
    path order."""
    out: dict = {}
    for path, spec in tree_leaves_with_path(specs):
        if spec.init == "zeros":
            leaf = torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        elif spec.init == "ones":
            leaf = torch.ones(spec.shape, dtype=spec.dtype, device=device)
        else:
            leaf = torch.randn(spec.shape, generator=generator,
                               dtype=torch.float32, device=device)
            leaf = leaf.mul_(std_of(spec)).to(spec.dtype)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out
