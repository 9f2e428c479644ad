"""Parameter specs and parameter trees of the PyTorch port.

Models declare their parameters as nested dicts of :class:`ParamSpec`
(shape, dtype, logical axes, initializer), keyed exactly like the JAX
package's trees (``repro.models.params``), so a path string such as
``blocks/dense/mlp/w_up`` names the same tensor in both packages.
``init_params`` materializes a tree on a device from a
``torch.Generator``: it reproduces the reference initializer's
*distribution* (fan-in scaled normal, 0.02 for embeddings, ones and
zeros), not its bits.  A leaf too large to draw whole in fp32 beside
the rest of the tree (arctic-480b's expert stacks: 17.85 GB in bf16, a
35.7 GB fp32 draw) is drawn slice by slice along its leading axes.
"""
from __future__ import annotations

import dataclasses
import itertools
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


# A normal leaf of more elements than this (a 32 GiB fp32 draw) is drawn
# in slices of at most SLICE_DRAW_ELEMENTS along its leading axes.  The
# largest leaf of a config registered before arctic-480b is deepseek-v2-
# lite-16b's expert stack (4.8e9 elements), drawn whole: those configs'
# weights keep their bits.
WHOLE_DRAW_ELEMENTS = 2 ** 33
SLICE_DRAW_ELEMENTS = 2 ** 28


def draws_in_slices(spec: ParamSpec) -> bool:
    """Whether ``init_params`` draws this normal leaf slice by slice."""
    return spec.init not in ("zeros", "ones") and \
        spec.size > WHOLE_DRAW_ELEMENTS


def _draw_normal(spec: ParamSpec, generator: torch.Generator, device):
    std = std_of(spec)
    if not draws_in_slices(spec):
        leaf = torch.randn(spec.shape, generator=generator,
                           dtype=torch.float32, device=device)
        return leaf.mul_(std).to(spec.dtype)
    # the fewest leading axes whose slices fit SLICE_DRAW_ELEMENTS; each
    # slice is drawn in fp32, scaled and cast into the bf16 leaf
    lead = next(n for n in range(1, len(spec.shape) + 1)
                if int(np.prod(spec.shape[n:])) <= SLICE_DRAW_ELEMENTS)
    leaf = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    for idx in itertools.product(*(range(n) for n in spec.shape[:lead])):
        part = torch.randn(spec.shape[lead:], generator=generator,
                           dtype=torch.float32, device=device)
        leaf[idx] = part.mul_(std).to(spec.dtype)
    return leaf


def init_params(specs: PyTree, generator: torch.Generator,
                device) -> PyTree:
    """Materialize a parameter tree on ``device``, drawing every normal
    leaf from ``generator`` (which must live on ``device``) in sorted
    path order (a leaf past WHOLE_DRAW_ELEMENTS slice by slice)."""
    out: dict = {}
    for path, spec in tree_leaves_with_path(specs):
        if spec.init == "zeros":
            leaf = torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        elif spec.init == "ones":
            leaf = torch.ones(spec.shape, dtype=spec.dtype, device=device)
        else:
            leaf = _draw_normal(spec, generator, device)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def count_params(specs: PyTree) -> int:
    """Elements over every :class:`ParamSpec` leaf of ``specs``."""
    return sum(spec.size for _, spec in tree_leaves_with_path(specs))


def count_param_bytes(specs: PyTree) -> int:
    """Bytes over every :class:`ParamSpec` leaf of ``specs``, at each
    leaf's dtype."""
    return sum(spec.size * torch.tensor([], dtype=spec.dtype).element_size()
               for _, spec in tree_leaves_with_path(specs))


def meta_params(specs: PyTree) -> PyTree:
    """The tree of ``specs`` as tensors on the meta device: shapes and
    dtypes without storage (the reference's ``ShapeDtypeStruct`` tree)."""
    return tree_map_with_path(
        lambda _, s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
        specs)


def map_logical_axes(specs: PyTree,
                     fn: Callable[[tuple[str | None, ...]], Any]) -> PyTree:
    """Map each ParamSpec's logical axes through ``fn`` (e.g. -> a
    ``dist.sharding.PartitionSpec``)."""
    return tree_map_with_path(lambda _, s: fn(s.axes), specs)


# the reference's names, bound without a second ``def``: the repository's
# static analyzer resolves the reference's calls of them by the function
# name being unique in the corpus
param_count = count_params
param_bytes = count_param_bytes
abstract_params = meta_params
map_axes = map_logical_axes
