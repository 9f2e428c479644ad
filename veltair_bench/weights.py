"""Seeded weights on the device, in the dtype they are served in.

The tree comes from a reference module's ``layout(config)``; every leaf
is one draw from a ``torch.Generator`` on the device (a stacked leaf
holds all layers, so a model is a dozen or so calls).  The same tensors
go to the program and to the reference.
"""
from __future__ import annotations

import math

import torch


def make(layout: list, seed: int, device) -> dict:
    """The nested weight tree of ``layout``, drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    tree: dict = {}
    for path, shape, dtype, init, std in layout:
        if init == "normal":
            leaf = torch.randn(shape, generator=gen, dtype=dtype,
                               device=device).mul_(std)
        elif init == "one_plus":
            leaf = torch.randn(shape, generator=gen, dtype=dtype,
                               device=device).mul_(std).add_(1.0)
        elif init in ("log_uniform", "dt_bias"):
            lo, hi = std
            u = torch.rand(shape, generator=gen, dtype=torch.float32,
                           device=device)
            if init == "log_uniform":
                leaf = torch.log(lo + (hi - lo) * u)
            else:
                # a step size log-uniform in [lo, hi], stored as the
                # inverse of softplus: dt + log(1 - exp(-dt))
                dt = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo))
                               * u)
                leaf = dt + torch.log(-torch.expm1(-dt))
            leaf = leaf.to(dtype)
        else:
            raise ValueError(f"{'/'.join(path)}: unknown init {init!r}")
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def leaves(tree: dict, prefix: tuple = ()):
    """(path, leaf) pairs of a nested dict, keys sorted."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val
