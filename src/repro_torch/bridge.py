"""Numpy bridge between the JAX package's trees and the port's.

Trees are nested dicts keyed like the reference's parameter paths
(``repro.models.params._path_str``: ``blocks/dense/mlp/w_up`` is
``tree["blocks"]["dense"]["mlp"]["w_up"]``), with numpy leaves — what
``jax.tree_util.tree_map(np.asarray, tree)`` gives.  A bf16 JAX array
arrives with the ``ml_dtypes`` bfloat16 dtype, which ``torch.from_numpy``
rejects; it crosses through float32, which holds every bf16 value
exactly, and lands as ``torch.bfloat16`` again.  KV caches stay bf16.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.params import tree_map_with_path


def _leaf_to_torch(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    # a copy: arrays viewed from JAX buffers are read-only
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_numpy(tree, *, device):
    """A numpy parameter (or KV-cache) tree as torch tensors on
    ``device``, dtypes kept.  ``device`` has no default: the port runs on
    the card unless its caller asks for the CPU."""
    return tree_map_with_path(lambda _, a: _leaf_to_torch(a, device), tree)


cache_from_numpy = params_from_numpy


def cache_to_numpy(tree):
    """A torch cache tree as numpy copies (the port updates caches in
    place, so a view would change under the caller); bf16 leaves come
    back as float32 (exact), so no bf16 numpy dtype is needed."""
    def one(_, t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return np.array(t.numpy())
    return tree_map_with_path(one, tree)
