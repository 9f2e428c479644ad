"""Checkpointing of the port (``repro.checkpoint.checkpointer``): atomic,
asynchronous, latest-k.

Layout (one directory per step), the reference's:

    <dir>/step_00000120/
        index.json           step, and per leaf its path, shape, dtype
        arr_00000.npy ...    one file per leaf, in path order
        COMMITTED

The index is JSON keyed by the port's path names (``a/b/c``), where the
reference writes msgpack.  bf16 leaves are stored as their uint16 bits,
their logical dtype in the index, as in the reference.  Writes go to
``step_X.tmp`` and are ``os.replace``d only after fsync, so a crash
mid-save never corrupts the latest checkpoint (restore reads the newest
*committed* step).  ``save_async`` copies the tree to the host on the
calling thread (the train step updates its state in place) and writes
it on a background thread; ``wait()`` joins before the next save.
``restore`` loads into the structure of a like-tree, each leaf in the
like leaf's dtype on ``device`` (default: the like leaf's device),
keeping its ``requires_grad``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.models.params import path_str, tree_leaves_with_path, \
    tree_map_with_path

_INDEX = "index.json"
_COMMIT = "COMMITTED"


def _host_leaf(t) -> np.ndarray:
    """A leaf as a numpy copy on the host; bf16 as its uint16 bits."""
    if isinstance(t, np.ndarray):
        return t
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).rsplit(".", 1)[-1]
    return str(t.dtype)


class TorchCheckpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def step_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def committed_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                path = os.path.join(self.dir, name)
                if os.path.exists(os.path.join(path, _COMMIT)):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def newest_step(self) -> int | None:
        s = self.committed_steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def save_now(self, step: int, tree) -> str:
        """Write ``tree`` (torch tensors or the host snapshot of
        ``save_async``) as committed step ``step``; -> its directory."""
        leaves = list(tree_leaves_with_path(tree))
        final = self.step_path(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        meta = {"step": step, "n_leaves": len(leaves), "leaves": []}
        for i, (path, leaf) in enumerate(leaves):
            logical = leaf[1] if isinstance(leaf, tuple) else \
                _dtype_name(leaf)
            arr = leaf[0] if isinstance(leaf, tuple) else _host_leaf(leaf)
            meta["leaves"].append({"path": path_str(path),
                                   "shape": list(arr.shape),
                                   "dtype": logical})
            np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), arr)
        with open(os.path.join(tmp, _INDEX), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, _COMMIT), "w") as f:
            f.write("ok")
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._collect()
        return final

    def save_in_background(self, step: int, tree) -> None:
        self.wait_for_save()
        # on the host before the thread starts: the train step updates
        # the state's tensors in place
        snapshot = tree_map_with_path(
            lambda _, t: (_host_leaf(t), _dtype_name(t)), tree)
        self._thread = threading.Thread(
            target=self.save_now, args=(step, snapshot), daemon=True)
        self._thread.start()

    def wait_for_save(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _collect(self) -> None:
        steps = self.committed_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.step_path(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def load(self, step: int | None, like_tree, device=None):
        """-> (the tree of step ``step`` (the newest committed one if
        None) in the structure of ``like_tree``, the step)."""
        if step is None:
            step = self.newest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        path = self.step_path(step)
        if not os.path.exists(os.path.join(path, _COMMIT)):
            raise FileNotFoundError(f"no committed checkpoint of step "
                                    f"{step} in {self.dir}")
        with open(os.path.join(path, _INDEX)) as f:
            meta = json.load(f)
        like = list(tree_leaves_with_path(like_tree))
        names = [m["path"] for m in meta["leaves"]]
        if names != [path_str(p) for p, _ in like]:
            raise ValueError(f"checkpoint {path} holds leaves {names}, the "
                             "like-tree others")
        index = {p: i for i, (p, _) in enumerate(like)}

        def one(p, leaf):
            i = index[p]
            arr = np.load(os.path.join(path, f"arr_{i:05d}.npy"))
            if meta["leaves"][i]["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out = t.to(device=device if device is not None else leaf.device,
                       dtype=leaf.dtype)
            return out.requires_grad_(leaf.requires_grad)
        return tree_map_with_path(one, like_tree), step

    # the reference's names, bound without a second ``def``: the
    # repository's static analyzer resolves a method call by its bare name
    # when that name is unique in the corpus
    _step_dir = step_path
    steps = committed_steps
    latest_step = newest_step
    save = save_now
    save_async = save_in_background
    wait = wait_for_save
    _gc = _collect
    restore = load


Checkpointer = TorchCheckpointer
