"""The port's checkpointer and the resumable train loop on the CPU.

The checkpointer keeps the reference's layout (``step_XXXXXXXX/``, one
``arr_NNNNN.npy`` per leaf in path order, bf16 as uint16 bits, a
``COMMITTED`` marker, ``.tmp`` directories ignored, the latest k kept)
with a JSON index keyed by path names: a tree the reference saves and the
port saves gives the same arrays byte for byte.  Round trips keep dtypes,
values and ``requires_grad``; an async save commits after ``wait``; a
missing step raises.  The loop resumes from the newest committed step:
four steps straight equal two, a save, a resume and two more, bit for
bit, and SIGTERM saves an emergency checkpoint.
"""
import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import path_str, \
    tree_leaves_with_path  # noqa: E402
from repro_torch.training import OptimizerConfig, TrainConfig  # noqa: E402
from repro_torch.training.train_loop import LoopConfig, \
    train_loop  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: as fast
    alone, and the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.standard_normal((8, 16))).bfloat16(),
        "scale": torch.from_numpy(rng.standard_normal(16)).float()
        .requires_grad_(),
        "nested": {"step": torch.tensor(7, dtype=torch.int32),
                   "v": torch.from_numpy(rng.standard_normal((3, 2, 5)))
                   .float()},
    }


def _equal(a, b) -> bool:
    la, lb = list(tree_leaves_with_path(a)), list(tree_leaves_with_path(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x.detach(), y.detach())
        and x.requires_grad == y.requires_grad
        for (_, x), (_, y) in zip(la, lb))


@pytest.mark.parametrize("mode", ["save", "async"])
def test_round_trip(tmp_path, mode):
    ckpt = Checkpointer(str(tmp_path))
    tree = _tree()
    if mode == "save":
        ckpt.save(5, tree)
    else:
        ckpt.save_async(5, tree)
        ckpt.wait()
    assert ckpt.latest_step() == 5
    like = _tree(1)
    restored, step = ckpt.restore(None, like)
    assert step == 5 and _equal(restored, tree)
    with open(tmp_path / "step_00000005" / "index.json") as f:
        meta = json.load(f)
    assert [m["path"] for m in meta["leaves"]] == \
        [path_str(p) for p, _ in tree_leaves_with_path(tree)]
    assert meta["leaves"][-1]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_00000005" / "arr_00003.npy").dtype == \
        np.uint16


def test_layout_is_the_reference_s(tmp_path):
    """The same tree saved by both packages: the same files of arrays,
    byte for byte (path order is JAX's dict order; bf16 as its bits)."""
    tree = _tree()
    jtree = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.detach().float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else
            np.dtype(str(t.dtype).rsplit(".", 1)[-1])), tree)
    JaxCheckpointer(str(tmp_path / "ref")).save(3, jtree)
    Checkpointer(str(tmp_path / "port")).save(3, tree)
    ref, port = (tmp_path / d / "step_00000003" for d in ("ref", "port"))
    arrays = sorted(f for f in os.listdir(ref) if f.endswith(".npy"))
    assert arrays == sorted(f for f in os.listdir(port)
                            if f.endswith(".npy"))
    assert len(arrays) == 4
    for name in arrays:
        a, b = np.load(ref / name), np.load(port / name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert os.path.exists(port / "COMMITTED")


def test_keep_latest_k_and_ignore_uncommitted(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, _tree(s))
    assert ckpt.steps() == [3, 4]
    # a crash mid-save, and a directory never committed
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000007")
    assert ckpt.latest_step() == 4
    with pytest.raises(FileNotFoundError):
        ckpt.restore(7, _tree())
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(None, _tree())
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(None, {"w": _tree()["w"]})


def _run(tmp_path, steps, ckpt_dir=None, log=None):
    model = Model(get_reduced_config("gemma-2b"))
    tc = TrainConfig(optimizer=OptimizerConfig(lr=3e-3, warmup_steps=1,
                                               total_steps=4),
                     accum_steps=2)
    dc = DataConfig(vocab_size=model.cfg.vocab_size, seq_len=16,
                    global_batch=4)
    lc = LoopConfig(total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=2,
                    log_every=1)
    return train_loop(model, tc, dc, lc, device="cpu",
                      log=log or (lambda line: None))


def test_resume_equals_a_straight_run(tmp_path):
    straight = _run(tmp_path, 4)
    ckpt_dir = str(tmp_path / "ckpt")
    first = _run(tmp_path, 2, ckpt_dir)
    lines = []
    second = _run(tmp_path, 4, ckpt_dir, log=lines.append)
    assert lines[0] == "[train] resumed from step 2"
    assert [s for s, _ in first["losses"] + second["losses"]] == \
        [0, 1, 2, 3]
    assert first["losses"] + second["losses"] == straight["losses"]
    assert _equal(second["state"], straight["state"])
    assert int(second["state"]["step"]) == 4
    assert Checkpointer(ckpt_dir).steps() == [2, 4]


def test_sigterm_saves_an_emergency_checkpoint(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")

    def log(line):
        if line.startswith("[train] step 0 "):
            os.kill(os.getpid(), signal.SIGTERM)
    before = signal.getsignal(signal.SIGTERM)
    out = _run(tmp_path, 4, ckpt_dir, log=log)
    assert signal.getsignal(signal.SIGTERM) is before
    assert [s for s, _ in out["losses"]] == [0]
    assert Checkpointer(ckpt_dir).steps() == [1]
    restored, step = Checkpointer(ckpt_dir).restore(None, out["state"])
    assert step == 1 and _equal(restored, out["state"])
