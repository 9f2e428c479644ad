"""Training loop of the port (``repro.training.train_loop``): resume from
the newest committed checkpoint, an asynchronous save every
``ckpt_every`` steps, an emergency save on SIGTERM, and a host read of
the loss only at ``log_every``."""
from __future__ import annotations

import dataclasses
import signal
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models.model import Model
from repro_torch.training.train_step import TrainConfig, \
    build_train_step, make_train_state


@dataclasses.dataclass
class TorchLoopConfig:
    total_steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0


LoopConfig = TorchLoopConfig


def batch_to_device(batch: dict, device) -> dict:
    """A pipeline batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def run_training(model: Model, train_cfg: TrainConfig, data_cfg: DataConfig,
                 loop_cfg: LoopConfig, *, device, log=print) -> dict:
    """Run (or resume) training on ``device`` (no default: the port runs
    on the card unless its caller asks for the CPU); -> {"state": the
    final train state, "losses": [(step, loss), ...] at the logged
    steps}."""
    device = torch.device(device)
    step_fn = build_train_step(model, train_cfg)
    pipeline = TokenPipeline(data_cfg)
    gen = torch.Generator(device=device).manual_seed(loop_cfg.seed)
    state = make_train_state(model, gen, train_cfg, device)
    start_step = 0
    ckpt = None
    if loop_cfg.ckpt_dir:
        ckpt = Checkpointer(loop_cfg.ckpt_dir)
        if ckpt.latest_step() is not None:
            state, start_step = ckpt.restore(None, state)
            log(f"[train] resumed from step {start_step}")

    # preemption safety: SIGTERM triggers an emergency checkpoint
    preempted = {"flag": False}

    def _handler(signum, frame):
        preempted["flag"] = True
    prev = signal.signal(signal.SIGTERM, _handler)

    losses = []
    t0 = time.time()
    try:
        for step in range(start_step, loop_cfg.total_steps):
            batch = batch_to_device(pipeline.batch(step), device)
            state, metrics = step_fn(state, batch)
            if step % loop_cfg.log_every == 0 or \
                    step == loop_cfg.total_steps - 1:
                loss = float(metrics["loss"])
                losses.append((step, loss))
                log(f"[train] step {step} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"({time.time() - t0:.1f}s)")
            if ckpt and (step + 1) % loop_cfg.ckpt_every == 0:
                ckpt.save_async(step + 1, state)
            if preempted["flag"]:
                if ckpt:
                    ckpt.wait()
                    ckpt.save(step + 1, state)
                    log(f"[train] preempted: emergency checkpoint @ "
                        f"{step + 1}")
                break
    finally:
        signal.signal(signal.SIGTERM, prev)
        if ckpt:
            ckpt.wait()
    return {"state": state, "losses": losses}


# the reference's name, bound without a second ``def``: the repository's
# static analyzer resolves the reference's calls of it by the function name
# being unique in the corpus
train_loop = run_training
