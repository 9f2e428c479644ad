"""Train a reduced LM for a few hundred steps (WSD schedule, checkpoints).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] \
        [--arch minicpm-2b] [--device cpu]

Runs on the card unless ``--device cpu`` is passed: WSD at lr 2e-3,
two microbatches a step, batches of 8 x 64 tokens, a checkpoint every 50
steps into a temporary directory, through the port's ``run_training``.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import get_reduced_config
from repro_torch.data import DataConfig
from repro_torch.examples import example_device
from repro_torch.models import build_model, param_count
from repro_torch.training import OptimizerConfig, TrainConfig
from repro_torch.training.train_loop import LoopConfig, run_training

LR, ACCUM, SEQ_LEN, GLOBAL_BATCH = 2e-3, 2, 64, 8
CKPT_EVERY, LOG_EVERY = 50, 20


def train_reduced_lm(cfg, steps: int, device) -> dict:
    """``steps`` steps of ``cfg`` on ``device`` from the loop's seeded
    state; -> run_training's {"state", "losses"}."""
    model = build_model(cfg)
    print(f"training {cfg.name}: {param_count(model.param_specs()):,} params")
    tc = TrainConfig(
        optimizer=OptimizerConfig(lr=LR, schedule="wsd",
                                  warmup_steps=steps // 10,
                                  total_steps=steps),
        accum_steps=ACCUM)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ_LEN,
                    global_batch=GLOBAL_BATCH)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        out = run_training(model, tc, dc,
                           LoopConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                                      ckpt_every=CKPT_EVERY,
                                      log_every=LOG_EVERY),
                           device=device)
    first, last = out["losses"][0][1], out["losses"][-1][1]
    print(f"loss {first:.3f} -> {last:.3f} over {steps} steps")
    return out


def train_lm_main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = example_device("train_lm", args.device)
    return train_reduced_lm(get_reduced_config(args.arch), args.steps, dev)


# the reference example's name, bound without a second ``def`` (``main``
# is defined in ``src/`` already)
main = train_lm_main


if __name__ == "__main__":
    main()
