"""Training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch gemma-2b --steps 100 [--reduced] [--device cpu]

Runs on the card (``--device cuda``, the default) unless ``--device
cpu`` is passed; ``--reduced`` trains the config's reduced copy (few
layers, narrow widths, tiny vocab).  Prints ``[train] <arch>: loss a ->
b on <device name>``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data import DataConfig
from repro_torch.models.model import Model
from repro_torch.training import OptimizerConfig, TrainConfig
from repro_torch.training.train_loop import LoopConfig, train_loop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--schedule", default="wsd")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.train runs on cuda, and "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to train on the CPU")
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    model = Model(cfg)
    tc = TrainConfig(
        optimizer=OptimizerConfig(name=args.optimizer, lr=args.lr,
                                  schedule=args.schedule,
                                  warmup_steps=max(args.steps // 10, 1),
                                  total_steps=args.steps),
        accum_steps=args.accum)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.global_batch)
    lc = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every)
    out = train_loop(model, tc, dc, lc, device=device)
    first, last = out["losses"][0][1], out["losses"][-1][1]
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else device.type
    print(f"[train] {cfg.name}: loss {first:.3f} -> {last:.3f} on {name}")
    return out


if __name__ == "__main__":
    main()
