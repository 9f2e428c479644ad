"""Serving entry point of the port: batched requests through the
ServingEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        [--reduced] [--requests 8] [--prompt-len 16] [--max-new 8] \
        [--slots 4] [--device cpu]

Runs on the card (``--device cuda``, the default) unless ``--device
cpu`` is passed.  Weights are random, drawn from a generator seeded 0;
prompts are ``np.random.default_rng(0)`` draws over the vocabulary (the
reference's recipe, so both packages serve the same prompts).  The
engine is built cold: the time includes each CUDA graph's capture at
its first use.  Prints ``[serve] <name>: a/b requests, N tokens in Xs
(Y tok/s) on <device name>``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.serve runs on cuda, and "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to serve on the CPU")
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    engine = ServingEngine(cfg, params, batch_slots=args.slots,
                           max_len=args.prompt_len + args.max_new + 2,
                           device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = engine.run_to_completion(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else device.type
    print(f"[serve] {cfg.name}: {len(done)}/{args.requests} requests, "
          f"{toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s) on {name}")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.output[:10]}")
    return {"arch": cfg.name, "requests": done, "tokens": toks,
            "seconds": dt, "tokens_per_s": toks / dt, "device": name}


if __name__ == "__main__":
    main()
