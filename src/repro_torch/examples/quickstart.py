"""Quickstart: serve a small model with batched requests (end-to-end).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds a reduced gemma-2b, admits a handful of prompts through the
continuous-batching engine, and greedily decodes — the serving path the
paper's system schedules.  A second pass serves the same prompts
speculatively (draft -> batched verify -> rollback) and checks the
streams are token-identical.  Runs on the card unless ``--device cpu``
is passed.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.examples import example_device, seeded_params
from repro_torch.serving.engine import Request, ServingEngine

N_REQUESTS, PROMPT_LEN, MAX_NEW = 8, 16, 12
SLOTS, MAX_LEN = 4, 48


def quickstart_requests(cfg, rng) -> list[Request]:
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        PROMPT_LEN).astype(np.int32),
                    max_new_tokens=MAX_NEW)
            for i in range(N_REQUESTS)]


def serve_requests(engine, requests) -> float:
    """Admit with drain=True (queue + pump prefill until first token),
    then drain decode through fused quanta at the largest bucket."""
    pending = list(requests)
    t0 = time.time()
    while pending and engine.admit_request(pending[0], drain=True):
        pending.pop(0)
    while pending or not all(r.done for r in requests):
        engine.step_quantum(engine.quantum_buckets[-1])
        while pending and engine.admit_request(pending[0], drain=True):
            pending.pop(0)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return time.time() - t0


def quickstart_passes(cfg, params, device) -> dict:
    """The plain pass, then the speculative pass over the same prompts
    (``np.random.default_rng(0)`` draws), each on an engine of its own."""
    engine = ServingEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
                           device=device)
    requests = quickstart_requests(cfg, np.random.default_rng(0))
    dt = serve_requests(engine, requests)
    spec = ServingEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
                         speculative=True, device=device)
    spec_reqs = quickstart_requests(cfg, np.random.default_rng(0))
    spec_dt = serve_requests(spec, spec_reqs)
    tokens = sum(len(r.output) for r in requests)
    return {"requests": requests, "spec_requests": spec_reqs,
            "tokens": tokens, "seconds": dt, "tokens_per_s": tokens / dt,
            "spec_seconds": spec_dt,
            "identical": ([r.output for r in spec_reqs]
                          == [r.output for r in requests]),
            "spec_stats": dict(spec.spec_stats)}


def quickstart_main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = example_device("quickstart", args.device)
    cfg = get_reduced_config("gemma-2b")
    out = quickstart_passes(cfg, seeded_params(cfg, dev), dev)
    requests = out["requests"]
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"served {len(requests)} requests, {out['tokens']} tokens "
          f"in {out['seconds']:.2f}s ({out['tokens_per_s']:.1f} tok/s on "
          f"{where})")
    for r in requests[:3]:
        print(f"  req {r.rid}: prompt[:5]={r.prompt[:5].tolist()} "
              f"-> output={r.output}")
    s = out["spec_stats"]
    print(f"speculative: token-identical={out['identical']}, "
          f"{s['spec_quanta']} spec quanta, "
          f"{s['tokens_accepted']}/{s['tokens_drafted']} drafts accepted "
          f"(hit rate {s['draft_hit_rate']:.0%}, "
          f"{s['spec_rollbacks']} rollbacks)")
    assert out["identical"], "speculation must never change the tokens"
    return out


# the reference example's names, bound without a second ``def`` (the
# static analyzers resolve some calls by a function name being unique
# over ``src/``: ``serve`` and ``main`` are defined there already)
make_requests = quickstart_requests
serve = serve_requests
main = quickstart_main


if __name__ == "__main__":
    main()
