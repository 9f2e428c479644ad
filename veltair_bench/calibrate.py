"""Readings that set a cell's correctness limits, on the card.

    python veltair_bench/calibrate.py --workload colo.batch --seeds 101-112 \
        --seconds 8 --out veltair_bench/readings/check.colo.batch.json

One set-up; then for each seed the seed's weights are drawn into the
engines' weight tensors in place (the CUDA graphs stay bound to them),
the seed's traffic is served at the cell's own load for ``--seconds``,
and each tenant's widest logit gap over the check's sample is read, as a
run reads it.  On the first CONTROL_SEEDS seeds the fp8 control is read
on the same sample too, and the control, put in the program's place,
is judged by the configuration's limits as a run judges the program
(``control_passed``, which has to be false).  The lower reading of a
limit is the largest gap of the seeds, the upper the smallest control
gap.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONTROL_SEEDS = 3


def seeds_of(spec: str) -> list[int]:
    if "-" in spec:
        lo, hi = (int(x) for x in spec.split("-"))
        return list(range(lo, hi + 1))
    return [int(x) for x in spec.split(",")]


def reload_weights(system, seed: int) -> None:
    """Draw ``seed``'s weights into the tensors the engines hold."""
    from veltair_bench import weights
    from veltair_bench.system import tenant_seed
    for i, t in enumerate(system.tenants):
        fresh = weights.make(t.ref.layout(t.config), tenant_seed(seed, i),
                             system.device)
        for (_, old), (_, new) in zip(weights.leaves(t.params),
                                      weights.leaves(fresh)):
            old.copy_(new)
    system.sync()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from veltair_bench import cells, correct, traffic
    from veltair_bench.system import System

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload, ROOT)
    seeds = seeds_of(args.seeds)
    system = System(cell.config, seeds[0], "cuda")
    vocab = [(t["model"], t["config"]["vocab_size"])
             for t in cell.config["tenants"]]
    rows = []
    for k, seed in enumerate(seeds):
        reload_weights(system, seed)
        reqs = traffic.generate(cell.traffic, vocab, seed, args.seconds)
        served = system.serve(reqs, seed)
        t0 = time.perf_counter()
        row = {"seed": seed, "requests": len(reqs),
               "failed": sum(1 for r in reqs if r.output is None
                             or len(r.output) != r.out_tokens)}
        judged = {"served": {}, "control": {}}
        for t in system.tenants:
            g = correct.gaps(t, correct.sample(reqs, t.name, seed),
                             system.device, control=k < CONTROL_SEEDS)
            row[t.name] = g
            for side in judged:
                judged[side][t.name] = {"value": g[side], "limit": t.limit}
        row["passed"] = correct.passed(judged["served"]) and not row["failed"]
        if k < CONTROL_SEEDS:
            row["control_passed"] = correct.passed(judged["control"])
        row["reference_s"] = time.perf_counter() - t0
        row["serve_s"] = served.t_close - served.t_open
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = {"workload": args.workload, "seconds": args.seconds,
           "card": torch.cuda.get_device_name(0), "rows": rows}
    for t in system.tenants:
        served = [r[t.name]["served"] for r in rows]
        ctl = [r[t.name]["control"] for r in rows
               if r[t.name]["control"] is not None]
        out[t.name] = {"lower": max(served),
                       "upper": min(ctl) if ctl else None}
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({t.name: out[t.name] for t in system.tenants}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
