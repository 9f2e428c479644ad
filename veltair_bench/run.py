"""Run one cell of the benchmark once and print its result line.

    python veltair_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card.  The
system under test is the PyTorch and CUDA port (``src/repro_torch``);
the cell's configuration, traffic mix and per-layer metrics are found by
name from ``BENCHMARK.json`` and the files under ``veltair_bench/``.
With ``--trace 0`` the last line of standard output holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from
a profiled slice of the window.  The numbers the correctness check
compared close standard error and the result line.  Exit codes: 0 a
result was printed; 2 no card, too few cards, or no program beside the
benchmark; 3 the JAX package or JAX was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from veltair_bench import cells, harness

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("no program: src/repro_torch is missing beside the benchmark",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_build
    # the program's kernel libraries build once per checkout, here
    cuda_build.BUILD_DIR = ROOT / "build" / "repro_torch"
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    cell = cells.load(args.workload, ROOT)
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, checks, peak, summary, notes = harness.execute(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {bad}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": cell.chips, "memory_peak_bytes": peak}
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    print("serve: " + ", ".join(f"{k} {v}" for k, v in notes.items()),
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
