"""What the harness and the reference load, in fresh processes: no module
whose top-level name (compared whole) is JAX's or the JAX package's
``repro``; and the reference loads nothing of the program either.  The
command itself refuses to run without a card or without the program
beside it."""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

from veltair_bench import cells

ROOT = cells.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def loaded_after(code: str) -> set[str]:
    env = dict(os.environ, PYTHONPATH=f"{ROOT}:{ROOT / 'src'}")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_loads_neither_jax_nor_the_jax_package():
    tops = loaded_after(
        "import veltair_bench.run, veltair_bench.harness, "
        "veltair_bench.calibrate\n"
        "from veltair_bench import references, cells\n"
        "[references.load(t['reference']) for w in "
        "cells.benchmark()['workloads'] "
        "for t in cells.load(w['name']).config['tenants']]\n"
        "import repro_torch.serving.cluster, repro_torch.core.scheduler")
    assert "repro_torch" in tops          # the program is what runs
    assert not tops & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    tops = loaded_after(
        "from veltair_bench.references import starcoder2, mamba2\n"
        "from veltair_bench import correct, weights")
    assert not tops & (FORBIDDEN | {"repro_torch"})


def _run_py(cwd: pathlib.Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "veltair_bench/run.py", "--workload", "colo.batch",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_run_refuses_without_a_card():
    out = _run_py(ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_run_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "veltair_bench", tmp_path / "veltair_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
