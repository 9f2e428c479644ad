"""Finds a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix, and the readers of the per-layer
metrics that list it.  Adding a cell, a configuration, a mix or a metric
adds files and entries; nothing here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict                 # configs/<config>.json
    traffic: dict                # traffic/<traffic>.json
    end_to_end: list[dict]       # the BENCHMARK.json entries it reports
    per_layer: list[dict]


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``, or, where a
    metric ``<base>.<kind>`` (one quantity split by the cells that read
    it) has no file of its own, of ``metrics/<base>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = HERE / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"veltair_bench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
