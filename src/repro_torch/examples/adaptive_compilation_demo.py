"""Adaptive-compilation demo: the single-pass multi-version compiler.

    PYTHONPATH=src python -m repro_torch.examples.adaptive_compilation_demo \
        [--device cpu]

Enumerates the schedule space for the paper's exemplary conv layer on
``CPU_3990X``, extracts the parallelism-locality Pareto frontier (Alg.
1), and shows how the selected version flips as the interference level
rises — including the kernel-tile override the serving path would
install (clamped as the reference clamps it), cleared at the end.
Host-only: ``--device`` is checked as every example checks it, no
kernel is built and nothing is placed on it.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.paper_suite import conv
from repro_torch.core import cost_model as cm
from repro_torch.core import schedule_space as ss
from repro_torch.core.multiversion import compile_layer, extract_dominant
from repro_torch.examples import checked_device
from repro_torch.kernels import dispatch

LEVELS = (0.0, 0.4, 0.7, 0.9, 1.0)
UNITS = 16
# the override's clamp, the reference's (bm, bk, bn) caps
TILE_CAP = (256, 512, 256)


def frontier_walk() -> dict:
    """Candidates, frontier, the retained versions and, per level, the
    selected tile, its latency and the override installed."""
    hw = cm.CPU_3990X
    layer = conv("resnet_14x14_256", 14, 256, 256, k=3)
    candidates = ss.enumerate_versions(layer, hw)
    frontier = extract_dominant(candidates)
    print(f"layer {layer.name}: {len(candidates)} candidates, "
          f"{len(frontier)} on the parallelism-locality frontier")
    vset = compile_layer(layer, hw, qos_budget_s=1e-3)
    print(f"retained {len(vset.versions)} versions "
          f"(paper: <=5, >80% of layers need <=3):")
    for i, v in enumerate(vset.versions):
        print(f"  v{i}: tile=({v.bm},{v.bk},{v.bn}) unroll={v.unroll} "
              f"parallelism={v.parallelism} "
              f"tile_bytes={v.tile_bytes/1e3:.0f}KB")

    print(f"\nselection vs interference level ({UNITS} cores):")
    selected, overrides = [], []
    for lvl in LEVELS:
        itf = cm.level_interference(lvl)
        v = vset.select(itf)
        lat = cm.latency(hw, v, UNITS, itf)
        print(f"  level={lvl:.1f} -> tile=({v.bm},{v.bk},{v.bn}) "
              f"lat={lat*1e6:.0f}us")
        # the hook the serving engine uses: install the selected
        # version's tile as the kernel override — the whole-table
        # installer swaps atomically
        tiles = {"matmul": {"bm": min(v.bm, TILE_CAP[0]),
                            "bk": min(v.bk, TILE_CAP[1]),
                            "bn": min(v.bn, TILE_CAP[2])}}
        dispatch.install_tile_overrides(tiles)
        overrides.append(dispatch.tile_overrides("matmul"))
        selected.append({"level": lvl, "tile": (v.bm, v.bk, v.bn),
                         "latency_s": lat})
    dispatch.clear_tile_overrides()
    return {"candidates": len(candidates), "frontier": len(frontier),
            "versions": [(v.bm, v.bk, v.bn) for v in vset.versions],
            "selected": selected, "overrides": overrides}


def adaptive_main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    checked_device("adaptive_compilation_demo", args.device)
    return frontier_walk()


# the reference example's name, bound without a second ``def`` (``main``
# is defined in ``src/`` already)
main = adaptive_main


if __name__ == "__main__":
    main()
