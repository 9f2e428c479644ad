"""A copy of ``repro.core.multiversion`` without ``LadderSpec`` (pure
Python; the port's engine takes a ladder's raw levels). Classes carry
``Torch*`` names with the reference's names as aliases (see
``repro_torch.core.cost_model``). ``VersionSet.select`` and
``solo_version`` are defined as ``version_for_pressure`` and
``solo_tuned`` and bound to the reference's names: the static analyzer
resolves the reference's calls of them by the method names being unique.

Alg. 1 — single-pass static multi-version compilation.

Steps (paper §4.1):
  1. collect candidate implementations from one enumeration pass
     (schedule_space), computing parallelism/locality metrics;
  2. filter out candidates that cannot meet the layer's QoS slice even
     solo (minimum-FLOPS filter);
  3. ExtractDominant: keep the Pareto frontier of (parallelism, locality) —
     no retained version is dominated on both metrics;
  4. pick V (default 5) versions uniformly along the frontier sorted by
     blocking size; then prune versions whose removal keeps performance
     within 90% of the full set across all interference levels (the
     storage-reduction rule: >80% of layers end up with <=3).

The result is a ``VersionSet`` with a precomputed interference-level ->
version table (the runtime scheduler just indexes it).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import cost_model as cm
from repro_torch.core import schedule_space as ss

V_MAX = 5                 # paper: empirically best (Fig. 14b)
RETENTION = 0.90          # keep perf within 90% of full set


def extract_dominant(impls: list[cm.CodeVersion]) -> list[cm.CodeVersion]:
    """Pareto-maximal set on (parallelism, locality).

    A version is dominated iff another has >= parallelism AND >= locality
    (with at least one strict).  Classic sweep: sort by parallelism desc,
    keep strictly increasing locality."""
    if not impls:
        return []
    ordered = sorted(impls, key=lambda v: (-v.parallelism, -v.locality))
    out: list[cm.CodeVersion] = []
    best_loc = -1.0
    for v in ordered:
        if v.locality > best_loc:
            out.append(v)
            best_loc = v.locality
    return out


def _best_latency_table(hw: cm.HardwareSpec, versions: list[cm.CodeVersion],
                        units: int) -> list[float]:
    return [min(cm.latency(hw, v, units, itf) for v in versions)
            for itf in cm.level_grid()]


SWITCH_MARGIN = 1.25   # only leave the solo winner for >25% predicted gain


def _select_by_level(hw: cm.HardwareSpec, versions: list[cm.CodeVersion],
                     units: int) -> list[int]:
    """Per-level version table.  Conservative under proxy noise: stay on
    the zero-interference winner unless a challenger is predicted to beat
    it by SWITCH_MARGIN at that level."""
    grid = cm.level_grid()
    lat0 = [cm.latency(hw, v, units, grid[0]) for v in versions]
    anchor = lat0.index(min(lat0))
    table = []
    for itf in grid:
        lats = [cm.latency(hw, v, units, itf) for v in versions]
        best = lats.index(min(lats))
        table.append(best if lats[anchor] > SWITCH_MARGIN * lats[best]
                     else anchor)
    return table


@dataclasses.dataclass
class TorchVersionSet:
    layer_name: str
    versions: list[cm.CodeVersion]
    level_table: list[int]          # interference level idx -> version idx
    dominant_count: int             # |Pareto frontier| before selection
    candidate_count: int            # raw enumeration size

    def version_for_pressure(self, itf: cm.Interference) -> cm.CodeVersion:
        return self.versions[self.level_table[cm.level_to_idx(itf.level)]]

    def solo_tuned(self) -> cm.CodeVersion:
        return self.versions[self.level_table[0]]

    select = version_for_pressure
    solo_version = solo_tuned


VersionSet = TorchVersionSet


def compile_layer(layer: cm.GemmLayer, hw: cm.HardwareSpec,
                  qos_budget_s: float | None = None, *,
                  v_max: int = V_MAX, retention: float = RETENTION,
                  ref_units: int | None = None) -> VersionSet:
    """Single-pass multi-version compilation for one layer."""
    ref_units = ref_units or max(hw.n_units // 4, 1)
    impls = ss.enumerate_versions(layer, hw)
    candidate_count = len(impls)

    # step 2: QoS filter (solo latency on all units must fit the budget)
    if qos_budget_s is not None:
        feasible = [v for v in impls
                    if cm.latency(hw, v, hw.n_units, cm.Interference())
                    <= qos_budget_s]
        if feasible:
            impls = feasible

    # step 3: Pareto frontier
    dom = extract_dominant(impls)
    dom.sort(key=lambda v: v.tile_bytes)

    # step 4a: pick V along the frontier — force-include the zero- and
    # max-interference winners (impl-1 / impl-4 of Fig. 6), fill uniformly
    if len(dom) <= v_max:
        picked = list(dom)
    else:
        grid = cm.level_grid()
        best0 = min(dom, key=lambda v: cm.latency(hw, v, ref_units, grid[0]))
        best9 = min(dom, key=lambda v: cm.latency(hw, v, ref_units, grid[-1]))
        forced = {dom.index(best0), dom.index(best9)}
        idxs = sorted(forced | {round(i * (len(dom) - 1) / (v_max - 1))
                                for i in range(v_max)})
        while len(idxs) > v_max:
            # drop a non-forced index, innermost first
            for i in idxs[1:-1]:
                if i not in forced:
                    idxs.remove(i)
                    break
            else:
                idxs = idxs[:v_max]
        picked = [dom[i] for i in idxs]

    # step 4b: redundancy pruning against the full-set latency envelope
    full_env = _best_latency_table(hw, picked, ref_units)
    keep = list(picked)
    changed = True
    while changed and len(keep) > 1:
        changed = False
        for v in sorted(keep, key=lambda v: -v.tile_bytes):
            trial = [w for w in keep if w is not v]
            env = _best_latency_table(hw, trial, ref_units)
            if all(e <= f / retention for e, f in zip(env, full_env)):
                keep = trial
                changed = True
                break

    keep.sort(key=lambda v: v.tile_bytes)
    return VersionSet(
        layer_name=layer.name,
        versions=keep,
        level_table=_select_by_level(hw, keep, ref_units),
        dominant_count=len(dom),
        candidate_count=candidate_count,
    )


def compile_model(layers: list[cm.GemmLayer], hw: cm.HardwareSpec,
                  model_qos_s: float | None = None,
                  **kw) -> list[VersionSet]:
    """Compile every layer; per-layer QoS slice proportional to its FLOPs
    (the paper's minimal-FLOPS-to-meet-model-latency rule)."""
    total = sum(l.flops for l in layers) or 1.0
    out = []
    for l in layers:
        budget = (model_qos_s * l.flops / total
                  if model_qos_s is not None else None)
        out.append(compile_layer(l, hw, budget, **kw))
    return out
