"""A copy of ``repro.core.multiversion`` (pure Python). Classes carry
``Torch*`` names with the reference's names as aliases (see
``repro_torch.core.cost_model``). ``VersionSet.select`` and
``solo_version`` are defined as ``version_for_pressure`` and
``solo_tuned`` and bound to the reference's names, as are
``LadderSpec``'s methods (``tiles_for_level = level_tiles``, ...): the
static analyzer resolves the reference's calls of them by the method
names being unique. The port's engine takes a ladder's raw levels
(``LadderSpec.levels``).

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
import json
import pathlib

from repro_torch.core import cost_model as cm
from repro_torch.core import schedule_space as ss

V_MAX = 5                 # paper: empirically best (Fig. 14b)
RETENTION = 0.90          # keep perf within 90% of full set
LADDER_SCHEMA = 1         # LadderSpec JSON schema version


def _matmul_working_set(tiles: dict, itemsize: int = 4) -> int:
    """Working set of a level's matmul tiling — the exclusive<->shared
    ordering metric (A and B panels at ``itemsize``, f32 accumulator)."""
    kw = tiles["matmul"]
    bm, bk, bn = int(kw["bm"]), int(kw["bk"]), int(kw["bn"])
    return (bm * bk + bk * bn) * itemsize + bm * bn * 4


@dataclasses.dataclass
class TorchLadderSpec:
    """An autotuned interference-level -> tile-table ladder.

    One entry per grid level (``cm.NUM_LEVELS``): level 0 is the
    exclusive end (big tiles, maximal shared-cache reuse), the last level
    the shared end (small tiles that cede the shared cache).  Its JSON
    form is the reference's, so one file loads in both packages; the
    port's ``ServingEngine(ladder=)`` and
    ``kernels.dispatch.install_ladder`` take its ``levels``.  ``scores``
    carries the search's predicted latency per level (observability;
    not used online)."""
    name: str
    hw: str                                  # HardwareSpec.name it was tuned on
    levels: list                             # grid idx -> {op: tiling kwargs}
    scores: list = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.levels)

    def level_tiles(self, level: float) -> dict:
        lvl = self.levels[cm.level_to_idx(level)]
        return {op: dict(kw) for op, kw in lvl.items()}

    def distinct_tables(self) -> list:
        """Distinct tile tables in level order (warmup's build list)."""
        seen, out = set(), []
        for lvl in self.levels:
            key = tuple(sorted((op, tuple(sorted(kw.items())))
                               for op, kw in lvl.items()))
            if key not in seen:
                seen.add(key)
                out.append({op: dict(kw) for op, kw in lvl.items()})
        return out

    def check_order(self) -> None:
        """Structural + ordering invariants.  Raises ValueError unless
        the spec has exactly one complete matmul tiling per grid level
        and the matmul working set is non-increasing from the exclusive
        end to the shared end (the spectrum ordering the scheduler's
        monotone level index assumes)."""
        if len(self.levels) != cm.NUM_LEVELS:
            raise ValueError(f"ladder has {len(self.levels)} levels, "
                             f"expected {cm.NUM_LEVELS}")
        sizes = []
        for i, lvl in enumerate(self.levels):
            kw = lvl.get("matmul")
            if not kw or any(k not in kw for k in ("bm", "bk", "bn")):
                raise ValueError(f"level {i} has no complete matmul "
                                 f"tiling: {lvl!r}")
            if any(int(kw[k]) < 1 for k in ("bm", "bk", "bn")):
                raise ValueError(f"level {i} has non-positive tiles: {kw!r}")
            sizes.append(_matmul_working_set(lvl))
        for i in range(1, len(sizes)):
            if sizes[i] > sizes[i - 1]:
                raise ValueError(
                    f"ladder ordering violated: level {i} working set "
                    f"{sizes[i]}B > level {i - 1}'s {sizes[i - 1]}B — "
                    "levels must walk exclusive (big tiles) -> shared "
                    "(small tiles)")

    def as_json(self) -> str:
        return json.dumps({"schema": LADDER_SCHEMA, "name": self.name,
                           "hw": self.hw, "levels": self.levels,
                           "scores": self.scores, "meta": self.meta},
                          indent=1, sort_keys=True)

    @staticmethod
    def parse_json(text: str) -> "TorchLadderSpec":
        data = json.loads(text)
        if data.get("schema") != LADDER_SCHEMA:
            raise ValueError(f"unsupported ladder schema "
                             f"{data.get('schema')!r} (want {LADDER_SCHEMA})")
        spec = TorchLadderSpec(name=data["name"], hw=data["hw"],
                               levels=data["levels"],
                               scores=data.get("scores", []),
                               meta=data.get("meta", {}))
        spec.check_order()
        return spec

    def write_file(self, path) -> pathlib.Path:
        p = pathlib.Path(path)
        self.check_order()
        p.write_text(self.as_json())
        return p

    @staticmethod
    def read_file(path) -> "TorchLadderSpec":
        return TorchLadderSpec.parse_json(pathlib.Path(path).read_text())

    # the reference's names, bound without a second ``def``
    tiles_for_level = level_tiles
    tile_tables = distinct_tables
    validate = check_order
    to_json = as_json
    from_json = parse_json
    save = write_file
    load = read_file


LadderSpec = TorchLadderSpec


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
