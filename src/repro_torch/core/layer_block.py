"""A copy of ``repro.core.layer_block`` (pure Python). Classes carry
``Torch*`` names with the reference's names as aliases (see
``repro_torch.core.cost_model``).

Alg. 2 — dynamic-threshold layer-block formation.

A layer whose unit requirement exceeds ``Avg_C + thres`` is a *splitting
pivot*: it starts a new block.  Each block's unit budget is then
recalculated so the whole block meets the sum of its layers' QoS slices
using at most ``Avg_C + thres`` units — high-demand layers borrow time from
their cheap neighbours instead of spiking the allocation (paper Fig. 10a).

Consumers: the simulator executes blocks in analytic time; the
co-location cluster (``repro.serving.cluster``) reuses the same
formation on the real path — a block's layer count becomes an engine's
dispatch quantum (decode steps between scheduling interventions) and its
unit requirement the engine's pool share, so scheduling granularity
adapts to pressure exactly as Alg. 2 prescribes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import cost_model as cm
from repro_torch.core.multiversion import VersionSet


@dataclasses.dataclass
class TorchLayerBlock:
    start: int                      # layer index range [start, end)
    end: int
    units: int                      # recalculated block requirement
    budget_s: float                 # sum of member QoS slices
    versions: list[cm.CodeVersion]  # chosen implementation per member layer

    @property
    def n_layers(self) -> int:
        return self.end - self.start

    def latency(self, hw: cm.HardwareSpec, units: int,
                itf: cm.Interference) -> float:
        return sum(cm.latency(hw, v, units, itf) for v in self.versions)


LayerBlock = TorchLayerBlock


@dataclasses.dataclass
class TorchModelPlan:
    """Per-model compile-time artifacts the scheduler works from."""
    name: str
    layers: list[cm.GemmLayer]
    version_sets: list[VersionSet]
    qos_s: float
    budgets: list[float]            # per-layer QoS slice
    avg_units: int                  # Avg_C: mean per-layer requirement (§4.2)
    layer_units: list[int]          # layer-wise minimal units (solo, itf=0)
    fcfs_units: int = 0             # model-wise FCFS provisioning (knee)

    @property
    def n_layers(self) -> int:
        return len(self.layers)


ModelPlan = TorchModelPlan


def make_model_plan(name: str, layers: list[cm.GemmLayer],
                    version_sets: list[VersionSet], qos_s: float,
                    hw: cm.HardwareSpec) -> ModelPlan:
    itf0 = cm.Interference()
    # Per-layer QoS slice proportional to the layer's *full-machine* latency
    # (the paper's minimal-FLOPS rule, made overhead-aware so tiny layers
    # keep launch-cost slack).  Layers that scale poorly demand many units
    # to hit their slice — these are Fig. 4b's conflict-prone spikes.
    ref = [cm.latency(hw, vs.solo_version(), hw.n_units, itf0)
           for vs in version_sets]
    total = sum(ref) or 1.0
    budgets = [qos_s * r / total for r in ref]
    layer_units = [
        cm.units_required(hw, vs.solo_version(), b, itf0)
        for vs, b in zip(version_sets, budgets)]
    # Avg_C (§4.2): the model's averaged per-layer core requirement
    avg_units = max(1, round(sum(min(u, hw.n_units) for u in layer_units)
                             / len(layer_units)))
    # Model-wise FCFS provisions for comfortable-margin latency (~60% of
    # QoS, the paper's Fig. 3b low-load operating point) — the
    # over-allocation VELTAIR's finer granularity recovers (Fig. 4b's
    # black line vs the red shadowed area).
    fcfs_units = _model_granularity_units(hw, version_sets, 0.6 * qos_s,
                                          itf0)
    return ModelPlan(name=name, layers=layers, version_sets=version_sets,
                     qos_s=qos_s, budgets=budgets, avg_units=avg_units,
                     layer_units=layer_units, fcfs_units=fcfs_units)


def _model_granularity_units(hw: cm.HardwareSpec,
                             version_sets: list[VersionSet], qos_s: float,
                             itf: cm.Interference) -> int:
    """Minimal uniform unit count for the whole model to meet QoS."""
    lo, hi = 1, hw.n_units
    def total(u):
        return sum(cm.latency(hw, vs.solo_version(), u, itf)
                   for vs in version_sets)
    if total(hi) > qos_s:
        return hw.n_units
    while lo < hi:
        mid = (lo + hi) // 2
        if total(mid) <= qos_s:
            hi = mid
        else:
            lo = mid + 1
    return lo


_REQ_CACHE: dict = {}


def layer_requirements(plan: ModelPlan, hw: cm.HardwareSpec,
                       itf: cm.Interference, *,
                       adaptive_compile: bool = True) -> tuple[
                           list[int], list[cm.CodeVersion]]:
    """Per-layer unit requirement + chosen version at pressure ``itf``.

    Memoized on the quantized pressure level (10-level grid, like the
    paper's discrete interference levels) — the simulator calls this at
    every block boundary."""
    key = (plan.name, hw.name, round(itf.cache, 1), round(itf.bw, 1),
           round(itf.ici, 1), adaptive_compile)
    hit = _REQ_CACHE.get(key)
    if hit is not None:
        return hit
    units, versions = [], []
    for vs, budget in zip(plan.version_sets, plan.budgets):
        v = vs.select(itf) if adaptive_compile else vs.solo_version()
        versions.append(v)
        units.append(cm.units_required(hw, v, budget, itf))
    _REQ_CACHE[key] = (units, versions)
    return units, versions


def finding_first_pivot(reqs: list[int], avg_c: int, thres: float,
                        start: int) -> int:
    """Alg. 2 Finding1stPivot: first layer (after start) whose requirement
    exceeds Avg_C + thres; returns len(reqs) if none."""
    for i in range(start + 1, len(reqs)):
        if reqs[i] >= avg_c + thres:
            return i
    return len(reqs)


_KNEE_CACHE: dict = {}


def versions_knee(hw: cm.HardwareSpec, versions: list[cm.CodeVersion],
                  slack: float = 1.30) -> int:
    """Smallest unit count within ``slack`` of the full-machine latency for
    this version list — the work-conserving 'grab cores while idle' target
    (paper: 'each layer can use as many cores as possible when load is
    low')."""
    key = (hw.name, tuple(v.layer_name for v in versions),
           tuple(v.key() for v in versions))
    hit = _KNEE_CACHE.get(key)
    if hit is not None:
        return hit
    itf = cm.Interference()
    full = sum(cm.latency(hw, v, hw.n_units, itf) for v in versions)
    lo, hi = 1, hw.n_units
    while lo < hi:
        mid = (lo + hi) // 2
        if sum(cm.latency(hw, v, mid, itf) for v in versions) \
                <= slack * full:
            hi = mid
        else:
            lo = mid + 1
    _KNEE_CACHE[key] = lo
    return lo


def _block_units(hw: cm.HardwareSpec, versions: list[cm.CodeVersion],
                 budget_s: float, itf: cm.Interference, cap: int) -> int:
    """Minimal units for the block to meet its summed budget (<= cap)."""
    lo, hi = 1, max(cap, 1)
    def lat(u):
        return sum(cm.latency(hw, v, u, itf) for v in versions)
    if lat(hi) > budget_s:
        return hi                     # best effort at the cap
    while lo < hi:
        mid = (lo + hi) // 2
        if lat(mid) <= budget_s:
            hi = mid
        else:
            lo = mid + 1
    return lo


def next_block(plan: ModelPlan, begin: int, hw: cm.HardwareSpec,
               itf: cm.Interference, thres: float, *,
               adaptive_compile: bool = True) -> LayerBlock:
    """Form the next layer-block starting at ``begin`` (runtime use).

    Versions are selected at the full predicted pressure (that is what the
    multi-version tables are for); unit *requirements* are provisioned at
    zero pressure — under fair-share contention extra units cannot buy
    back shared-bandwidth time, so inflating allocations with the
    interference level only raises the conflict rate (validated in
    EXPERIMENTS.md §Simulator-calibration)."""
    reqs, versions = layer_requirements(plan, hw, itf,
                                        adaptive_compile=adaptive_compile)
    itf0 = cm.Interference()
    reqs0, _ = layer_requirements(plan, hw, itf0,
                                  adaptive_compile=adaptive_compile)
    end = finding_first_pivot(reqs0, plan.avg_units, thres, begin)
    end = max(end, begin + 1)
    budget = sum(plan.budgets[begin:end])
    cap = min(int(plan.avg_units + thres) if thres < hw.n_units
              else hw.n_units, hw.n_units)
    cap = max(cap, 1)
    vset = versions[begin:end]
    units = _block_units(hw, vset, budget, itf0, cap)
    return LayerBlock(start=begin, end=end, units=units, budget_s=budget,
                      versions=vset)


def form_blocks(plan: ModelPlan, hw: cm.HardwareSpec, itf: cm.Interference,
                thres: float, *, adaptive_compile: bool = True,
                ) -> list[LayerBlock]:
    """Full static partition (offline analysis / Fig. 10 reproduction)."""
    out = []
    begin = 0
    while begin < plan.n_layers:
        blk = next_block(plan, begin, hw, itf, thres,
                         adaptive_compile=adaptive_compile)
        out.append(blk)
        begin = blk.end
    return out
