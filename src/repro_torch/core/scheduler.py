"""A copy of ``repro.core.scheduler`` (pure Python and numpy). Classes
carry ``Torch*`` names with the reference's names as aliases (see
``repro_torch.core.cost_model``).

Alg. 3 — the VELTAIR runtime scheduler, plus the policy interface the
discrete-event simulator drives.

A policy is asked, at admission and at every block boundary, to plan the
next chunk of a task: which layers, how many units, which code versions.
VELTAIR's policy implements the paper's loop:

    i     <- proxy-predicted system interference (excl. soon-to-finish)
    thres <- (C_total - sum of active models' Avg_C) distributed
             proportionally to each model's Avg_C
    pivot <- Finding1stPivot(remaining layers, impls_i, thres)
    execute layers[begin:pivot] with the interference-matched versions

Ablations: VELTAIR-AS (adaptive scheduling only: blocks formed dynamically
but solo-tuned code), VELTAIR-AC (adaptive compilation only: layer-wise
scheduling with interference-matched versions), VELTAIR-FULL (both).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core import layer_block as lb
from repro_torch.core.interference import (CounterSample, LinearProxy,
                                     RunningDemand, calibrate_proxy,
                                     read_counters)


@dataclasses.dataclass
class TorchChunkPlan:
    end_layer: int
    units: int                    # desired (work-conserving) allocation
    versions: list[cm.CodeVersion]
    budget_s: float
    units_min: int = 0            # QoS-required minimum (conflict threshold)
    exclusive: bool = False       # temporal policies: need the whole machine
    allow_partial: bool = True    # start with fewer units + realloc overhead

    def __post_init__(self):
        if self.units_min <= 0:
            self.units_min = self.units


ChunkPlan = TorchChunkPlan


@dataclasses.dataclass
class TorchTaskState:
    tid: int
    tenant: str
    plan: lb.ModelPlan
    arrival: float
    priority: float = 0.0
    next_layer: int = 0
    tier: str | None = None          # SLO tier label (core.qos.TIER_ORDER)
    deadline: float | None = None    # absolute tier-scaled deadline; None
                                     # falls back to arrival + qos_s

    @property
    def done(self) -> bool:
        return self.next_layer >= self.plan.n_layers

    def remaining_budget(self, now: float) -> float:
        if self.deadline is not None:
            return self.deadline - now
        return (self.arrival + self.plan.qos_s) - now


TaskState = TorchTaskState


class TorchPolicy:
    """Scheduling-policy interface, driven from three call sites:

    * the discrete-event simulator calls :meth:`plan_chunk` at admission
      and at every block boundary (oracle co-runner demands in hand);
    * the online runtimes (``repro.serving.runtime`` /
      ``repro.serving.cluster``) poll performance counters and call
      :meth:`level_from_counters` / :meth:`plan_chunk_at` — the policy
      never sees ground-truth pressure there, only the counter sample;
    * both ask :meth:`order_pending` for the dispatch order.
    """
    name = "base"
    strict_fcfs = False

    def __init__(self, hw: cm.HardwareSpec):
        self.hw = hw

    def plan_chunk(self, task: TaskState, active: list[TaskState],
                   demands: list[RunningDemand], now: float,
                   free_units: int) -> Optional[ChunkPlan]:
        raise NotImplementedError

    def plan_chunk_at(self, task: TaskState, active: list[TaskState],
                      itf: cm.Interference, now: float,
                      free_units: int) -> Optional[ChunkPlan]:
        """Plan the next chunk given an already-estimated pressure ``itf``
        (the online cluster path: counters -> proxy -> itf -> plan).
        Static baselines ignore pressure, so the default just forwards to
        :meth:`plan_chunk` with no demand list."""
        return self.plan_chunk(task, active, [], now, free_units)

    def order_pending(self, pending: list[TaskState],
                      now: float) -> list[TaskState]:
        """Dispatch order for waiting tasks (default: FCFS by arrival)."""
        return sorted(pending, key=lambda t: t.arrival)

    def order_by_slack(self, pending: list[TaskState],
                       now: float) -> list[TaskState]:
        """Earliest-deadline order (least remaining budget first) — the
        SLO-tiered runtimes use this when tasks carry tier deadlines;
        ties break FCFS so untiered tasks degrade to arrival order."""
        return sorted(pending,
                      key=lambda t: (t.remaining_budget(now), t.arrival,
                                     t.tid))

    def interference_from_counters(self,
                                   sample: CounterSample) -> cm.Interference:
        """Pressure estimate from one performance-counter read.  Static
        baselines do not sense pressure at all."""
        return cm.Interference()

    def level_from_counters(self, sample: CounterSample) -> float:
        """Interference level the serving engine should compile for, given
        a live counter sample (the online runtimes call this every
        scheduling quantum).  Baselines without adaptive compilation pin
        the solo-tuned code version (level 0)."""
        return 0.0

    def online_level(self, demands: list[RunningDemand],
                     now: float) -> float:
        """Interference level from oracle demand sums (legacy hook, kept
        for direct policy probing in tests; the runtimes now synthesize a
        :class:`~repro.core.interference.CounterSample` and use
        :meth:`level_from_counters` instead).  Static baselines never
        leave the solo-tuned code version."""
        return 0.0

    def observe_counters(self, sample: CounterSample,
                         target: cm.Interference) -> None:
        """Feed one (counter sample, realized pressure) pair back into the
        policy's pressure estimator — the online re-fit hook the runtimes
        call when serving with measured counters.  ``target`` is the
        pressure the sample is later known to correspond to (oracle truth
        where available, else the counter bank's slowdown-derived
        estimate).  Baselines have no estimator; no-op."""
        return None

    @property
    def proxy_rms_error(self) -> float:
        """Sliding-window RMS residual of the policy's pressure proxy
        (NaN for policies without one / before any observation)."""
        return float("nan")

    @property
    def proxy_refits(self) -> int:
        """Drift-triggered proxy refits so far (0 without an estimator)."""
        return 0


Policy = TorchPolicy


class TorchVeltairPolicy(Policy):
    """The full adaptive compiler+scheduler (paper Alg. 3).

    Reproduces: VELTAIR-FULL, plus its two ablations — VELTAIR-AS
    (``adaptive_compile=False``: dynamic layer-blocks, solo-tuned code)
    and VELTAIR-AC (``adaptive_schedule=False``: layer-wise dispatch,
    interference-matched code versions).

    Decision inputs: the proxy-predicted interference (performance
    counters through :class:`~repro.core.interference.LinearProxy` —
    never the oracle pressure), the dynamic threshold from the active
    tenants' ``Avg_C``, and the per-model multi-version tables."""

    def __init__(self, hw: cm.HardwareSpec, *, adaptive_schedule: bool = True,
                 adaptive_compile: bool = True, proxy: LinearProxy | None = None,
                 seed: int = 0):
        super().__init__(hw)
        self.adaptive_schedule = adaptive_schedule
        self.adaptive_compile = adaptive_compile
        self.proxy = proxy or calibrate_proxy(hw)[0]
        self.rng = np.random.default_rng(seed)
        self.name = ("veltair-full" if adaptive_schedule and adaptive_compile
                     else "veltair-as" if adaptive_schedule
                     else "veltair-ac")

    def _predicted_itf(self, task: TaskState, demands: list[RunningDemand],
                       now: float) -> cm.Interference:
        return self._predict_pressure(task.tid, demands, now)

    def _predict_pressure(self, tid: int, demands: list[RunningDemand],
                          now: float) -> cm.Interference:
        sample = read_counters(self.hw, tid, demands, now, self.rng)
        if self.hw.cache_shared:
            return self.interference_from_counters(sample)
        # TPU platform simulator path: the link-pressure registers are not
        # part of the synthesized counter vector, so the simulator charges
        # the realized ICI pressure directly (the bw/cache estimate still
        # goes through the proxy like the CPU platform)
        pred = self.interference_from_counters(sample)
        return cm.Interference(cache=0.0, bw=pred.bw,
                               ici=min(sample.truth.ici, 4.0))

    def interference_from_counters(self, sample):
        pred = self.proxy.predict_interference(
            np.asarray(sample.values)[:2])
        if self.hw.cache_shared:
            return pred
        # no shared cache on the TPU platform: only the bandwidth estimate
        # is meaningful (the proxy reads bandwidth-pressure registers of
        # the same linear structure)
        return cm.Interference(cache=0.0, bw=pred.bw, ici=0.0)

    def level_from_counters(self, sample):
        if not self.adaptive_compile:
            return 0.0        # VELTAIR-AS serves the solo-tuned version
        return self.interference_from_counters(sample).level

    def online_level(self, demands, now):
        if not self.adaptive_compile:
            return 0.0        # VELTAIR-AS serves the solo-tuned version
        # tid=-1 matches no running demand, so the proxy sees the full
        # co-runner pressure — the engine itself is the "victim"
        return self._predict_pressure(-1, demands, now).level

    def observe_counters(self, sample, target):
        self.proxy.rls_update(np.asarray(sample.values)[:2], target)

    @property
    def proxy_rms_error(self):
        return self.proxy.rms_error

    @property
    def proxy_refits(self):
        return self.proxy.refit_count

    def _threshold(self, task: TaskState, active: list[TaskState]) -> float:
        total_avg = sum(t.plan.avg_units for t in active) or 1
        idle = self.hw.n_units - total_avg
        if idle <= 0:
            return 0.0
        return idle * task.plan.avg_units / total_avg

    def plan_chunk(self, task, active, demands, now, free_units):
        itf = self._predicted_itf(task, demands, now)
        return self.plan_chunk_at(task, active, itf, now, free_units)

    def plan_chunk_at(self, task, active, itf, now, free_units):
        if self.adaptive_schedule:
            thres = self._threshold(task, active)
            blk = lb.next_block(task.plan, task.next_layer, self.hw, itf,
                                thres, adaptive_compile=self.adaptive_compile)
            # work-conserving: up to the knee while idle, but never past
            # Avg_C + thres (the dynamic cap that keeps conflicts low)
            cap = max(int(task.plan.avg_units + thres), blk.units)
            knee = lb.versions_knee(self.hw, blk.versions)
            desired = min(max(blk.units, knee), cap, self.hw.n_units)
            return ChunkPlan(end_layer=blk.end, units=desired,
                             versions=blk.versions, budget_s=blk.budget_s,
                             units_min=blk.units)
        # layer-wise scheduling with adaptive compilation (VELTAIR-AC)
        i = task.next_layer
        vs = task.plan.version_sets[i]
        v = vs.select(itf) if self.adaptive_compile else vs.solo_version()
        budget = task.plan.budgets[i]
        units_min = min(cm.units_required(self.hw, v, budget,
                                          cm.Interference()),
                        self.hw.n_units)
        desired = max(units_min, lb.versions_knee(self.hw, [v]))
        return ChunkPlan(end_layer=i + 1, units=desired, versions=[v],
                         budget_s=budget, units_min=units_min)


VeltairPolicy = TorchVeltairPolicy


class TorchModelWisePolicy(Policy):
    """FCFS whole-model scheduling (the paper's prior-work baseline,
    Fig. 3/12 "model-wise": one static allocation for the entire model,
    provisioned at the low-load operating point).

    Decision inputs: the plan's precomputed ``fcfs_units`` only — no
    pressure sensing, no mid-model re-planning (``strict_fcfs`` keeps the
    queue in arrival order and a query either gets its full allocation or
    waits)."""
    name = "model-wise"
    strict_fcfs = True

    def plan_chunk(self, task, active, demands, now, free_units):
        plan = task.plan
        versions = [vs.solo_version() for vs in plan.version_sets]
        return ChunkPlan(end_layer=plan.n_layers, units=plan.fcfs_units,
                         versions=versions, budget_s=plan.qos_s,
                         allow_partial=False)


ModelWisePolicy = TorchModelWisePolicy


class TorchLayerWisePolicy(Policy):
    """Planaria-style spatial layer-wise scheduling (arXiv 2003.04696)
    ported to the unit pool: per-layer minimal allocation,
    start-small-and-grow on conflict (the paper charges the measured
    ~220us respawn overhead for that).

    Decision inputs: the plan's per-layer solo unit requirements — code
    versions stay solo-tuned and pressure is never sensed; the
    fine-grained re-planning itself is the (overhead-prone) mechanism."""
    name = "layer-wise"

    def plan_chunk(self, task, active, demands, now, free_units):
        i = task.next_layer
        v = task.plan.version_sets[i].solo_version()
        units_min = min(task.plan.layer_units[i], self.hw.n_units)
        desired = max(units_min, lb.versions_knee(self.hw, [v]))
        return ChunkPlan(end_layer=i + 1, units=desired, versions=[v],
                         budget_s=task.plan.budgets[i], units_min=units_min)


LayerWisePolicy = TorchLayerWisePolicy


class TorchFixedBlockPolicy(Policy):
    """Static layer-blocks of a fixed size (paper Fig. 3's block-6 /
    block-11 design points): the middle granularities between model-wise
    and layer-wise that motivate *adaptive* block formation.

    Decision inputs: the constant ``block_size`` and the solo-tuned
    version table — block boundaries never react to load or pressure."""

    def __init__(self, hw, block_size: int):
        super().__init__(hw)
        self.block_size = block_size
        self.name = f"block-{block_size}"

    def plan_chunk(self, task, active, demands, now, free_units):
        plan = task.plan
        i = task.next_layer
        end = min(i + self.block_size, plan.n_layers)
        versions = [vs.solo_version() for vs in plan.version_sets[i:end]]
        budget = sum(plan.budgets[i:end])
        units_min = lb._block_units(self.hw, versions, budget,
                                    cm.Interference(), self.hw.n_units)
        desired = max(units_min, lb.versions_knee(self.hw, versions))
        return ChunkPlan(end_layer=end, units=desired, versions=versions,
                         budget_s=budget, units_min=units_min)


FixedBlockPolicy = TorchFixedBlockPolicy


class TorchPremaPolicy(Policy):
    """PREMA-style temporal multiplexing (arXiv 1909.04548 / the paper's
    time-sharing baseline): one task at a time on the whole machine,
    preemptible at layer boundaries.

    Decision inputs: waiting time and QoS slack only (the slack-aware
    token in :meth:`order_pending`); spatial pressure never exists since
    execution is exclusive."""
    name = "prema"

    def plan_chunk(self, task, active, demands, now, free_units):
        i = task.next_layer
        v = task.plan.version_sets[i].solo_version()
        return ChunkPlan(end_layer=i + 1, units=self.hw.n_units,
                         versions=[v], budget_s=task.plan.budgets[i],
                         exclusive=True, allow_partial=False)

    def order_pending(self, pending, now):
        def token(t: TaskState):
            waited = now - t.arrival
            return -(waited / max(t.plan.qos_s, 1e-6))
        return sorted(pending, key=token)


PremaPolicy = TorchPremaPolicy
