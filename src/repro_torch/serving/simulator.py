"""A copy of ``repro.serving.simulator`` (pure Python and numpy). Classes
carry ``Torch*`` names with the reference's names as aliases (see
``repro_torch.core.cost_model``).

Discrete-event multi-tenant serving simulator.

Drives the *production* scheduler/compiler objects (repro.core.*) — only
time advancement is simulated; every scheduling, threshold, version and
allocation decision is the real code path.  Latencies come from the
analytical cost model charged with the true co-runner pressure at chunk
start (the scheduler itself only sees the proxy's estimate, like the real
system).

Two mechanisms mirror the paper's runtime exactly:

  * work-conserving grants — a chunk may start below its QoS-minimum
    allocation when the pool is tight;
  * grow-on-free upgrades — when units free up, under-allocated running
    chunks absorb them first and their finish time is recomputed; the
    respawn/re-shard overhead (Fig. 5b, ~220us on the CPU platform) is
    charged once per upgraded chunk.

Straggler mitigation: chunks may randomly run slow (node flakiness at pod
scale); a chunk exceeding ``straggler_factor`` x its prediction is
re-dispatched (bounded detection + redo cost).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core.allocator import UnitPool
from repro_torch.core.interference import RunningDemand, pressure_on
from repro_torch.core.layer_block import ModelPlan
from repro_torch.core.qos import QueryRecord, ServingMetrics, summarize
from repro_torch.core.scheduler import Policy, TaskState


@dataclasses.dataclass
class TorchSimConfig:
    max_sim_time: float = 1e9
    straggler_factor: float = 4.0     # x predicted latency => straggler
    straggler_prob: float = 0.0       # per-chunk chance of running slow
    straggler_slowdown: float = 5.0
    seed: int = 0


SimConfig = TorchSimConfig


@dataclasses.dataclass
class TorchRunningChunk:
    task: TaskState
    versions: list
    itf: cm.Interference
    units: int                 # currently held
    units_min: int             # QoS requirement (upgrade target)
    start: float
    finish: float
    demand: RunningDemand
    epoch: int = 0             # bumps on upgrade; stale events are dropped
    upgraded: bool = False

    def lat_at(self, hw, units: int) -> float:
        return sum(cm.latency(hw, v, units, self.itf) for v in self.versions)


RunningChunk = TorchRunningChunk


class TorchSimulator:
    def __init__(self, hw: cm.HardwareSpec, plans: dict[str, ModelPlan],
                 policy: Policy, sim_cfg: SimConfig | None = None):
        self.hw = hw
        self.plans = plans
        self.policy = policy
        self.cfg = sim_cfg or SimConfig()
        self.rng = np.random.default_rng(self.cfg.seed)

        self.pool = UnitPool(hw.n_units)
        self.demands: list[RunningDemand] = []
        self.pending: list[TaskState] = []
        self.active: list[TaskState] = []
        self.running: list[RunningChunk] = []
        self.records: list[QueryRecord] = []
        self.busy_unit_time = 0.0
        self.alloc_unit_time = 0.0
        self.requests = 0
        self.conflicts = 0
        self.stragglers = 0
        self._seq = itertools.count()
        self._conflict_marker: dict[int, int] = {}

    # ------------------------------------------------------------------
    def run(self, workload: list[tuple[float, str]]) -> ServingMetrics:
        events: list[tuple[float, int, str, object]] = []
        for t, name in workload:
            heapq.heappush(events, (t, next(self._seq), "arrival", name))
        qps = len(workload) / max(workload[-1][0], 1e-9) if workload \
            else 0.0
        tid = itertools.count()

        while events:
            now, _, kind, payload = heapq.heappop(events)
            if now > self.cfg.max_sim_time:
                # truncated run: chunks still in flight never reach
                # _on_finish, so account their held unit-time here or
                # unit_efficiency overstates
                self._flush_inflight()
                break
            if kind == "arrival":
                task = TaskState(tid=next(tid), tenant=payload,
                                 plan=self.plans[payload], arrival=now)
                self.active.append(task)
                if not self._try_start(task, now, events):
                    self.pending.append(task)
            elif kind == "finish":
                chunk, epoch = payload
                if chunk.epoch != epoch:
                    continue                      # stale (chunk upgraded)
                self._on_finish(chunk, now, events)
        return summarize(self.records, qps,
                         self.conflicts / max(self.requests, 1),
                         self.busy_unit_time, self.alloc_unit_time)

    def _flush_inflight(self) -> None:
        """Charge allocated unit-time of still-running chunks at
        termination — the full start..finish hold _on_finish would have
        charged (their busy flops were already charged in full at start,
        so clipping alloc at the cut-off would still overstate
        efficiency)."""
        for chunk in self.running:
            self.alloc_unit_time += chunk.units * (chunk.finish
                                                   - chunk.start)

    # ------------------------------------------------------------------
    def _on_finish(self, chunk: RunningChunk, now, events):
        task = chunk.task
        self.pool.release(chunk.units)
        self.alloc_unit_time += chunk.units * (now - chunk.start)
        self.running.remove(chunk)
        if chunk.demand in self.demands:
            self.demands.remove(chunk.demand)
        if task.done:
            self.active.remove(task)
            self.records.append(QueryRecord(
                tenant=task.tenant, arrival=task.arrival, finish=now,
                qos_s=task.plan.qos_s))
        else:
            # Alg. 3 worker: a task's next block launches back-to-back on
            # the cores it just released — no yield to the queue.
            if not self._try_start(task, now, events):
                self.pending.append(task)
        self._grow_running(now, events)           # paper: grow-on-free next
        self._dispatch(now, events)

    def _grow_running(self, now, events):
        """Give freed units to under-allocated running chunks (oldest
        first) and pull their finish times in."""
        for chunk in sorted(self.running, key=lambda c: c.start):
            if self.pool.free <= 0:
                return
            if chunk.units >= chunk.units_min:
                continue
            extra = min(chunk.units_min - chunk.units, self.pool.free)
            got = self.pool.try_alloc(extra)
            if got <= 0:
                continue
            frac_left = max(chunk.finish - now, 0.0) / max(
                chunk.finish - chunk.start, 1e-12)
            self.alloc_unit_time += chunk.units * (now - chunk.start)
            new_units = chunk.units + got
            new_total = chunk.lat_at(self.hw, new_units)
            remaining = frac_left * new_total
            if not chunk.upgraded:
                remaining += self.hw.realloc_overhead_s
                chunk.upgraded = True
            chunk.units = new_units
            chunk.start = now
            chunk.finish = now + remaining
            chunk.epoch += 1
            heapq.heappush(events, (chunk.finish, next(self._seq), "finish",
                                    (chunk, chunk.epoch)))

    def _dispatch(self, now, events):
        if self.pool.free <= 0:
            return
        order = self.policy.order_pending(self.pending, now)
        started = []
        for task in order:
            if self.pool.free <= 0:
                break
            if self._try_start(task, now, events):
                started.append(task)
            elif self.policy.strict_fcfs:
                break
        for task in started:
            self.pending.remove(task)

    def _try_start(self, task: TaskState, now: float, events) -> bool:
        plan = self.policy.plan_chunk(task, self.active, self.demands, now,
                                      self.pool.free)
        if plan is None:
            return False
        units_req = max(1, min(plan.units, self.hw.n_units))
        units_min = max(1, min(plan.units_min, units_req))
        first_attempt = self._conflict_marker.get(task.tid) != task.next_layer
        if first_attempt:
            self.requests += 1
            self._conflict_marker[task.tid] = task.next_layer

        if plan.exclusive and self.pool.used > 0:
            return False
        if not plan.allow_partial:
            if self.pool.free < units_req:
                if first_attempt:
                    self.conflicts += 1
                return False
            grant = units_req
        else:
            # work-conserving: start on whatever is free; grow-on-free will
            # top it up to units_min (conflict = started below the minimum)
            if self.pool.free <= 0:
                if first_attempt:
                    self.conflicts += 1
                return False
            grant = min(units_req, self.pool.free)
            if grant < units_min and first_attempt:
                self.conflicts += 1
        got = self.pool.try_alloc(grant)
        assert got == grant

        itf = pressure_on(task.tid, self.demands, now)
        lat = sum(cm.latency(self.hw, v, grant, itf) for v in plan.versions)
        if self.cfg.straggler_prob and \
                self.rng.random() < self.cfg.straggler_prob:
            slow = lat * self.cfg.straggler_slowdown
            if slow > self.cfg.straggler_factor * lat:
                # straggler: detected at the deadline factor, re-dispatched
                self.stragglers += 1
                lat = self.cfg.straggler_factor * lat + lat
            else:
                lat = slow

        bw = sum(cm.bw_demand(self.hw, v, grant, itf)
                 for v in plan.versions) / len(plan.versions)
        cache = sum(cm.cache_demand(self.hw, v, grant)
                    for v in plan.versions) / len(plan.versions)
        ici = sum(cm.ici_demand(self.hw, v, grant, itf)
                  for v in plan.versions) / len(plan.versions)
        demand = RunningDemand(tenant=task.tid, bw=bw, cache=cache, ici=ici,
                               start=now, finish=now + lat)
        self.demands.append(demand)
        self.busy_unit_time += sum(
            v.flops / self.hw.flops_per_unit for v in plan.versions)
        task.next_layer = plan.end_layer
        chunk = RunningChunk(task=task, versions=plan.versions, itf=itf,
                             units=grant, units_min=units_min, start=now,
                             finish=now + lat, demand=demand)
        self.running.append(chunk)
        heapq.heappush(events, (chunk.finish, next(self._seq), "finish",
                                (chunk, chunk.epoch)))
        return True


Simulator = TorchSimulator


def run_sweep(hw, plans, policy_fn, workload_fn, qps_list,
              sim_cfg: SimConfig | None = None):
    """[(qps, metrics)] for a QPS sweep — input to qos.qps_at_qos."""
    out = []
    for qps in qps_list:
        sim = Simulator(hw, plans, policy_fn(), sim_cfg)
        out.append((qps, sim.run(workload_fn(qps))))
    return out
