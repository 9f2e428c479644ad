"""Multi-model co-location runtime of the PyTorch port: N engines, one
unit pool (a copy of ``repro.serving.cluster``; the serve loop is the
reference's, step for step).

A :class:`ClusterRuntime` runs N concurrent :class:`TorchServingEngine`\\ s
serving *different* model architectures (gemma-2b next to starcoder2-3b
next to mamba2-780m), partitions ``hw.n_units`` across them every
scheduling quantum through the shared :class:`UnitPool` (on the card,
``cost_model.H100_SXM``: its 132 SMs), and drives a **per-engine**
interference level through each engine's version cache.

The paper's runtime loop, on the real execution path:

1. **Sense** — for each engine (the "victim"), synthesize a counter
   sample from the live slot occupancy of its co-resident engines
   (``read_counters``), or read the engine's measured wall-time bank.
2. **Estimate** — the policy maps the sample to a pressure estimate
   through its calibrated proxy (``Policy.interference_from_counters``).
3. **Plan** — ``Policy.plan_chunk_at`` forms the next layer-block at
   that pressure: its size becomes the engine's dispatch quantum and its
   unit requirement the engine's share of the pool.  Baselines plug into
   the same loop: model-wise FCFS re-plans once per model pass, PREMA
   runs exclusively one quantum at a time.
4. **Act** — the engine's grant is (re)allocated work-conservingly from
   the pool and ``set_interference_level`` swaps the engine to the code
   version compiled for the estimated pressure (a dictionary swap of
   captured CUDA graphs after :meth:`ClusterRuntime.warmup`).
5. **Dispatch** — each granted engine's whole quantum is issued
   (``begin_quantum``) before the tick blocks on any of them
   (``finish_quantum``); on the card every engine runs on its own CUDA
   stream, so co-located engines' device work overlaps — one host sync
   per engine per quantum.

Time: a virtual clock advances ``step_dt`` per executed decode step;
``wall_clock=True`` charges measured wall time instead.  ``fused=False``
restores the per-step dispatch loop.  The serves capture nothing: a CUDA
graph capture synchronizes the whole device, so ``warmup()`` captures
every engine's versions first.

Classes carry ``Torch*`` (or port) names with the reference's names as
aliases, and the methods the reference's code reaches by name are
defined under port names bound to the reference's (``_replan =
_plan_tenant``, ``tenant_prompts = prompt_tables``, ...): the
repository's static analyzer resolves those calls by the names being
unique.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core.allocator import UnitPool
from repro_torch.core.interference import RunningDemand, read_counters
from repro_torch.core.layer_block import ModelPlan
from repro_torch.core.qos import (QueryRecord, ServingMetrics, TierSpec,
                                  summarize)
from repro_torch.core.scheduler import Policy, TaskState
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.request import synth_prompts
from repro_torch.serving.runtime import Workload, plan_demand
from repro_torch.serving.slo import (AdmissionController, DeadlineBook,
                                     pick_quantum)
from repro_torch.serving.tenants import cluster_plans


@dataclasses.dataclass
class TorchEngineTenant:
    """One co-located tenant: a real engine plus its analytic plan.

    ``engine`` executes the model; ``plan`` is the
    compile-time artifact the scheduler reasons with (version tables,
    QoS slices, ``Avg_C``) — the same pairing the single-engine
    ``OnlineRuntime`` uses, replicated per model.  ``tier`` is the
    tenant's SLO tier (core.qos.TIER_ORDER); a Workload's ``tiers`` map
    overrides it per serve, and None means untiered legacy behavior."""
    name: str
    engine: ServingEngine
    plan: ModelPlan
    tier: str | None = None


EngineTenant = TorchEngineTenant


@dataclasses.dataclass
class TenantServeState:
    """Mutable per-tenant serving state (grants, quanta, queues)."""
    pending: collections.deque = dataclasses.field(
        default_factory=collections.deque)
    grant: int = 0                 # units currently held from the pool
    quantum_left: int = 0          # decode steps before the next re-plan
    cursor: int = 0                # layer-block cursor into plan.layers
    oldest_admit: float = 0.0      # head-of-line admit time (priority)
    levels: list = dataclasses.field(default_factory=list)
    quanta: int = 0                # re-plan count
    busy: float = 0.0              # occupancy-weighted unit-time
    alloc: float = 0.0             # granted unit-time
    records: list = dataclasses.field(default_factory=list)
    prefill_last: bool = False     # prefill/decode alternation state
    prefill_quanta: int = 0        # prefill chunks dispatched
    ttft: dict = dataclasses.field(default_factory=dict)   # rid -> ttft


_TenantState = TenantServeState


@dataclasses.dataclass
class TorchClusterMetrics:
    """Co-location serve result: aggregate + per-tenant ServingMetrics,
    plus the scheduling traces the tests/benchmarks assert on."""
    aggregate: ServingMetrics
    per_tenant: dict[str, ServingMetrics]
    level_traces: dict[str, list[float]]     # per-quantum engine levels
    partition_trace: list[dict[str, int]]    # per-tick unit grants
    quanta: dict[str, int]                   # re-plan counts
    pool_conflicts: int                      # grants below QoS minimum
    pool_peak_used: int
    host_syncs: dict[str, int] = dataclasses.field(default_factory=dict)
    tokens_per_sync: dict[str, float] = dataclasses.field(
        default_factory=dict)
    prefill_quanta: dict[str, int] = dataclasses.field(default_factory=dict)
    page_stats: dict[str, dict] = dataclasses.field(default_factory=dict)
                                             # per-tenant KV page-pool
                                             # counters ({} on dense engines)
    spec_stats: dict[str, dict] = dataclasses.field(default_factory=dict)
                                             # per-tenant speculative-decode
                                             # counters (zeros on non-spec
                                             # engines)

    @property
    def level_means(self) -> dict[str, float]:
        return {n: float(np.mean(tr)) if tr else 0.0
                for n, tr in self.level_traces.items()}

    mean_levels = level_means


ClusterMetrics = TorchClusterMetrics


def make_cluster(archs: list[str], hw: cm.HardwareSpec, *,
                 batch_slots: int = 2, max_len: int = 32,
                 qos_scale: float = 3.0, seed: int = 0,
                 plans: dict[str, ModelPlan] | None = None,
                 tiers: dict[str, str] | None = None,
                 page_size: int | None = None,
                 n_pages: int | None = None,
                 page_reserve: str = "worst",
                 configs: dict | None = None,
                 params: dict | None = None,
                 device=None, **engine_kw) -> list[EngineTenant]:
    """Stand up one engine per architecture.

    Each engine gets its own params, KV/SSM cache, version cache, CUDA
    stream (on the card) and — through ``version_sets`` from its *own*
    plan — its own adaptive-compiled tile table, so per-engine levels
    select per-model code versions.

    ``configs`` maps an arch to its config (default: the reduced config,
    as the reference builds); ``params`` maps an arch to its weights
    (e.g. bridged from the JAX package), else they are drawn on the
    engine's device from a ``torch.Generator`` seeded ``seed + i``.
    ``device`` is the engines' (None: the card); ``engine_kw`` goes to
    every engine."""
    import torch

    from repro_torch.configs import get_reduced_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import resolve_device

    dev = resolve_device(device)
    plans = plans or cluster_plans(list(archs), hw, qos_scale=qos_scale)
    out = []
    for i, arch in enumerate(archs):
        cfg = (configs or {}).get(arch) or get_reduced_config(arch)
        weights = (params or {}).get(arch)
        if weights is None:
            weights = Model(cfg).init(
                torch.Generator(device=dev).manual_seed(seed + i), dev)
        engine = ServingEngine(cfg, weights, batch_slots=batch_slots,
                               max_len=max_len,
                               version_sets=plans[arch].version_sets,
                               page_size=page_size, n_pages=n_pages,
                               page_reserve=page_reserve, device=dev,
                               **engine_kw)
        out.append(EngineTenant(name=arch, engine=engine, plan=plans[arch],
                                tier=(tiers or {}).get(arch)))
    return out


build_cluster = make_cluster


class TorchClusterRuntime:
    """Admission/partition/dispatch loop over N co-located real engines.

    Knobs: ``step_dt`` (virtual seconds per decode tick),
    ``wall_clock`` (charge measured step+switch wall time instead),
    ``max_steps`` (tick budget), ``seed`` (counter-read noise).  The
    policy instance is shared — it is the *global* scheduler regulating
    all tenants, exactly as in the paper; per-engine behavior differs
    because each engine's counter read sees different co-runners."""

    def __init__(self, tenants: list[EngineTenant], policy: Policy,
                 hw: cm.HardwareSpec, *, step_dt: float = 1e-3,
                 wall_clock: bool = False, max_steps: int = 200_000,
                 seed: int = 0, fused: bool = True,
                 scheduler: str = "slo",
                 admission: AdmissionController | None = None,
                 tiers: dict[str, TierSpec] | None = None,
                 counter_source: str = "oracle",
                 refit_proxy: bool | None = None):
        if len({t.name for t in tenants}) != len(tenants):
            raise ValueError("tenant names must be unique")
        if scheduler not in ("slo", "fifo"):
            raise ValueError(f"scheduler must be 'slo' or 'fifo', "
                             f"got {scheduler!r}")
        if counter_source not in ("oracle", "measured"):
            raise ValueError(f"counter_source must be 'oracle' or "
                             f"'measured', got {counter_source!r}")
        self.tenants = list(tenants)
        self.policy = policy
        self.hw = hw
        self.step_dt = step_dt
        self.wall_clock = wall_clock
        self.max_steps = max_steps
        self.fused = fused
        self.scheduler = scheduler
        self.admission = admission       # None = admit everything (legacy)
        self.book = DeadlineBook(tiers)
        # counter provenance per engine: "measured" reads each tenant's
        # own per-quantum wall-time bank (oracle fallback while cold);
        # refit_proxy=None turns the online RLS re-fit on exactly when
        # serving on measured counters
        self.counter_source = counter_source
        self.refit_proxy = (counter_source == "measured"
                            if refit_proxy is None else bool(refit_proxy))
        self.counter_sources = collections.Counter()  # source label -> polls
        self.pool = UnitPool(hw.n_units)
        self.ticks = 0
        self.conflicts = 0               # admission rejections (engine full)
        self.tenant_conflicts = {t.name: 0 for t in self.tenants}
        self.shed = 0                    # rejected by admission control
        self.deferred = 0                # admissions delayed by it
        self.tenant_shed = {t.name: 0 for t in self.tenants}
        self.tenant_deferred = {t.name: 0 for t in self.tenants}
        self.sched_trace: list[tuple] = []  # (tenant, "prefill", rid,
                                            #  tier, t) |
                                            # (tenant, "decode", (rids...), t)
        self.outputs: dict[int, list[int]] = {}   # rid -> served tokens
        self.compile_time_s = 0.0        # wall time inside level switches
        self.partition_trace: list[dict[str, int]] = []
        self._rng = np.random.default_rng(seed)
        self._state = {t.name: _TenantState() for t in self.tenants}
        self._demand_cache: dict[tuple[str, int], tuple] = {}

    # ------------------------------------------------------------------
    def warmup(self, prompt_lens: tuple[int, ...] = (),
               quantum_buckets: tuple[int, ...] | None = None) -> dict:
        """Build every engine's versions ahead of the serves: every
        distinct version its level table selects, with its fused K-bucket
        quanta and prefill-chunk buckets (on the card, the CUDA graphs
        captured; level switches during serve() become dictionary swaps
        and the serves capture nothing).  Returns per-tenant
        version-cache stats."""
        return {t.name: t.engine.warmup(prompt_lens=prompt_lens,
                                        quantum_buckets=quantum_buckets)
                for t in self.tenants}

    def prompt_tables(self, wl: Workload) -> dict[str, np.ndarray]:
        """Per-tenant prompt tables for ``wl`` — seeded per tenant
        position, so co-located tenants never replay byte-identical
        prompt streams, while staying deterministic per (workload seed,
        cluster layout).  ``wl.shared_prefix_len`` gives every prompt of
        a tenant the same opening run (a per-tenant system prompt) —
        on paged engines the prefix index deduplicates those pages
        across the tenant's co-resident requests."""
        out = {}
        for idx, t in enumerate(self.tenants):
            tbl = synth_prompts(wl.n_queries, wl.prompt_len,
                                t.engine.cfg.vocab_size, wl.seed + idx)
            if wl.shared_prefix_len > 0:
                spl = min(wl.shared_prefix_len, tbl.shape[1])
                pre = np.random.default_rng(
                    wl.seed + idx + 0x9EF1).integers(
                    0, t.engine.cfg.vocab_size, spl)
                tbl[:, :spl] = pre.astype(tbl.dtype)
            out[t.name] = tbl
        return out

    tenant_prompts = prompt_tables

    def _tenant_footprint(self, tenant: EngineTenant, units: int) -> tuple:
        key = (tenant.name, units)
        hit = self._demand_cache.get(key)
        if hit is None:
            hit = plan_demand(tenant.plan, self.hw, max(1, units))
            self._demand_cache[key] = hit
        return hit

    _footprint = _tenant_footprint

    def _slot_demands(self, meta: dict, now: float) -> list[RunningDemand]:
        """One RunningDemand per occupied slot across all engines — the
        live-occupancy picture the counter synthesizer reads.  Slot
        footprints are evaluated at the engine's current grant (fair
        share before its first grant)."""
        fair = max(1, self.hw.n_units // max(len(self.tenants), 1))
        out = []
        for idx, t in enumerate(self.tenants):
            st = self._state[t.name]
            bw, cache, ici = self._tenant_footprint(t, st.grant or fair)
            for req in t.engine.slot_req:
                if req is None:
                    continue
                _, _, admit = meta[req.rid]
                horizon = admit + self.step_dt * (req.max_new_tokens + 1)
                out.append(RunningDemand(
                    tenant=idx, bw=bw, cache=cache, ici=ici, start=admit,
                    finish=max(horizon, now + self.step_dt)))
        return out

    _live_demands = _slot_demands

    def _task_state(self, idx: int, tenant: EngineTenant) -> TaskState:
        st = self._state[tenant.name]
        return TaskState(tid=idx, tenant=tenant.name, plan=tenant.plan,
                         arrival=st.oldest_admit, next_layer=st.cursor)

    _task = _task_state

    def _release_grant(self, st: _TenantState) -> None:
        if st.grant:
            self.pool.release(st.grant)
            st.grant = 0
        st.quantum_left = 0

    _release = _release_grant

    # ------------------------------------------------------------------
    def _plan_tenant(self, idx: int, tenant: EngineTenant,
                active_tasks: list[TaskState],
                demands: list[RunningDemand], now: float) -> None:
        """One scheduling quantum decision for ``tenant``: counters ->
        proxy -> layer-block plan -> pool grant + engine code version."""
        st = self._state[tenant.name]
        sample = read_counters(self.hw, idx, demands, now, self._rng,
                               source=self.counter_source,
                               bank=tenant.engine.counter_bank)
        self.counter_sources[sample.source] += 1
        if self.refit_proxy:
            target = (sample.truth if sample.truth is not None
                      else tenant.engine.counter_bank.pressure())
            if target is not None:
                self.policy.observe_counters(sample, target)
        itf = self.policy.interference_from_counters(sample)
        task = self._task_state(idx, tenant)
        plan = self.policy.plan_chunk_at(task, active_tasks, itf, now,
                                         self.pool.free)
        if plan is None:
            return
        if plan.exclusive and self.pool.used > 0:
            return                        # temporal policy: wait for idle
        desired = max(1, min(plan.units, self.hw.n_units))
        lo = max(1, min(plan.units_min, desired))
        if not plan.allow_partial:
            if self.pool.free < desired:
                return                    # all-or-nothing: stall this tick
            grant = self.pool.try_alloc(desired)
        else:
            grant = self.pool.try_alloc_range(lo, desired)
            if grant == 0:
                return                    # pool exhausted: stall this tick
        st.grant = grant
        st.quantum_left = max(plan.end_layer - task.next_layer, 1)
        st.cursor = plan.end_layer % tenant.plan.n_layers
        st.quanta += 1
        level = self.policy.level_from_counters(sample)
        t0 = time.perf_counter()
        tenant.engine.set_interference_level(level)
        self.compile_time_s += time.perf_counter() - t0
        st.levels.append(level)

    _replan = _plan_tenant

    # ------------------------------------------------------------------
    def serve(self, wl: Workload) -> ClusterMetrics:
        """Replay ``wl`` through the co-located engines.  Arrival tenant
        names must match EngineTenant names (each query runs on its own
        model's engine)."""
        by_name = {t.name: t for t in self.tenants}
        unknown = {name for _, name in wl.arrivals} - set(by_name)
        if unknown:
            raise KeyError(f"workload tenants {sorted(unknown)} have no "
                           f"engine; cluster serves {sorted(by_name)}")
        lens = wl.prompt_lengths()
        prompts = self.prompt_tables(wl)
        arrivals = collections.deque(
            (at, name, rid) for rid, (at, name)
            in enumerate(sorted(wl.arrivals)))
        meta: dict[int, tuple[str, float, float]] = {}
        rejected: set[int] = set()
        deferred_rids: set[int] = set()
        by_tenant_name = {t.name: t for t in self.tenants}
        now = 0.0

        def tier_for(name: str) -> str | None:
            # the workload's tiers map wins; the tenant's own tier is the
            # standing assignment; None = untiered legacy
            wt = wl.tier_of(name)
            return wt if wt is not None else by_tenant_name[name].tier

        tiered = any(tier_for(t.name) is not None for t in self.tenants)

        def admit_pending(t: EngineTenant) -> None:
            st = self._state[t.name]
            while st.pending:
                at, rid = st.pending[0]
                req = Request(rid=rid,
                              prompt=prompts[t.name][rid, :lens[rid]],
                              max_new_tokens=wl.max_new_tokens,
                              tier=tier_for(t.name))
                if self.scheduler == "slo" and self.admission is not None:
                    entry = self.book.entry(rid)
                    pages_needed, pages_free = t.engine.admission_pages(
                        req.prompt, wl.max_new_tokens)
                    decision = self.admission.decide(
                        now=now, entry=entry,
                        spec=self.book.spec(entry.tier),
                        step_dt=self.step_dt,
                        own_chunks=len(
                            t.engine._prefill_schedule(lens[rid])),
                        own_decode_steps=wl.max_new_tokens,
                        backlog_chunks=sum(
                            c for _, _, c in t.engine.prefill_queue()),
                        slot_free=t.engine.active_slots < t.engine.slots,
                        pages_needed=pages_needed, pages_free=pages_free)
                    if decision == "shed":
                        self.shed += 1
                        self.tenant_shed[t.name] += 1
                        self.book.drop(rid)
                        st.pending.popleft()
                        continue
                    if decision == "defer":
                        if rid not in deferred_rids:
                            deferred_rids.add(rid)
                            self.deferred += 1
                            self.tenant_deferred[t.name] += 1
                        break
                try:
                    admitted = t.engine.admit_request(req)
                except ValueError:
                    # inadmissible prompt length: hard conflict, drop it
                    if rid not in rejected:
                        rejected.add(rid)
                        self.conflicts += 1
                        self.tenant_conflicts[t.name] += 1
                    st.pending.popleft()
                    continue
                if not admitted:
                    if rid not in rejected:       # QoS conflict, once/query
                        rejected.add(rid)
                        self.conflicts += 1
                        self.tenant_conflicts[t.name] += 1
                    break
                meta[rid] = (t.name, at, now)
                if req.output:                    # monolithic admission
                    st.ttft[rid] = now - at
                st.pending.popleft()
            active = [meta[r.rid][2] for r in t.engine.slot_req
                      if r is not None]
            st.oldest_admit = min(active) if active else now

        def earliest_deadline(name: str) -> float:
            """Earliest deadline across a tenant's in-flight and pending
            requests — the slack key grants are ordered by when tiered."""
            t = by_tenant_name[name]
            rids = [r.rid for r in t.engine.slot_req if r is not None]
            rids += [rid for _, rid in self._state[name].pending]
            dls = [self.book.entry(r).deadline for r in rids
                   if self.book.get(r) is not None]
            return min(dls) if dls else float("inf")

        while arrivals or any(self._state[t.name].pending
                              or t.engine.active_slots
                              for t in self.tenants):
            if self.ticks >= self.max_steps:
                break
            while arrivals and arrivals[0][0] <= now:
                at, name, rid = arrivals.popleft()
                self.book.register(rid, name, tier_for(name), at,
                                   by_name[name].plan.qos_s)
                self._state[name].pending.append((at, rid))
            for t in self.tenants:
                admit_pending(t)

            active = [t for t in self.tenants if t.engine.active_slots]
            if not active:
                if arrivals:                 # idle: jump to next arrival
                    now = max(now, arrivals[0][0])
                    continue
                break

            # grants of engines that drained their slots go back first
            for t in self.tenants:
                if not t.engine.active_slots:
                    self._release_grant(self._state[t.name])

            # stamp each engine's live co-runner occupancy so its measured
            # counter bank records who it shared the machine with
            total_active = sum(t.engine.active_slots for t in self.tenants)
            for t in self.tenants:
                t.engine.co_runner_load = total_active - t.engine.active_slots

            t_tick = time.perf_counter()
            demands = self._slot_demands(meta, now)
            active_tasks = [self._task_state(i, t)
                            for i, t in enumerate(self.tenants)
                            if t.engine.active_slots]
            need = [task for task in active_tasks
                    if self._state[task.tenant].grant == 0]
            if self.scheduler == "slo" and tiered:
                # tiered serve: grants go out in earliest-deadline order
                # (the engine whose tightest query has least slack plans
                # first, so it gets units before the pool runs dry)
                ordered = sorted(
                    need, key=lambda task: (earliest_deadline(task.tenant),
                                            task.arrival, task.tid))
            else:
                ordered = self.policy.order_pending(need, now)
            for task in ordered:
                self._plan_tenant(task.tid, self.tenants[task.tid],
                             active_tasks, demands, now)

            self.partition_trace.append(
                {t.name: self._state[t.name].grant for t in self.tenants})

            # dispatch phase: issue every granted engine's quantum BEFORE
            # blocking on any of them — in fused mode begin_quantum returns
            # without a host sync, so N co-located engines' device work
            # overlaps instead of serializing through the Python loop
            granted = [t for t in active if self._state[t.name].grant > 0]
            # lockstep tick quantum: every granted engine dispatches the
            # same number of steps this tick (the smallest outstanding
            # quantum), so no co-runner loses virtual time waiting for a
            # longer quantum to drain — engines with bigger blocks keep
            # their grant and continue next tick
            q_tick = min((self._state[t.name].quantum_left
                          for t in granted), default=0)
            launched: list[tuple] = []
            for t in active:
                st = self._state[t.name]
                if st.grant == 0:
                    # stalled this tick (pool exhausted / exclusive quantum
                    # pending); time still advances below, so the next tick
                    # re-plans instead of spinning
                    continue
                # per-engine prefill/decode pick.  FIFO: strict
                # alternation — an engine with a prompt mid-prefill
                # spends every other quantum (or every quantum, if
                # nothing is decodable) on one prefill chunk, so
                # admissions are metered without starving its decodes.
                # SLO: earliest-deadline pick over the engine's prefill
                # queue and decode backlog (TTFT-urgent chunks preempt).
                pf_slot = None
                k_dispatch = q_tick
                if self.scheduler == "slo":
                    pick = pick_quantum(t.engine, self.book, now,
                                        self.step_dt, max(q_tick, 1))
                    do_prefill = pick is not None and pick[0] == "prefill"
                    if do_prefill:
                        pf_slot = pick[1]
                    elif pick is not None:
                        k_dispatch = min(q_tick, pick[1]) or 1
                else:
                    do_prefill = t.engine.should_prefill(st.prefill_last)
                    st.prefill_last = do_prefill
                if do_prefill:
                    occupancy = 1.0 / t.engine.slots   # the prefilling row
                    pf = t.engine.prefill_step(pf_slot)
                    st.prefill_quanta += 1
                    if pf is not None:
                        e = self.book.get(pf.rid)
                        self.sched_trace.append(
                            (t.name, "prefill", pf.rid,
                             e.tier if e is not None else None, now))
                    launched.append((t, st, None, occupancy, pf))
                    continue
                # decode occupancy: slots still mid-prefill are skipped by
                # the decode quantum and must not be charged as busy
                occupancy = (t.engine.active_slots
                             - t.engine.prefill_pending) / t.engine.slots
                handle = (t.engine.begin_quantum(k_dispatch)
                          if self.fused else None)
                if handle is not None:
                    self.sched_trace.append((t.name, "decode", tuple(
                        t.engine.slot_req[i].rid for i in handle.active),
                        now))
                launched.append((t, st, handle, occupancy, None))

            # collect phase: one host sync per engine per quantum
            finished: list[tuple[str, Request, int]] = []
            prefill_done: list[tuple[_TenantState, int]] = []
            held: list[tuple] = []
            max_run = 1
            for t, st, handle, occupancy, pf in launched:
                if pf is not None:
                    fin = []
                    steps = 1
                    row_steps = {}
                    row_tokens = 1.0          # the one row being prefilled
                    if pf.finished:
                        prefill_done.append((st, pf.rid))
                elif self.fused:
                    fin = t.engine.finish_quantum(handle)
                    steps = handle.steps if handle is not None else 1
                    row_steps = (handle.row_steps if handle is not None
                                 else {})
                    row_tokens = (float(handle.n_left.sum())
                                  if handle is not None else 0.0)
                else:
                    fin = t.engine.step()
                    steps = 1
                    row_steps = {}
                    row_tokens = occupancy * t.engine.slots
                max_run = max(max_run, steps)
                held.append((st, st.grant, occupancy, steps, row_tokens,
                             t.engine.slots))
                for req in fin:
                    # row_steps is in tokens; a speculative quantum emits
                    # several per sync, so the finish offset is capped at
                    # the quantum's clock steps
                    finished.append((t.name, req,
                                     min(row_steps.get(req.rid, steps),
                                         steps)))
                st.quantum_left -= steps
                if st.quantum_left <= 0 or not t.engine.active_slots:
                    self._release_grant(st)

            dt = (time.perf_counter() - t_tick) if self.wall_clock \
                else self.step_dt * max_run
            self.ticks += 1
            t_begin = now
            now += dt
            # unit-time accounting uses the same dt basis as the clock, so
            # summarize()'s avg_units/efficiency stay consistent in both
            # virtual and wall_clock modes.  In virtual mode an engine is
            # charged for the steps it actually executed; busy counts the
            # rows that actually decoded (grant * step_dt * row-steps /
            # slots reduces to the old grant * dt * occupancy at steps=1)
            for st, grant, occupancy, steps, row_tokens, slots in held:
                if self.wall_clock:
                    st.busy += grant * dt * occupancy
                    st.alloc += grant * dt
                else:
                    st.busy += grant * self.step_dt * row_tokens / slots
                    st.alloc += grant * self.step_dt * steps
            for st, rid in prefill_done:
                st.ttft[rid] = now - meta[rid][1]
            for name, req, off in finished:
                _, at, _ = meta[req.rid]
                st = self._state[name]
                fin = now if self.wall_clock else t_begin + off * self.step_dt
                entry = self.book.get(req.rid)
                has_tier = tier_for(name) is not None
                st.records.append(QueryRecord(
                    tenant=name, arrival=at, finish=fin,
                    qos_s=by_name[name].plan.qos_s,
                    ttft_s=st.ttft.get(req.rid),
                    tier=(entry.tier if has_tier and entry is not None
                          else "standard"),
                    deadline=(entry.deadline
                              if has_tier and entry is not None else None)))
                self.outputs[req.rid] = list(req.output)
                self.book.drop(req.rid)

        for t in self.tenants:               # return whatever is still held
            self._release_grant(self._state[t.name])

        span = max((wl.arrivals[-1][0] if wl.arrivals else 0.0), 1e-9)
        per_tenant = {}
        all_records: list[QueryRecord] = []
        busy = alloc = 0.0
        peak_tokens = peak_cap = 0
        for t in self.tenants:
            st = self._state[t.name]
            n_t = sum(1 for _, name in wl.arrivals if name == t.name)
            eng = t.engine
            per_tenant[t.name] = summarize(
                st.records, n_t / span,
                self.tenant_conflicts[t.name] / max(n_t, 1),
                st.busy, st.alloc,
                shed=self.tenant_shed[t.name],
                deferred=self.tenant_deferred[t.name],
                peak_cache_tokens=eng.peak_cache_tokens,
                cache_utilization=eng.cache_utilization,
                tokens_accepted=eng.tokens_accepted,
                draft_hit_rate=eng.draft_hit_rate,
                spec_rollbacks=eng.spec_rollbacks)
            all_records.extend(st.records)
            busy += st.busy
            alloc += st.alloc
            peak_tokens += eng.peak_cache_tokens
            peak_cap += (eng.pool.peak_used * eng.page_size
                         if eng.paged and eng.pool is not None
                         else eng.slots * eng.max_len)
        drafted = sum(t.engine.tokens_drafted for t in self.tenants)
        accepted = sum(t.engine.tokens_accepted for t in self.tenants)
        aggregate = summarize(all_records, wl.qps,
                              self.conflicts / max(wl.n_queries, 1),
                              busy, alloc,
                              shed=self.shed, deferred=self.deferred,
                              peak_cache_tokens=peak_tokens,
                              cache_utilization=(peak_tokens / peak_cap
                                                 if peak_cap else 0.0),
                              proxy_rms_error=self.policy.proxy_rms_error,
                              refit_count=self.policy.proxy_refits,
                              tokens_accepted=accepted,
                              draft_hit_rate=accepted / max(drafted, 1),
                              spec_rollbacks=sum(t.engine.spec_rollbacks
                                                 for t in self.tenants))
        return ClusterMetrics(
            aggregate=aggregate, per_tenant=per_tenant,
            level_traces={t.name: list(self._state[t.name].levels)
                          for t in self.tenants},
            partition_trace=list(self.partition_trace),
            quanta={t.name: self._state[t.name].quanta
                    for t in self.tenants},
            pool_conflicts=self.pool.conflicts,
            pool_peak_used=self.pool.peak_used,
            host_syncs={t.name: t.engine.host_syncs
                        for t in self.tenants},
            tokens_per_sync={t.name: t.engine.tokens_per_sync
                             for t in self.tenants},
            prefill_quanta={t.name: self._state[t.name].prefill_quanta
                            for t in self.tenants},
            page_stats={t.name: t.engine.page_stats
                        for t in self.tenants},
            spec_stats={t.name: t.engine.spec_stats
                        for t in self.tenants})


ClusterRuntime = TorchClusterRuntime
