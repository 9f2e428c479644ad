"""Online multi-tenant serving runtime of the PyTorch port: the VELTAIR
policy in the loop of the port's engine (a copy of
``repro.serving.runtime``; the serve loop is the reference's, step for
step).

Per-tenant request queues feed one :class:`TorchServingEngine`.  Before
every quantum the runtime polls the performance counters for the live
slot occupancy (synthesized from the oracle demand sums, or measured from
the engine's per-quantum wall times), the policy maps them to an
interference level through its calibrated proxy, and the engine swaps to
that level's code version (``set_interference_level``: a version-cache
swap; on the card, to that version's CUDA graphs).  The policy's
layer-block plan sizes the next decode quantum; the SLO scheduler
(``scheduler="slo"``) picks prefill chunks and decode quanta by earliest
deadline, with optional admission control; ``"fifo"`` alternates them.

A :class:`Workload` replays through both the simulator
(``replay_through_simulator``) and the engine (``OnlineRuntime.serve``),
producing directly comparable ``ServingMetrics``.

Time: the runtime advances a virtual clock by ``step_dt`` per engine
step (deterministic and hardware-independent: latencies are workload
time, not the card's).  ``wall_clock=True`` instead charges the host wall
time of each quantum from before its version switch to the engine call's
return.  A decode quantum and a prompt's final prefill chunk end in the
quantum's one host sync, so their wall includes their device time; a
non-final prefill chunk does not sync (the reference's asynchronous
dispatch does the same), so its wall is the time to enqueue its graph
replay, and its device time lands in the next quantum that syncs.

Classes carry ``Torch*`` names with the reference's names as aliases (see
``repro_torch.core.cost_model``).  Names the reference's own code reaches
by being unique in the repository are defined under port names and bound
to the reference's: ``plan_demand = solo_footprint``,
``Workload.tier_of = tenant_tier`` and ``Workload.prompt_lengths =
query_prompt_lengths`` (the static analyzer, repro.analysis.callgraph,
would otherwise find two definitions and resolve the reference's calls
to neither).
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core.interference import RunningDemand, read_counters
from repro_torch.core.layer_block import ModelPlan
from repro_torch.core.qos import (QueryRecord, ServingMetrics, TierSpec,
                                  summarize)
from repro_torch.core.scheduler import Policy, TaskState
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.request import (diurnal_workload,
                                         gamma_poisson_workload,
                                         poisson_workload, synth_prompts)
from repro_torch.serving.simulator import SimConfig, Simulator
from repro_torch.serving.slo import (AdmissionController, DeadlineBook,
                                     pick_quantum)


@dataclasses.dataclass
class TorchWorkload:
    """A replayable tenant mix: arrivals in virtual seconds plus the
    request shapes.  Prompts need not be aligned — the engine decodes
    every slot at its own position — so ``prompt_len_spread`` > 0 draws each
    query's length uniformly from [prompt_len - spread, prompt_len]
    (deterministic per seed)."""
    arrivals: list[tuple[float, str]]      # (time, tenant) sorted by time
    prompt_len: int = 8
    max_new_tokens: int = 4
    seed: int = 0
    prompt_len_spread: int = 0             # mixed-length prompts when > 0
    tiers: dict[str, str] | None = None    # tenant -> SLO tier name; None =
                                           # untiered legacy workload
    shared_prefix_len: int = 0             # every prompt opens with the same
                                           # shared_prefix_len tokens (system-
                                           # prompt traffic: the paged engine's
                                           # prefix index deduplicates them)

    @property
    def n_queries(self) -> int:
        return len(self.arrivals)

    def tenant_tier(self, tenant: str) -> str | None:
        """The tenant's SLO tier, or None for untiered workloads (legacy
        qos_s-relative satisfaction, standard-tier urgency)."""
        if self.tiers is None:
            return None
        return self.tiers.get(tenant)

    tier_of = tenant_tier

    def query_prompt_lengths(self) -> list[int]:
        """Per-query prompt lengths (deterministic per seed)."""
        if not self.prompt_len_spread:
            return [self.prompt_len] * self.n_queries
        rng = np.random.default_rng(self.seed + 0x5EED)
        lo = max(1, self.prompt_len - self.prompt_len_spread)
        return [int(x) for x in
                rng.integers(lo, self.prompt_len + 1, self.n_queries)]

    prompt_lengths = query_prompt_lengths

    @property
    def qps(self) -> float:
        if not self.arrivals:
            return 0.0
        return len(self.arrivals) / max(self.arrivals[-1][0], 1e-9)

    @staticmethod
    def poisson(tenants: list[str], qps: float, n_queries: int, *,
                prompt_len: int = 8, max_new_tokens: int = 4, seed: int = 0,
                weights: list[float] | None = None,
                prompt_len_spread: int = 0,
                shared_prefix_len: int = 0) -> "Workload":
        arr = poisson_workload(tenants, qps, n_queries, seed=seed,
                               weights=weights)
        return Workload(arr, prompt_len=prompt_len,
                        max_new_tokens=max_new_tokens, seed=seed,
                        prompt_len_spread=prompt_len_spread,
                        shared_prefix_len=shared_prefix_len)

    @staticmethod
    def bursty(tenants: list[str], qps: float, n_queries: int, *,
               burstiness: float = 4.0, interval_s: float = 0.05,
               prompt_len: int = 8, max_new_tokens: int = 4, seed: int = 0,
               weights: list[float] | None = None,
               prompt_len_spread: int = 0,
               shared_prefix_len: int = 0,
               tiers: dict[str, str] | None = None) -> "Workload":
        """Gamma-modulated Poisson arrivals (flash crowds at mean ``qps``
        offered load) — the heavy-traffic regime the paper targets."""
        arr = gamma_poisson_workload(tenants, qps, n_queries,
                                     burstiness=burstiness,
                                     interval_s=interval_s, seed=seed,
                                     weights=weights)
        return Workload(arr, prompt_len=prompt_len,
                        max_new_tokens=max_new_tokens, seed=seed,
                        prompt_len_spread=prompt_len_spread,
                        shared_prefix_len=shared_prefix_len, tiers=tiers)

    @staticmethod
    def diurnal(tenants: list[str], qps_peak: float, n_queries: int, *,
                period_s: float = 1.0, floor: float = 0.2,
                prompt_len: int = 8, max_new_tokens: int = 4, seed: int = 0,
                weights: list[float] | None = None,
                prompt_len_spread: int = 0,
                shared_prefix_len: int = 0,
                tiers: dict[str, str] | None = None) -> "Workload":
        """Sinusoidally-modulated arrivals (compressed diurnal cycle)."""
        arr = diurnal_workload(tenants, qps_peak, n_queries,
                               period_s=period_s, floor=floor, seed=seed,
                               weights=weights)
        return Workload(arr, prompt_len=prompt_len,
                        max_new_tokens=max_new_tokens, seed=seed,
                        prompt_len_spread=prompt_len_spread,
                        shared_prefix_len=shared_prefix_len, tiers=tiers)

    @staticmethod
    def replay(arrivals: list[tuple[float, str]], **kw) -> "Workload":
        """Trace replay: a recorded (time, tenant) stream — sorted here so
        captured traces need no preprocessing — with the request shapes
        supplied as keywords (scales to thousands of requests)."""
        return Workload(sorted(arrivals), **kw)


Workload = TorchWorkload


def replay_through_simulator(wl: Workload, hw: cm.HardwareSpec,
                             plans: dict[str, ModelPlan], policy: Policy,
                             sim_cfg: SimConfig | None = None
                             ) -> ServingMetrics:
    """The analytical side of the side-by-side comparison."""
    return Simulator(hw, plans, policy, sim_cfg).run(list(wl.arrivals))


def solo_footprint(plan: ModelPlan, hw: cm.HardwareSpec,
                units: int) -> tuple[float, float, float]:
    """Mean per-layer (bw, cache, ici) demand of a tenant's solo versions
    at ``units`` — the analytical footprint one active engine slot
    imposes on its co-runners."""
    vs = [s.solo_version() for s in plan.version_sets]
    itf0 = cm.Interference()
    n = len(vs) or 1
    bw = sum(cm.bw_demand(hw, v, units, itf0) for v in vs) / n
    cache = sum(cm.cache_demand(hw, v, units) for v in vs) / n
    ici = sum(cm.ici_demand(hw, v, units, itf0) for v in vs) / n
    return bw, cache, ici


plan_demand = solo_footprint


class TorchOnlineRuntime:
    """Admission/dispatch loop over a real TorchServingEngine (on the
    engine's device: the runtime moves no tensor itself).

    Each iteration: admit due arrivals into free slots, derive the live
    interference level from the policy, apply it to the engine's kernel
    dispatch, dispatch the next layer-block-sized quantum as ONE fused
    on-device call (``fused=True``, the default) or a single batched
    decode step (``fused=False``, the per-step baseline), and record
    completions as QueryRecords against each tenant's QoS deadline.

    In fused mode the policy's layer-block plan (``plan_chunk_at``)
    sets the dispatch quantum: the scheduler only intervenes at block
    boundaries, and the engine syncs the host exactly once per quantum
    (``engine.host_syncs`` / ``engine.tokens_per_sync`` measure it).
    Completions inside a quantum keep exact virtual finish times — the
    engine reports per-request executed steps.

    Admission is metered: a prompt is admitted as a queue of prefill
    *chunks* (``engine.admit_request`` + ``engine.prefill_step``), and
    each chunk is one scheduled quantum — it passes through the same
    counter poll / level switch as a decode quantum, advances the
    virtual clock, and is charged to ``busy``/``alloc``.  Prefill and
    decode quanta strictly alternate while both have work, so a long
    prompt stalls co-resident decodes for at most one chunk, and TTFT
    (``QueryRecord.ttft_s`` / ``ServingMetrics.avg_ttft_s``) is real
    virtual time, not zero.  Inadmissible prompts (``len >= max_len``)
    are rejected at admission and counted as conflicts.

    Scheduling (``scheduler=``): ``"slo"`` (default) picks every quantum
    by earliest deadline over the prefill queue and decode backlog
    (serving.slo.pick_quantum) — TTFT-urgent prefill chunks preempt
    decode quanta, batch-tier decodes yield — and admissions go in
    earliest-deadline order through the optional
    :class:`~repro.serving.slo.AdmissionController` (shed/defer counted
    in ``ServingMetrics.shed_queries``/``deferred_queries``).  ``"fifo"``
    keeps the legacy strict prefill/decode alternation and
    arrival-order admission.  Both orderings retire every request with
    identical per-request token streams — scheduling reorders quanta,
    never changes what a row computes."""

    def __init__(self, engine: ServingEngine, policy: Policy,
                 plans: dict[str, ModelPlan], hw: cm.HardwareSpec, *,
                 step_dt: float = 1e-3, wall_clock: bool = False,
                 max_steps: int = 200_000, seed: int = 0,
                 fused: bool = True, scheduler: str = "slo",
                 admission: AdmissionController | None = None,
                 tiers: dict[str, TierSpec] | None = None,
                 counter_source: str = "oracle",
                 refit_proxy: bool | None = None):
        if scheduler not in ("slo", "fifo"):
            raise ValueError(f"scheduler must be 'slo' or 'fifo', "
                             f"got {scheduler!r}")
        if counter_source not in ("oracle", "measured"):
            raise ValueError(f"counter_source must be 'oracle' or "
                             f"'measured', got {counter_source!r}")
        self.engine = engine
        self.policy = policy
        self.plans = plans
        self.hw = hw
        self.step_dt = step_dt
        self.wall_clock = wall_clock
        self.max_steps = max_steps
        self.fused = fused
        self.scheduler = scheduler
        self.admission = admission       # None = admit everything (legacy)
        self.book = DeadlineBook(tiers)
        # counter provenance: "oracle" synthesizes samples from the demand
        # sums (legacy, deterministic per seed); "measured" derives them
        # from the engine's per-quantum wall-time bank, falling back to
        # oracle while the bank is cold.  refit_proxy=None enables the
        # online RLS re-fit exactly when serving on measured counters.
        self.counter_source = counter_source
        self.refit_proxy = (counter_source == "measured"
                            if refit_proxy is None else bool(refit_proxy))
        self.counter_sources = collections.Counter()  # source label -> polls
        self._rng = np.random.default_rng(seed)   # counter-read noise
        self.records: list[QueryRecord] = []
        self.level_trace: list[float] = []
        self.sched_trace: list[tuple] = []  # ("prefill", rid, tier, t) |
                                            # ("decode", (rids...), t)
        self.outputs: dict[int, list[int]] = {}  # rid -> served tokens
        self.conflicts = 0
        self.shed = 0                    # rejected by admission control
        self.deferred = 0                # admissions delayed past arrival
        self.steps = 0
        self.quanta = 0                  # decode dispatch quanta issued
        self.prefill_quanta = 0          # prefill-chunk quanta issued
        self._prefill_last = False       # prefill/decode alternation state
        self._ttft: dict[int, float] = {}   # rid -> time to first token
        self._cursor = 0                 # layer-block cursor (fused mode)
        self._cursor_n = 1               # cursor modulus (head plan layers)
        # wall time spent inside set_interference_level: with a warmed
        # version cache this is pure dictionary swaps; without it, this is
        # where version builds land (and they ARE charged to latency in
        # wall_clock mode: the step timer starts before the switch)
        self.compile_time_s = 0.0
        # per-quantum record: (kind, steps or padded chunk, prompt
        # finished, dt charged).  In wall-clock mode dt is host wall from
        # before the version switch to the engine call's return: a decode
        # quantum and a finishing prefill chunk end in a host sync, so
        # theirs includes their device time; a non-final prefill chunk
        # does not sync, so its dt is the enqueue time and its device time
        # lands in the next quantum that syncs
        self.quantum_log: list[tuple[str, int, bool, float]] = []
        # analytical per-tenant footprint at the fair-share allocation
        units = max(1, hw.n_units // max(engine.slots, 1))
        self._demand = {name: plan_demand(plan, hw, units)
                        for name, plan in plans.items()}

    # ------------------------------------------------------------------
    @property
    def host_syncs(self) -> int:
        return self.engine.host_syncs

    @property
    def tokens_per_sync(self) -> float:
        return self.engine.tokens_per_sync

    def _plan_quantum(self, meta: dict, sample, now: float) -> int:
        """Dispatch-quantum length from the policy's layer-block plan:
        the head-of-line tenant's next block at the proxied pressure
        (Alg. 2/3) — block size == decode steps until the scheduler
        intervenes again.  Static policies yield their natural quanta
        (model-wise: a whole pass; fixed-block: K; layer-wise: 1)."""
        head = None
        for req in self.engine.slot_req:
            if req is None:
                continue
            tenant, _, admit = meta[req.rid]
            if head is None or admit < head[1]:
                head = (tenant, admit)
        if head is None:
            return 1
        plan = self.plans[head[0]]
        task = TaskState(tid=0, tenant=head[0], plan=plan,
                         arrival=head[1],
                         next_layer=self._cursor % plan.n_layers)
        itf = self.policy.interference_from_counters(sample)
        chunk = self.policy.plan_chunk_at(task, [task], itf, now,
                                          self.hw.n_units)
        # the cursor advances by the steps the engine actually EXECUTES
        # (see serve()), not by the planned chunk — a quantum truncated by
        # row budgets or the K-bucket cap must not let block boundaries
        # drift ahead of the work that ran
        self._cursor_n = plan.n_layers
        if chunk is None:
            return 1
        return max(chunk.end_layer - task.next_layer, 1)

    def _active_demands(self, meta: dict, now: float
                        ) -> list[RunningDemand]:
        out = []
        for slot, req in enumerate(self.engine.slot_req):
            if req is None:
                continue
            tenant, _, admit = meta[req.rid]
            bw, cache, ici = self._demand[tenant]
            horizon = admit + self.step_dt * (req.max_new_tokens + 1)
            out.append(RunningDemand(tenant=slot, bw=bw, cache=cache,
                                     ici=ici, start=admit,
                                     finish=max(horizon, now + self.step_dt)))
        return out

    def _admission_pass(self, pending: list, wl: Workload, prompts, lens,
                        meta: dict, rejected: set, deferred_rids: set,
                        shed_rids: set, now: float) -> None:
        """Admit due requests into free slots.  FIFO mode walks the queue
        in arrival order and stops at the first full-engine failure
        (legacy).  SLO mode walks it in earliest-deadline order —
        an urgent late arrival jumps the queue — and consults the
        admission controller, which may shed (drop + count) or defer
        (skip this pass + count) a request before QoS collapses."""
        if self.scheduler == "slo":
            order = sorted(pending,
                           key=lambda p: (self.book.entry(p[2]).deadline,
                                          p[0], p[2]))
        else:
            order = list(pending)
        for t, tenant, rid in order:
            req = Request(rid=rid, prompt=prompts[rid, :lens[rid]],
                          max_new_tokens=wl.max_new_tokens,
                          tier=wl.tier_of(tenant))
            if self.scheduler == "slo" and self.admission is not None:
                entry = self.book.entry(rid)
                pages_needed, pages_free = self.engine.admission_pages(
                    req.prompt, wl.max_new_tokens)
                decision = self.admission.decide(
                    now=now, entry=entry, spec=self.book.spec(entry.tier),
                    step_dt=self.step_dt,
                    own_chunks=len(self.engine._prefill_schedule(lens[rid])),
                    own_decode_steps=wl.max_new_tokens,
                    backlog_chunks=sum(
                        c for _, _, c in self.engine.prefill_queue()),
                    slot_free=self.engine.active_slots < self.engine.slots,
                    pages_needed=pages_needed, pages_free=pages_free)
                if decision == "shed":
                    self.shed += 1
                    shed_rids.add(rid)
                    pending.remove((t, tenant, rid))
                    self.book.drop(rid)
                    continue
                if decision == "defer":
                    if rid not in deferred_rids:
                        deferred_rids.add(rid)
                        self.deferred += 1
                    if self.engine.active_slots >= self.engine.slots:
                        break            # nothing can admit this pass
                    continue
            try:
                admitted = self.engine.admit_request(req)
            except ValueError:
                # inadmissible prompt (len >= max_len would corrupt the
                # cache row): a hard conflict — count once and drop,
                # never retry
                if rid not in rejected:
                    rejected.add(rid)
                    self.conflicts += 1
                pending.remove((t, tenant, rid))
                self.book.drop(rid)
                continue
            if not admitted:
                # engine full: a QoS conflict in the paper's sense,
                # counted once per query at its first failed admission
                if rid not in rejected:
                    rejected.add(rid)
                    self.conflicts += 1
                break
            meta[rid] = (tenant, t, now)
            if req.output:               # monolithic engines prefill
                self._ttft[rid] = now - t   # inside admit_request
            pending.remove((t, tenant, rid))

    def serve(self, wl: Workload) -> ServingMetrics:
        """Replay ``wl`` through the engine; returns ServingMetrics over
        the same records layout the simulator produces."""
        prompts = synth_prompts(wl.n_queries, wl.prompt_len,
                                self.engine.cfg.vocab_size, wl.seed)
        if wl.shared_prefix_len > 0:
            # system-prompt traffic: every query opens with one common
            # token run (deterministic per seed) — on a paged engine the
            # prefix index turns these into refcounted shared pages
            spl = min(wl.shared_prefix_len, prompts.shape[1])
            pre = np.random.default_rng(wl.seed + 0x9EF1).integers(
                0, self.engine.cfg.vocab_size, spl)
            prompts[:, :spl] = pre.astype(prompts.dtype)
        lens = wl.prompt_lengths()
        arrivals = collections.deque(
            (t, tenant, rid) for rid, (t, tenant)
            in enumerate(sorted(wl.arrivals)))
        pending: list = []
        meta: dict[int, tuple[str, float, float]] = {}
        rejected: set[int] = set()
        deferred_rids: set[int] = set()
        shed_rids: set[int] = set()
        now = 0.0
        busy = alloc = 0.0

        while arrivals or pending or \
                any(r is not None for r in self.engine.slot_req):
            if self.steps >= self.max_steps:
                break
            while arrivals and arrivals[0][0] <= now:
                t, tenant, rid = arrivals.popleft()
                self.book.register(rid, tenant, wl.tier_of(tenant), t,
                                   self.plans[tenant].qos_s)
                pending.append((t, tenant, rid))
            self._admission_pass(pending, wl, prompts, lens, meta,
                                 rejected, deferred_rids, shed_rids, now)
            n_active = self.engine.active_slots
            if n_active == 0:
                if arrivals:                 # idle: jump to next arrival
                    now = max(now, arrivals[0][0])
                    continue
                break

            # the counter loop: synthesize what the performance counters
            # would read under the live slot occupancy; the policy maps the
            # sample to a level through its calibrated proxy (victim=-1:
            # the engine observes the full co-runner pressure)
            demands = self._active_demands(meta, now)
            sample = read_counters(self.hw, -1, demands, now, self._rng,
                                   source=self.counter_source,
                                   bank=self.engine.counter_bank)
            self.counter_sources[sample.source] += 1
            if self.refit_proxy:
                # realized-pressure label: oracle truth where the sample
                # carries it, else the bank's slowdown-derived estimate
                target = (sample.truth if sample.truth is not None
                          else self.engine.counter_bank.pressure())
                if target is not None:
                    self.policy.observe_counters(sample, target)
            level = self.policy.level_from_counters(sample)
            # the step timer starts BEFORE the version switch: any build or
            # capture the switch triggers is real serving latency (the very
            # overhead adaptive compilation amortizes) and must be charged
            t0 = time.perf_counter()
            self.engine.set_interference_level(level)
            self.compile_time_s += time.perf_counter() - t0
            self.level_trace.append(level)

            # quantum pick.  FIFO mode: prefill chunks and decode quanta
            # strictly alternate while both have work — a long prompt
            # never stalls co-resident decodes for more than one chunk
            # (the granularity claim, applied to the admission path).
            # SLO mode: earliest-deadline order over both queues — a
            # TTFT-urgent prefill chunk preempts decode quanta, batch-
            # tier decodes yield, and a decode quantum's length is
            # capped by the tightest pending TTFT deadline.
            k_cap = self._plan_quantum(meta, sample, now) if self.fused \
                else 1
            pf_slot = None
            if self.scheduler == "slo":
                pick = pick_quantum(self.engine, self.book, now,
                                    self.step_dt, k_cap)
                do_prefill = pick is not None and pick[0] == "prefill"
                if do_prefill:
                    pf_slot = pick[1]
                elif pick is not None:
                    k_cap = pick[1]
            else:
                do_prefill = self.engine.should_prefill(self._prefill_last)
                self._prefill_last = do_prefill
            handle = None
            finished: list = []
            pf = None
            if do_prefill:
                pf = self.engine.prefill_step(pf_slot)
                steps_run = 1
                self.prefill_quanta += 1
                if pf is not None:
                    tier = self.book.get(pf.rid)
                    self.sched_trace.append(
                        ("prefill", pf.rid,
                         tier.tier if tier is not None else None, now))
            elif self.fused:
                handle = self.engine.begin_quantum(k_cap)
                if handle is not None:
                    self.sched_trace.append(("decode", tuple(
                        self.engine.slot_req[i].rid
                        for i in handle.active), now))
                finished = self.engine.finish_quantum(handle)
                steps_run = handle.steps if handle is not None else 1
                if handle is not None:
                    self._cursor = (self._cursor + handle.steps) \
                        % self._cursor_n
                self.quanta += 1
            else:
                handle = self.engine.begin_quantum(1, fused=False)
                if handle is not None:
                    self.sched_trace.append(("decode", tuple(
                        self.engine.slot_req[i].rid
                        for i in handle.active), now))
                finished = self.engine.finish_quantum(handle)
                handle = None           # per-step: legacy time accounting
                steps_run = 1
                self.quanta += 1        # a per-step dispatch is a 1-step
                                        # quantum (comparable records)
            dt = (time.perf_counter() - t0) if self.wall_clock \
                else self.step_dt * steps_run
            self.quantum_log.append(
                ("prefill", pf.chunk if pf is not None else 0,
                 pf is not None and pf.finished, dt) if do_prefill
                else ("decode", steps_run, False, dt))
            self.steps += steps_run
            t_begin = now
            now += dt
            if pf is not None:
                busy += dt                   # the one row being prefilled
                if pf.finished:
                    self._ttft[pf.rid] = now - meta[pf.rid][1]
            elif handle is not None and not self.wall_clock:
                # exact virtual accounting: each row was busy for the
                # steps it actually decoded, not the full quantum
                busy += float(handle.n_left.sum()) * self.step_dt
            else:
                busy += (n_active - self.engine.prefill_pending) * dt
            alloc += self.engine.slots * dt
            for req in finished:
                tenant, arrival, _ = meta[req.rid]
                fin = now
                if handle is not None and not self.wall_clock:
                    # row_steps is in tokens; a speculative quantum emits
                    # up to d+1 of them at its single sync, so the finish
                    # offset is capped at the quantum's clock steps
                    fin = t_begin + min(handle.row_steps[req.rid],
                                        handle.steps) * self.step_dt
                entry = self.book.get(req.rid)
                tiered = wl.tier_of(tenant) is not None
                self.records.append(QueryRecord(
                    tenant=tenant, arrival=arrival, finish=fin,
                    qos_s=self.plans[tenant].qos_s,
                    ttft_s=self._ttft.get(req.rid),
                    tier=(entry.tier if tiered and entry is not None
                          else "standard"),
                    deadline=(entry.deadline if tiered and entry is not None
                              else None)))
                self.outputs[req.rid] = list(req.output)
                self.book.drop(req.rid)

        return summarize(self.records, wl.qps,
                         self.conflicts / max(wl.n_queries, 1), busy, alloc,
                         shed=self.shed, deferred=self.deferred,
                         peak_cache_tokens=self.engine.peak_cache_tokens,
                         cache_utilization=self.engine.cache_utilization,
                         proxy_rms_error=self.policy.proxy_rms_error,
                         refit_count=self.policy.proxy_refits,
                         tokens_accepted=self.engine.tokens_accepted,
                         draft_hit_rate=self.engine.draft_hit_rate,
                         spec_rollbacks=self.engine.spec_rollbacks)


OnlineRuntime = TorchOnlineRuntime
