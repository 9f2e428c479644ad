"""A copy of ``repro.core.qos`` (pure Python and numpy). Classes carry
``Torch*`` names with the reference's names as aliases (see
``repro_torch.core.cost_model``). Names the reference's own code reaches
by being unique in the repository are defined under port names and bound
to the reference's: ``summarize = metrics_from_records`` and ``tier_spec
= resolve_tier`` (the static analyzer, repro.analysis.callgraph, would
otherwise find two definitions and resolve the reference's calls to
neither).

QoS targets, SLO tiers, satisfaction tracking and serving metrics.

Tier model (paper §scheduling, PREMA-style latency tiers): every request
belongs to one of three SLO tiers.  A tier scales the tenant's base QoS
target into an absolute *deadline* (``arrival + deadline_scale *
qos_s``) and carves out a TTFT sub-deadline (``arrival + ttft_frac *
deadline_scale * qos_s``) for the first token.  Schedulers order
quanta by earliest deadline; the admission controller may shed work
from ``sheddable`` tiers whose deadline is already hopeless.

Untiered records (``deadline is None``) keep the legacy semantics:
satisfied iff ``latency <= qos_s``.  That keeps every pre-existing
workload's qos_rate bit-identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np

TIER_ORDER = ("interactive", "standard", "batch")


@dataclasses.dataclass(frozen=True)
class TorchTierSpec:
    """One SLO tier: how a tenant's base QoS target becomes a deadline."""
    name: str
    deadline_scale: float     # deadline = arrival + deadline_scale * qos_s
    ttft_frac: float          # TTFT deadline = arrival + ttft_frac * scale*qos
    sheddable: bool           # admission may reject when deadline is hopeless


TierSpec = TorchTierSpec


DEFAULT_TIERS: dict[str, TierSpec] = {
    "interactive": TierSpec("interactive", 1.0, 0.4, sheddable=True),
    "standard": TierSpec("standard", 2.5, 0.6, sheddable=True),
    "batch": TierSpec("batch", 8.0, 1.0, sheddable=False),
}


def resolve_tier(name: str | None,
              tiers: dict[str, TierSpec] | None = None) -> TierSpec:
    """Resolve a tier name (``None`` -> standard) to its spec."""
    table = tiers or DEFAULT_TIERS
    if name is None:
        return table["standard"]
    if name not in table:
        raise ValueError(f"unknown SLO tier {name!r}; "
                         f"expected one of {sorted(table)}")
    return table[name]


tier_spec = resolve_tier


@dataclasses.dataclass
class TorchQueryRecord:
    tenant: str
    arrival: float
    finish: float
    qos_s: float
    units_time: float = 0.0          # integral of units x time (efficiency)
    ttft_s: float | None = None      # time to first token (metered prefill;
                                     # None where the path cannot observe it)
    tier: str = "standard"           # SLO tier label (reporting only unless
                                     # deadline is set)
    deadline: float | None = None    # absolute deadline; None = legacy
                                     # qos_s-relative satisfaction

    @property
    def latency(self) -> float:
        return self.finish - self.arrival

    @property
    def satisfied(self) -> bool:
        if self.deadline is not None:
            return self.finish <= self.deadline
        return self.latency <= self.qos_s


QueryRecord = TorchQueryRecord


@dataclasses.dataclass
class TorchTierMetrics:
    """Per-tier slice of the same record schema both runtimes emit."""
    n_queries: int
    qos_rate: float
    avg_latency_s: float
    p99_latency_s: float
    avg_ttft_s: float = 0.0


TierMetrics = TorchTierMetrics


@dataclasses.dataclass
class TorchServingMetrics:
    qps_offered: float
    qos_rate: float                 # fraction of queries meeting QoS
    avg_latency_s: float
    p99_latency_s: float
    conflict_rate: float
    avg_units: float                # mean units used by running queries
    unit_efficiency: float          # useful busy-time / allocated unit-time
    n_queries: int = 0              # completed queries behind these numbers
    avg_ttft_s: float = 0.0         # mean time-to-first-token over records
                                    # that observed one (0.0 otherwise)
    qps_at_qos: float = 0.0         # queries served *under QoS* per second
                                    # over the serving span (headline)
    shed_queries: int = 0           # rejected by admission control (counted,
                                    # never silently dropped)
    deferred_queries: int = 0       # admissions delayed past arrival by the
                                    # admission controller
    peak_cache_tokens: int = 0      # max tokens live requests held resident
                                    # at once (KV-cache occupancy high-water)
    cache_utilization: float = 0.0  # peak valid tokens / resident capacity —
                                    # dense pins slots*max_len, paged pins
                                    # allocated pages (shared pages counted
                                    # once, so sharing can push this past 1)
    proxy_rms_error: float = float("nan")  # sliding-window RMS residual of
                                    # the policy's pressure proxy (NaN for
                                    # policies without one / oracle runs
                                    # that never feed it)
    refit_count: int = 0            # drift-triggered online proxy refits
    tokens_accepted: int = 0        # draft tokens accepted by speculative
                                    # verify quanta (0 on non-spec runs)
    draft_hit_rate: float = 0.0     # tokens_accepted / tokens_drafted —
                                    # the workload's speculation quality
    spec_rollbacks: int = 0         # spec quanta where >= 1 draft position
                                    # was rejected and rolled back
    per_tier: dict[str, TierMetrics] = dataclasses.field(default_factory=dict)


ServingMetrics = TorchServingMetrics


def _tier_slice(records: list[QueryRecord]) -> TierMetrics:
    lats = np.array([r.latency for r in records])
    ttfts = [r.ttft_s for r in records if r.ttft_s is not None]
    return TierMetrics(
        n_queries=len(records),
        qos_rate=float(np.mean([r.satisfied for r in records])),
        avg_latency_s=float(lats.mean()),
        p99_latency_s=float(np.percentile(lats, 99)),
        avg_ttft_s=float(np.mean(ttfts)) if ttfts else 0.0,
    )


def metrics_from_records(records: list[QueryRecord], qps_offered: float,
              conflict_rate: float, busy_unit_time: float,
              alloc_unit_time: float, *, shed: int = 0,
              deferred: int = 0, peak_cache_tokens: int = 0,
              cache_utilization: float = 0.0,
              proxy_rms_error: float = float("nan"),
              refit_count: int = 0, tokens_accepted: int = 0,
              draft_hit_rate: float = 0.0,
              spec_rollbacks: int = 0) -> ServingMetrics:
    """The one record->metrics reduction.  Both ``OnlineRuntime.serve``
    and ``ClusterRuntime.serve`` (per tenant and aggregate) funnel their
    tier-labelled ``QueryRecord``s through here, so per-tier
    qos_rate/TTFT/p99 report identically from either path."""
    if not records:
        return ServingMetrics(qps_offered, 0.0, float("inf"), float("inf"),
                              conflict_rate, 0.0, 0.0,
                              shed_queries=shed, deferred_queries=deferred,
                              peak_cache_tokens=peak_cache_tokens,
                              cache_utilization=cache_utilization,
                              proxy_rms_error=proxy_rms_error,
                              refit_count=refit_count,
                              tokens_accepted=tokens_accepted,
                              draft_hit_rate=draft_hit_rate,
                              spec_rollbacks=spec_rollbacks)
    lats = np.array([r.latency for r in records])
    sat = np.mean([r.satisfied for r in records])
    span = max(max(r.finish for r in records)
               - min(r.arrival for r in records), 1e-9)
    avg_units = alloc_unit_time / span
    eff = busy_unit_time / alloc_unit_time if alloc_unit_time > 0 else 0.0
    ttfts = [r.ttft_s for r in records if r.ttft_s is not None]
    n_sat = int(sum(r.satisfied for r in records))
    per_tier: dict[str, TierMetrics] = {}
    for tier in TIER_ORDER:
        rs = [r for r in records if r.tier == tier]
        if rs:
            per_tier[tier] = _tier_slice(rs)
    return ServingMetrics(
        qps_offered=qps_offered,
        qos_rate=float(sat),
        avg_latency_s=float(lats.mean()),
        p99_latency_s=float(np.percentile(lats, 99)),
        conflict_rate=conflict_rate,
        avg_units=float(avg_units),
        unit_efficiency=float(eff),
        n_queries=len(records),
        avg_ttft_s=float(np.mean(ttfts)) if ttfts else 0.0,
        qps_at_qos=n_sat / span,
        shed_queries=shed,
        deferred_queries=deferred,
        peak_cache_tokens=peak_cache_tokens,
        cache_utilization=cache_utilization,
        proxy_rms_error=proxy_rms_error,
        refit_count=refit_count,
        tokens_accepted=tokens_accepted,
        draft_hit_rate=draft_hit_rate,
        spec_rollbacks=spec_rollbacks,
        per_tier=per_tier,
    )


summarize = metrics_from_records


def compare_metrics(a: ServingMetrics,
                    b: ServingMetrics) -> dict[str, tuple[float, float]]:
    """Field-by-field (a, b) pairs — side-by-side comparison of the same
    workload replayed through the simulator and the real engine."""
    return {f.name: (getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(ServingMetrics)
            if f.name != "per_tier"}


def qps_at_qos(sweep: list[tuple[float, ServingMetrics]],
               target: float = 0.95) -> float:
    """Max offered QPS whose QoS satisfaction rate stays >= target
    (MLPerf-server style metric), linearly interpolated between grid
    points (rate -> 1.0 as qps -> 0)."""
    pts = sorted((q, m.qos_rate) for q, m in sweep)
    prev_q, prev_r = 0.0, 1.0
    best = 0.0
    for q, r in pts:
        if r >= target:
            best = q
            prev_q, prev_r = q, r
            continue
        if prev_r > target >= r and prev_r > r:
            best = max(best, prev_q + (q - prev_q)
                       * (prev_r - target) / (prev_r - r))
        prev_q, prev_r = q, r
    return best
