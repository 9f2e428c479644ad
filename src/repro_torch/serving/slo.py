"""A copy of ``repro.serving.slo`` (pure Python). Classes carry ``Torch*``
names with the reference's names as aliases (see
``repro_torch.core.cost_model``). Names the reference's own code reaches
by being unique in the repository are defined under port names and bound
to the reference's: ``pick_quantum = edf_pick`` and
``AdmissionController.decide = admit_decision`` (the static analyzer,
repro.analysis.callgraph, would otherwise find two definitions and
resolve the reference's calls to neither).

SLO-tiered quantum scheduling and slack-aware admission control.

VELTAIR's headline metric is queries served *under a QoS target*
(paper §6), and PREMA's latency-tier scheduling is the model: every
schedulable unit — a prefill chunk or a fused decode quantum — carries
a deadline-derived urgency, and the runtime picks the next quantum by
earliest deadline instead of FIFO alternation.  Three pieces live here,
shared by ``OnlineRuntime`` and ``ClusterRuntime``:

* :class:`DeadlineBook` — per-request deadline bookkeeping.  A request's
  tier (``interactive``/``standard``/``batch``) scales its tenant's base
  QoS target into an absolute finish deadline and a TTFT sub-deadline
  (core.qos.TierSpec).
* :func:`pick_quantum` — the earliest-deadline pick over the engine's
  prefill queue and decode backlog, with a shortest-remaining-work
  tie-break (pure least-slack degenerates to round-robin on equal
  deadlines, and SRPT is the finisher: it retires queries, which is
  what qps_at_qos counts).  TTFT-urgent prefill chunks preempt decode
  quanta; batch-tier decodes yield; a decode quantum's length is capped
  by the tightest pending TTFT deadline so an urgent admission is never
  stuck behind a 16-step fused block.
* :class:`AdmissionController` — sheds or defers load *before* QoS
  collapses: a sheddable-tier request whose estimated finish already
  overruns its deadline at admission time is rejected (counted, never
  silently dropped); batch-tier and engine-full admissions defer.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.qos import DEFAULT_TIERS, TierSpec, tier_spec


@dataclasses.dataclass(frozen=True)
class TorchSloEntry:
    """Deadline state for one in-flight request."""
    rid: int
    tenant: str
    tier: str | None            # None = untiered legacy request
    arrival: float
    qos_s: float
    deadline: float             # absolute finish deadline (ordering; only
                                # written to the QueryRecord when tiered)
    ttft_deadline: float        # absolute first-token deadline

    def slack(self, now: float) -> float:
        return self.deadline - now


SloEntry = TorchSloEntry


class TorchDeadlineBook:
    """rid -> :class:`SloEntry` map both runtimes order quanta by.

    Untiered requests (``tier=None``) get *standard*-tier deadlines for
    ordering purposes only — their QueryRecords keep the legacy
    ``latency <= qos_s`` satisfaction semantics."""

    def __init__(self, tiers: dict[str, TierSpec] | None = None):
        self.tiers = tiers or DEFAULT_TIERS
        self._entries: dict[int, SloEntry] = {}

    def register(self, rid: int, tenant: str, tier: str | None,
                 arrival: float, qos_s: float) -> SloEntry:
        spec = tier_spec(tier, self.tiers)
        deadline = arrival + spec.deadline_scale * qos_s
        e = SloEntry(rid=rid, tenant=tenant, tier=tier, arrival=arrival,
                     qos_s=qos_s, deadline=deadline,
                     ttft_deadline=arrival + spec.ttft_frac
                     * spec.deadline_scale * qos_s)
        self._entries[rid] = e
        return e

    def entry(self, rid: int) -> SloEntry:
        return self._entries[rid]

    def get(self, rid: int) -> SloEntry | None:
        return self._entries.get(rid)

    def drop(self, rid: int) -> None:
        self._entries.pop(rid, None)

    def spec(self, tier: str | None) -> TierSpec:
        return tier_spec(tier, self.tiers)


DeadlineBook = TorchDeadlineBook


def edf_pick(engine, book: DeadlineBook, now: float, step_dt: float,
                 k_max: int) -> tuple[str, int] | None:
    """Earliest-deadline pick over one engine's schedulable units.

    Returns ``("prefill", slot)`` — run that slot's next chunk — or
    ``("decode", k)`` — run a fused decode quantum of ``k`` steps — or
    ``None`` when the engine is idle.  Ordering keys:

    * prefill chunk for slot s:  (TTFT deadline, chunks left, s)
    * decode quantum:            (earliest finish deadline among
                                  decodable rows, tokens left, s)

    A decode pick's ``k`` is clamped so the quantum ends before the
    tightest *pending* TTFT deadline — urgency preempts at the quantum
    boundary, never mid-executable (token streams stay exact)."""
    prefill = engine.prefill_queue()
    decode = engine.decode_backlog()
    if not prefill and not decode:
        return None

    def pkey(item):
        slot, rid, chunks_left = item
        e = book.get(rid)
        dl = e.ttft_deadline if e is not None else math.inf
        return (dl, chunks_left, slot)

    def dkey(item):
        slot, rid, toks_left = item
        e = book.get(rid)
        dl = e.deadline if e is not None else math.inf
        return (dl, toks_left, slot)

    # memory is a scheduling dimension on paged engines: a quantum longer
    # than the free-page headroom would stall rows mid-quantum, so clamp
    # k up front (dense engines pass k through unchanged)
    headroom = getattr(engine, "decode_k_headroom", None)
    k_mem = headroom(k_max) if callable(headroom) else k_max
    if not decode:
        return ("prefill", min(prefill, key=pkey)[0])
    if not prefill:
        return ("decode", k_mem)
    best_p = min(prefill, key=pkey)
    best_d = min(decode, key=dkey)
    p_dl = pkey(best_p)[0]
    if p_dl <= dkey(best_d)[0]:
        return ("prefill", best_p[0])
    # decode wins now, but end the quantum before the tightest pending
    # TTFT deadline comes due (each chunk/step costs ~step_dt).  On a
    # speculative engine a "step" emits ~expected_accept tokens (the
    # engine's acceptance EWMA), so the same wall slack buys a deeper
    # token quantum — without this the scheduler would under-fill spec
    # quanta exactly when drafts are landing
    slack_steps = int((p_dl - now) / step_dt) - best_p[2]
    tpq = getattr(engine, "expected_accept_per_step", None)
    if callable(tpq):
        slack_steps = int(slack_steps * max(1.0, float(tpq())))
    return ("decode", max(1, min(k_mem, slack_steps)))


pick_quantum = edf_pick


@dataclasses.dataclass
class TorchAdmissionController:
    """Slack-aware admission: shed hopeless sheddable-tier requests and
    defer the rest, *before* they drag every co-resident query past its
    deadline.

    The finish estimate is deliberately coarse — serial backlog chunks
    plus the request's own prefill chunks and decode steps, each costing
    ~``step_dt`` — because admission only has to be right about
    *hopeless* requests (estimated finish already past the deadline with
    ``headroom`` slack).  Batch tier is never shed (``sheddable=False``):
    it defers until a slot frees up."""
    headroom: float = 1.0       # shed when est_finish > arrival-relative
                                # deadline stretched by this factor

    def admit_decision(self, *, now: float, entry: SloEntry, spec: TierSpec,
               step_dt: float, own_chunks: int, own_decode_steps: int,
               backlog_chunks: int, slot_free: bool, pages_needed: int = 0,
               pages_free: int | None = None) -> str:
        """One of ``"admit"`` / ``"defer"`` / ``"shed"``.

        ``pages_needed`` / ``pages_free`` make memory an admission
        dimension on paged engines: a request whose worst-case page
        commitment (net of shareable prefix pages) exceeds the pool's
        uncommitted surplus defers — occupancy-slot *and* page-pool
        exhaustion are both counted, never silent.  Dense engines pass
        ``pages_free=None`` (no page gate)."""
        if not slot_free:
            return "defer"
        if pages_free is not None and pages_needed > pages_free:
            return "defer"
        est_steps = backlog_chunks + own_chunks + own_decode_steps
        est_finish = now + est_steps * step_dt
        budget = entry.arrival + self.headroom * (entry.deadline
                                                  - entry.arrival)
        if spec.sheddable and est_finish > budget:
            return "shed"
        return "admit"

    decide = admit_decision


AdmissionController = TorchAdmissionController
