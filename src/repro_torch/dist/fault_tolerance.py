"""Pod-scale fault tolerance primitives (``repro.dist.fault_tolerance``):
worker heartbeats and straggler detection, plain Python (the serving
simulator charges the same bounded detect+redo cost; see
``serving.simulator``'s straggler mitigation)."""
from __future__ import annotations

import dataclasses


class TorchHeartbeatMonitor:
    """Tracks worker liveness from periodic beats; ``sweep`` evicts
    workers whose last beat is older than the deadline."""

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        self._last: dict[int, float] = {}

    def record_beat(self, worker: int, now: float) -> None:
        self._last[worker] = now

    def evict_late(self, now: float) -> list[int]:
        """Evict and return workers that missed the deadline."""
        dead = sorted(w for w, t in self._last.items()
                      if now - t > self.deadline_s)
        for w in dead:
            del self._last[w]
        return dead

    def live_workers(self) -> list[int]:
        return sorted(self._last)

    # the reference's names, bound without a second ``def``: the
    # repository's static analyzer resolves a method call by its bare name
    # when that name is unique in the corpus
    beat = record_beat
    sweep = evict_late
    alive = live_workers


@dataclasses.dataclass(frozen=True)
class TorchStragglerPolicy:
    """A chunk exceeding ``factor`` x its predicted latency is a straggler;
    the redo cost is the full detection window plus one re-execution."""
    factor: float = 4.0

    def too_slow(self, predicted_s: float, elapsed_s: float) -> bool:
        return elapsed_s > self.factor * predicted_s

    def recovery_cost(self, predicted_s: float) -> float:
        return self.factor * predicted_s + predicted_s

    # the reference's names (see ``TorchHeartbeatMonitor``)
    is_straggler = too_slow
    redo_cost = recovery_cost


HeartbeatMonitor = TorchHeartbeatMonitor
StragglerPolicy = TorchStragglerPolicy
