"""A copy of ``repro.core.allocator`` (pure Python). Classes carry
``Torch*`` names with the reference's names as aliases (see
``repro_torch.core.cost_model``).

Unit (core/chip) pool with conflict accounting.

One :class:`UnitPool` is the single shared hardware resource both online
paths partition: the simulator allocates per layer-block chunk, the
co-location cluster (``repro.serving.cluster``) re-partitions it across
engines at every scheduling quantum.  Invariant: ``free + used == total``
at all times, so the sum of outstanding grants can never exceed
``hw.n_units``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TorchUnitPool:
    total: int
    free: int = -1
    conflicts: int = 0
    requests: int = 0
    peak_used: int = 0

    def __post_init__(self):
        if self.free < 0:
            self.free = self.total

    @property
    def used(self) -> int:
        return self.total - self.free

    def try_alloc(self, n: int) -> int:
        """Allocate up to n units; returns the number granted (0 if none
        free).  A grant below the request counts as a scheduling conflict."""
        return self.try_alloc_range(n, n)

    def try_alloc_range(self, lo: int, hi: int) -> int:
        """Work-conserving range allocation: grant up to ``hi`` units from
        whatever is free; a grant below the QoS-minimum ``lo`` counts as a
        scheduling conflict (the caller may still run degraded on the
        partial grant, or stall on a zero grant)."""
        self.requests += 1
        grant = min(hi, self.free)
        if grant < lo:
            self.conflicts += 1
        self.free -= grant
        self.peak_used = max(self.peak_used, self.used)
        return grant

    def release(self, n: int) -> None:
        self.free += n
        assert self.free <= self.total, "double free"

    @property
    def conflict_rate(self) -> float:
        return self.conflicts / self.requests if self.requests else 0.0


UnitPool = TorchUnitPool
