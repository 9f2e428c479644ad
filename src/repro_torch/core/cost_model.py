"""The interference-level grid the serving engine selects code versions on.

A copy of the part of ``repro.core.cost_model`` the engine uses:
``Interference`` (co-runner demand sums, fair-share model), the ten
paper levels, and the level <-> grid-index mapping.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Interference:
    """Co-runner demand sums on each shared resource (fair-share model).

    Each field is the SUM of co-runner demands as a fraction of capacity
    (may exceed 1 under oversubscription)."""
    cache: float = 0.0    # co-runner shared-cache claims
    bw: float = 0.0       # co-runner memory-bandwidth demand
    ici: float = 0.0      # co-runner link demand

    # level <-> resource mapping: level 1.0 == heavy co-location (shared
    # cache 2x oversubscribed, bandwidth demand 1.5x capacity)
    CACHE_AT_1 = 2.0
    BW_AT_1 = 1.5
    ICI_AT_1 = 1.5

    @property
    def level(self) -> float:
        """Scalar pressure (what the paper's 10 discrete levels index)."""
        return min(max(self.cache / self.CACHE_AT_1,
                       self.bw / self.BW_AT_1,
                       self.ici / self.ICI_AT_1), 1.0)


def level_interference(x: float) -> Interference:
    """The demand sums at pressure level ``x`` (the reference's
    ``Interference.from_level``; a function here, because a second method
    of that name would be ambiguous to the repository's static
    analyzer)."""
    x = min(max(x, 0.0), 1.0)
    return Interference(cache=Interference.CACHE_AT_1 * x,
                        bw=Interference.BW_AT_1 * x,
                        ici=Interference.ICI_AT_1 * x)


NUM_LEVELS = 10  # paper: ten interference levels


def grid_point(i: int) -> float:
    """Level of grid index i.  Quadratically denser near 1.0 (version
    crossovers concentrate at high pressure)."""
    return (i / (NUM_LEVELS - 1)) ** 0.5


def level_to_idx(level: float) -> int:
    x = min(max(level, 0.0), 1.0)
    return min(int(round(x * x * (NUM_LEVELS - 1))), NUM_LEVELS - 1)
