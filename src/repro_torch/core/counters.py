"""Measured performance counters from per-quantum wall times.

The measurement half of the adaptive-compilation loop (a copy of
``repro.core.counters``).  The engine timestamps every synced
dispatch quantum, and the bank turns those (kind, K-bucket, tiles)
observations into a slowdown estimate:

    slowdown = median(recent wall) / baseline wall        (per shape key)

where the baseline is the fastest wall ever observed for that key, and
maps it back to a pressure level as ``clip((slowdown - 1) / BW_AT_1, 0,
1)`` (the fair-share model: memory time under co-runner bandwidth demand
``bw`` scales by ``1 + bw``).
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.core.cost_model import (HardwareSpec, Interference,
                                         level_interference)
from repro_torch.core.interference import (CounterSample,
                                           synthesize_counters)

SLOWDOWN_AT_1 = Interference.BW_AT_1

WINDOW = 64            # recent observations pooled per slowdown estimate
MIN_KEY_OBS = 2        # observations before a key's floor is trusted


@dataclasses.dataclass(frozen=True)
class QuantumObservation:
    """One timed dispatch quantum (as recorded by the engine)."""
    kind: str            # "decode" | "prefill" | "spec" (speculative
                         # verify quanta get floors of their own: one
                         # (B, d+1) forward is another shape class than K
                         # decode steps, and pooling them would corrupt
                         # both baselines)
    bucket: int          # K-bucket (decode) / padded chunk size (prefill)
    tiles: tuple         # version-cache tiles key of the active version
    wall_s: float        # measured wall time, sync to sync
    tokens: int = 0      # tokens the quantum produced/consumed
    co_runners: int = 0  # co-resident active slots elsewhere (observability)
    t: float = 0.0       # virtual time of the observation

    @property
    def key(self) -> tuple:
        return (self.kind, self.bucket, self.tiles)


class TorchCounterBank:
    """Sliding-window slowdown estimator over timed dispatch quanta (one
    bank per engine)."""

    def __init__(self, *, window: int = WINDOW,
                 min_key_obs: int = MIN_KEY_OBS):
        self.window = int(window)
        self.min_key_obs = int(min_key_obs)
        self._floor: dict[tuple, float] = {}    # key -> fastest wall seen
        self._count: dict[tuple, int] = {}      # key -> observations
        self._recent: collections.deque = collections.deque(
            maxlen=self.window)
        self.observations = 0

    def observe(self, kind: str, bucket: int, tiles: tuple,
                wall_s: float, *, tokens: int = 0, co_runners: int = 0,
                t: float = 0.0) -> QuantumObservation:
        """Record one timed quantum; returns the stored observation."""
        obs = QuantumObservation(kind=str(kind), bucket=int(bucket),
                                 tiles=tuple(tiles), wall_s=float(wall_s),
                                 tokens=int(tokens),
                                 co_runners=int(co_runners), t=float(t))
        if obs.wall_s <= 0.0:
            return obs
        key = obs.key
        floor = self._floor.get(key)
        if floor is None or obs.wall_s < floor:
            self._floor[key] = obs.wall_s
        self._count[key] = self._count.get(key, 0) + 1
        self._recent.append(obs)
        self.observations += 1
        return obs

    @property
    def last(self) -> QuantumObservation | None:
        return self._recent[-1] if self._recent else None

    def slowdown(self) -> float | None:
        """Median wall/floor ratio over the recent window (>= 1.0 by
        construction), or None while cold."""
        ratios = [obs.wall_s / self._floor[obs.key]
                  for obs in self._recent
                  if self._count.get(obs.key, 0) >= self.min_key_obs]
        if not ratios:
            return None
        return float(np.median(ratios))

    def level(self) -> float | None:
        s = self.slowdown()
        if s is None:
            return None
        return float(np.clip((s - 1.0) / SLOWDOWN_AT_1, 0.0, 1.0))

    def pressure(self) -> Interference | None:
        """Measured pressure estimate."""
        lvl = self.level()
        if lvl is None:
            return None
        return level_interference(lvl)

    def measured_sample(self, hw: HardwareSpec,
                        now: float) -> CounterSample | None:
        """The measured counter poll: re-express the bank's pressure in
        counter units (deterministic response curve: the measurement
        noise is already in the wall times) as a ``source="measured"``
        sample, or None while cold."""
        itf = self.pressure()
        if itf is None:
            return None
        values = synthesize_counters(hw, itf, None, noise_scale=0.0)
        return CounterSample(values=values, t=now, truth=None,
                             source="measured")

    # the reference's name, bound without a second ``def``: the static
    # analyzer resolves the reference's ``bank.sample(...)`` by the
    # method name being unique
    sample = measured_sample


# The class has its own name and the reference's name is an alias: the
# repository's static analyzer (repro.analysis.callgraph) keys classes by
# bare name, and a second class named CounterBank would merge with the
# reference's and shrink the reference's audited hot path.
CounterBank = TorchCounterBank
