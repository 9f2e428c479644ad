"""A copy of ``repro.core.interference`` (pure Python and numpy). Classes
carry ``Torch*`` names with the reference's names as aliases (see
``repro_torch.core.cost_model``). Names the reference's own code reaches
by being unique in the repository are defined under port names and bound
to the reference's: ``read_counters = poll_counters``,
``synthesize_counters = counters_at_pressure``,
``pca_variance = variance_shares`` and
``RunningDemand.soon_done = finishing_soon`` (the static analyzer,
repro.analysis.callgraph, would otherwise find two definitions and
resolve the reference's calls to neither).

Interference pressure accounting + the linear performance-counter proxy.

The *true* pressure a task experiences is the sum of the shared-resource
demands of its co-runners (cost_model.bw_demand / cache_demand /
ici_demand).  The paper instead reads hardware counters and maps them to a
pressure level with a linear model (L3 miss rate + L3 accesses explain >99%
of variance, Fig. 11).  We reproduce both sides:

  * ``pressure_on``      — ground truth from co-runner demand sums
                           (what the simulator charges latencies with);
  * ``CounterSample``    — the "performance counters" a running system
                           would read (synthesized from the same demands,
                           plus distractor counters for the PCA experiment);
  * ``LinearProxy``      — fit on (counters -> level) calibration pairs,
                           used by the *scheduler* at run time, so the
                           scheduler sees proxy error like the real system.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.core.cost_model import (HardwareSpec, Interference,
                                   level_interference)

SOON_FINISH_FRACTION = 0.10   # paper: ignore blocks with <10% latency left

# Online proxy re-fit (sliding-window recursive least squares): the proxy
# keeps tracking the counter->pressure mapping as traffic drifts away from
# the offline calibration distribution.
RLS_WINDOW = 128      # (counter, pressure) pairs kept for window refits
RLS_FORGET = 0.97     # exponential forgetting factor (per update)
DRIFT_WINDOW = 16     # residuals pooled for the drift detector
DRIFT_SPIKE = 3.0     # recent RMS > spike * calibration RMS => refit


@dataclasses.dataclass
class TorchRunningDemand:
    """Resource demand of one running layer-block (computed at start)."""
    tenant: int
    bw: float
    cache: float
    ici: float
    start: float
    finish: float

    def finishing_soon(self, now: float) -> bool:
        span = max(self.finish - self.start, 1e-12)
        return (self.finish - now) / span < SOON_FINISH_FRACTION

    soon_done = finishing_soon


RunningDemand = TorchRunningDemand


def pressure_on(tenant: int, demands: list[RunningDemand], now: float,
                *, exclude_soon_done: bool = True) -> Interference:
    """Interference experienced by ``tenant``: sum of everyone else's
    demands (fair-share model; sums may exceed 1, capped for sanity)."""
    bw = cache = ici = 0.0
    for d in demands:
        if d.tenant == tenant:
            continue
        if exclude_soon_done and d.soon_done(now):
            continue
        bw += d.bw
        cache += d.cache
        ici += d.ici
    return Interference(cache=min(cache, 4.0), bw=min(bw, 4.0),
                        ici=min(ici, 4.0))


# --------------------------------------------------------------------------
# Synthesized performance counters + linear proxy (paper Fig. 11)
# --------------------------------------------------------------------------
COUNTER_NAMES = ("l3_miss_rate", "l3_accesses", "ipc", "flop_rate",
                 "branch_rate", "frontend_stalls")


@dataclasses.dataclass
class TorchCounterSample:
    """One performance-counter read (what a PMU poll would return).

    ``values`` follows :data:`COUNTER_NAMES` order; only the first two
    (the L3 counters) carry the interference signal the proxy consumes.
    ``truth`` is the ground-truth pressure the counters were synthesized
    from — it exists for calibration and proxy-accuracy tests ONLY and
    must never feed a scheduling decision (the runtime's level decisions
    flow through :class:`LinearProxy`, like the real system's).

    ``source`` records which sensor produced the sample: ``"oracle"``
    (synthesized from co-runner demand sums — the simulator/test path)
    or ``"measured"`` (derived from per-quantum wall times by a
    :class:`~repro.core.counters.CounterBank`; ``truth`` is None there,
    because a real system has no oracle)."""
    values: np.ndarray
    t: float
    truth: Interference | None = None
    source: str = "oracle"


CounterSample = TorchCounterSample


def poll_counters(hw: HardwareSpec, victim: int,
                  demands: list[RunningDemand], now: float,
                  rng: np.random.Generator, *,
                  exclude_soon_done: bool = True,
                  source: str = "oracle",
                  bank=None) -> CounterSample:
    """Poll the performance counters as seen by ``victim``.

    ``source="oracle"`` (default — the simulator/test path, and exactly
    the pre-measurement behavior): the true co-runner pressure decides
    what the counters *would read*; the proxy then maps the noisy counter
    values back to a pressure estimate, so the scheduler experiences
    proxy error exactly like the deployed system.  ``victim=-1`` matches
    no running demand, i.e. the caller observes the full co-runner
    pressure (an engine asking "what hits me right now").

    ``source="measured"``: the sample comes from ``bank`` (a
    :class:`~repro.core.counters.CounterBank` fed by the engine's
    per-quantum wall times) — no oracle is consulted and ``truth`` is
    None.  A cold bank (no usable observations yet) falls back to the
    oracle synthesizer for this poll; the returned sample is labelled
    ``"oracle"`` so callers can count how often the fallback fired."""
    if source not in ("oracle", "measured"):
        raise ValueError(f"counter source {source!r} not in "
                         "('oracle', 'measured')")
    if source == "measured":
        if bank is None:
            raise ValueError("source='measured' needs a CounterBank")
        sample = bank.sample(hw, now)
        if sample is not None:
            return sample
    truth = pressure_on(victim, demands, now,
                        exclude_soon_done=exclude_soon_done)
    values = synthesize_counters(hw, truth, rng)
    return CounterSample(values=values, t=now, truth=truth)


read_counters = poll_counters


def counters_at_pressure(hw: HardwareSpec, itf: Interference,
                        rng: np.random.Generator | None,
                        noise_scale: float = 1.0) -> np.ndarray:
    """What the perf counters would read under pressure ``itf``.

    L3-related counters respond to the shared-resource pressure (that is the
    paper's PCA finding); IPC responds inversely; the rest are distractors
    with small variance.  ``noise_scale=0.0`` gives the deterministic
    response curve (the CounterBank uses it to express a *measured*
    pressure in counter units — the transport format the proxy consumes —
    without injecting synthetic sensor noise); ``rng`` may then be None."""
    c = min(itf.cache / Interference.CACHE_AT_1, 1.0)
    b = min(itf.bw / Interference.BW_AT_1, 1.0)
    if noise_scale == 0.0 or rng is None:
        eps = np.zeros(6)
    else:
        eps = noise_scale * np.array([rng.normal(0, 0.015),
                                      rng.normal(0, 0.02),
                                      rng.normal(0, 0.05),
                                      rng.normal(0, 0.02),
                                      rng.normal(0, 0.005),
                                      rng.normal(0, 0.01)])
    miss = 0.08 + 0.85 * c + eps[0]
    acc = 0.20 + 0.75 * b + eps[1]
    ipc = 2.2 - 1.1 * max(c, b) + eps[2]
    flop = 0.6 + eps[3]
    branch = 0.05 + eps[4]
    stalls = 0.1 + 0.05 * itf.bw + eps[5]
    return np.array([miss, acc, ipc, flop, branch, stalls])


synthesize_counters = counters_at_pressure


class TorchLinearProxy:
    """Per-resource linear model on the two L3 counters (paper's proxy,
    vectorized per shared resource):

        cache_pressure ~= Wc . [miss, acc] + bc
        bw_pressure    ~= Wb . [miss, acc] + bb

    ``predict`` returns the scalar level (for reporting / Fig. 11b);
    ``predict_interference`` the per-resource pressures the scheduler
    consumes.

    Online re-fit: :meth:`rls_update` feeds one (counter sample, realized
    pressure) pair through a forgetting-factor recursive-least-squares
    step, so the proxy tracks traffic drift away from the offline
    calibration distribution.  A drift detector watches the residual
    stream: when the recent residual RMS spikes past ``DRIFT_SPIKE`` x
    the calibration-time RMS, the proxy is batch-refit on its sliding
    window (``refit_count`` counts these; ``rms_error`` reports the
    current window residual RMS — both surfaced in
    ``ServingMetrics.proxy_rms_error``/``refit_count``)."""

    def __init__(self):
        self.w = np.zeros((2, 2))
        self.b = np.zeros(2)
        self.r2 = float("nan")
        # online (RLS) state, lazily seeded from (w, b) on first update
        self._theta: np.ndarray | None = None     # (3, 2) stacked [W; b]
        self._P: np.ndarray | None = None         # (3, 3) inverse covariance
        self._win: collections.deque = collections.deque(maxlen=RLS_WINDOW)
        self._residuals: collections.deque = collections.deque(
            maxlen=RLS_WINDOW)
        self.base_rms = float("nan")   # calibration-time residual RMS
        self.refit_count = 0           # drift-triggered window refits
        self.rls_updates = 0           # online pairs consumed

    def fit(self, counters: np.ndarray,
            pressures: np.ndarray) -> "LinearProxy":
        """counters (n,2); pressures (n,2) = (cache, bw) demand sums."""
        x = np.column_stack([counters[:, 0], counters[:, 1],
                             np.ones(len(counters))])
        sol, *_ = np.linalg.lstsq(x, pressures, rcond=None)
        self.w, self.b = sol[:2].T, sol[2]
        pred = x @ sol
        ss_res = float(np.sum((pressures - pred) ** 2))
        ss_tot = float(np.sum((pressures - pressures.mean(0)) ** 2)) or 1.0
        self.r2 = 1.0 - ss_res / ss_tot
        resid = np.linalg.norm(pressures - pred, axis=1)
        self.base_rms = float(np.sqrt(np.mean(resid ** 2)))
        self._theta = None             # re-seed RLS from the fresh solution
        self._P = None
        self._win.clear()
        self._residuals.clear()
        return self

    # -- online re-fit -----------------------------------------------------
    @property
    def rms_error(self) -> float:
        """Residual RMS over the sliding window (nan before any update)."""
        if not self._residuals:
            return float("nan")
        r = np.asarray(self._residuals)
        return float(np.sqrt(np.mean(r ** 2)))

    @staticmethod
    def _target(pressure) -> np.ndarray:
        if isinstance(pressure, Interference):
            return np.array([pressure.cache, pressure.bw], dtype=float)
        return np.asarray(pressure, dtype=float)[:2]

    def rls_update(self, counters: np.ndarray, pressure) -> float:
        """One sliding-window RLS step on a (counters, realized pressure)
        pair.  ``pressure`` is an :class:`Interference` or a (cache, bw)
        array — the sample's oracle truth offline, the CounterBank's
        measured pressure online.  Returns the pre-update residual norm
        (the surprise this pair carried)."""
        x = np.array([float(counters[0]), float(counters[1]), 1.0])
        y = self._target(pressure)
        if self._theta is None:
            self._theta = np.vstack([self.w.T, self.b])
            self._P = np.eye(3) * 100.0
        resid = y - self._theta.T @ x
        px = self._P @ x
        denom = RLS_FORGET + float(x @ px)
        self._theta = self._theta + np.outer(px / denom, resid)
        self._P = (self._P - np.outer(px, px) / denom) / RLS_FORGET
        self.w, self.b = self._theta[:2].T, self._theta[2]
        self._win.append((x, y))
        err = float(np.linalg.norm(resid))
        self._residuals.append(err)
        self.rls_updates += 1
        # drift detection: a sustained residual spike means the counter->
        # pressure mapping moved faster than the forgetting factor tracks
        if len(self._residuals) >= DRIFT_WINDOW:
            recent = np.asarray(self._residuals)[-DRIFT_WINDOW:]
            recent_rms = float(np.sqrt(np.mean(recent ** 2)))
            floor = max(self.base_rms, 1e-3) if np.isfinite(self.base_rms) \
                else 1e-3
            if recent_rms > DRIFT_SPIKE * floor:
                self.refit_window()
        return err

    def refit_window(self) -> None:
        """Batch least-squares over the sliding window (the drift
        response): jump the model to the new regime instead of waiting
        for the forgetting factor to wash the old one out."""
        if len(self._win) < 4:
            return
        xs = np.array([x for x, _ in self._win])
        ys = np.array([y for _, y in self._win])
        sol, *_ = np.linalg.lstsq(xs, ys, rcond=None)
        self.w, self.b = sol[:2].T, sol[2]
        self._theta = sol
        self._P = np.eye(3) * 100.0
        self.refit_count += 1
        # the post-refit residuals define the new normal: both the live
        # window and the drift floor reset, so one regime change triggers
        # one refit, not one per subsequent sample
        resid = np.linalg.norm(ys - xs @ sol, axis=1)
        self._residuals.clear()
        self._residuals.extend(float(r) for r in resid[-DRIFT_WINDOW:])
        self.base_rms = max(float(np.sqrt(np.mean(resid ** 2))), 1e-3)

    def predict_interference(self, counters: np.ndarray) -> Interference:
        c2 = np.asarray(counters[:2], dtype=float)
        cache, bw = self.w @ c2 + self.b
        return Interference(
            cache=float(np.clip(cache, 0.0, Interference.CACHE_AT_1)),
            bw=float(np.clip(bw, 0.0, Interference.BW_AT_1)))

    def predict(self, counters: np.ndarray) -> float:
        return self.predict_interference(counters).level


LinearProxy = TorchLinearProxy


def variance_shares(counters: np.ndarray) -> np.ndarray:
    """Fraction of variance per principal component (Fig. 11a).

    Raw covariance (no per-counter standardization): the paper's finding
    is that the L3-driven counters carry nearly all the *actual* variance;
    standardizing would inflate the distractor counters' noise floor to
    parity and bury that signal."""
    x = counters - counters.mean(axis=0)
    _, s, _ = np.linalg.svd(x, full_matrices=False)
    var = s ** 2
    return var / var.sum()


pca_variance = variance_shares


def calibrate_proxy(hw: HardwareSpec, n: int = 512,
                    seed: int = 0) -> tuple[LinearProxy, np.ndarray,
                                            np.ndarray]:
    """Offline calibration pass: sweep *independent* cache/bw pressure
    mixes (co-runner mixes in production are not perfectly correlated),
    record counters, fit the linear proxy on the realized level."""
    rng = np.random.default_rng(seed)
    pts = []
    for i in range(n):
        if i % 2 == 0:        # correlated sweep (anchors the extremes)
            pts.append(level_interference(rng.uniform()))
        else:                 # independent mixes (production co-runners)
            pts.append(Interference(
                cache=Interference.CACHE_AT_1 * rng.uniform(),
                bw=Interference.BW_AT_1 * rng.uniform(),
                ici=Interference.ICI_AT_1 * rng.uniform()))
    levels = np.array([p.level for p in pts])
    pressures = np.array([(p.cache, p.bw) for p in pts])
    counters = np.stack([synthesize_counters(hw, p, rng) for p in pts])
    proxy = LinearProxy().fit(counters[:, :2], pressures)
    return proxy, counters, levels
