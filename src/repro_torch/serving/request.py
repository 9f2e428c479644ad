"""A copy of ``repro.serving.request`` (numpy). Names the reference's own
code reaches by being unique in the repository are defined under port
names and bound to the reference's: ``synth_prompts = seeded_prompts``,
``qos_inverse_weights = inverse_qos_weights`` (the static analyzer, repro.analysis.callgraph, would otherwise find two
definitions and resolve the reference's calls to neither).

Query/workload generation (MLPerf-Server style).

Arrivals are Poisson with rate lambda = offered QPS (the paper's setup);
mixed workloads draw each query's model with probability inversely
proportional to its QoS target (paper §5.1, following the Google-trace
analysis they cite).  A deterministic uniform generator reproduces the
Fig. 3 experiment (30k identical ResNet-50 queries, uniform arrivals).
"""
from __future__ import annotations

import numpy as np


def poisson_workload(models: list[str], qps: float, n_queries: int,
                     seed: int = 0,
                     weights: list[float] | None = None,
                     ) -> list[tuple[float, str]]:
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / qps, n_queries)
    times = np.cumsum(gaps)
    if weights is None:
        probs = np.ones(len(models)) / len(models)
    else:
        w = np.asarray(weights, dtype=float)
        probs = w / w.sum()
    names = rng.choice(models, size=n_queries, p=probs)
    return list(zip(times.tolist(), names.tolist()))


def uniform_workload(model: str, qps: float,
                     n_queries: int) -> list[tuple[float, str]]:
    gap = 1.0 / qps
    return [(i * gap, model) for i in range(n_queries)]


def _pick_models(rng: np.random.Generator, models: list[str], n: int,
                 weights: list[float] | None) -> np.ndarray:
    if weights is None:
        probs = np.ones(len(models)) / len(models)
    else:
        w = np.asarray(weights, dtype=float)
        probs = w / w.sum()
    return rng.choice(models, size=n, p=probs)


def gamma_poisson_workload(models: list[str], qps: float, n_queries: int,
                           *, burstiness: float = 1.0,
                           interval_s: float = 0.05, seed: int = 0,
                           weights: list[float] | None = None,
                           ) -> list[tuple[float, str]]:
    """Doubly-stochastic (Gamma-modulated) Poisson arrivals — the bursty
    heavy-traffic regime the paper targets.

    The instantaneous rate is ``qps * m_i`` where the per-interval
    multiplier ``m_i ~ Gamma(shape=1/burstiness, scale=burstiness)``
    (mean 1, variance = burstiness), redrawn every ``interval_s``
    seconds: ``burstiness -> 0`` recovers plain Poisson at rate ``qps``;
    large values pile arrivals into flash crowds separated by lulls.
    Mean offered load stays ``qps`` so bursty and smooth workloads are
    comparable at equal offered load."""
    if burstiness < 0:
        raise ValueError("burstiness must be >= 0")
    rng = np.random.default_rng(seed)
    times = []
    t = 0.0
    while len(times) < n_queries:
        if burstiness < 1e-9:
            mult = 1.0
        else:
            mult = float(rng.gamma(1.0 / burstiness, burstiness))
        rate = qps * mult
        end = t + interval_s
        if rate > 1e-12:
            while True:
                t += float(rng.exponential(1.0 / rate))
                if t >= end or len(times) >= n_queries:
                    break
                times.append(t)
        t = end
    names = _pick_models(rng, models, n_queries, weights)
    return list(zip(times[:n_queries], names.tolist()))


def diurnal_workload(models: list[str], qps_peak: float, n_queries: int,
                     *, period_s: float = 1.0, floor: float = 0.2,
                     seed: int = 0, weights: list[float] | None = None,
                     ) -> list[tuple[float, str]]:
    """Sinusoidally-modulated Poisson arrivals (a compressed diurnal
    cycle) via Lewis thinning: rate(t) = qps_peak * (floor + (1-floor)
    * (1 + sin(2*pi*t/period_s)) / 2), so load swings between
    ``floor*qps_peak`` and ``qps_peak`` every ``period_s`` seconds."""
    if not 0.0 <= floor <= 1.0:
        raise ValueError("floor must be in [0, 1]")
    rng = np.random.default_rng(seed)
    times = []
    t = 0.0
    while len(times) < n_queries:
        t += float(rng.exponential(1.0 / qps_peak))
        rate_frac = floor + (1.0 - floor) \
            * (1.0 + np.sin(2.0 * np.pi * t / period_s)) / 2.0
        if rng.random() < rate_frac:        # Lewis-Shedler thinning
            times.append(t)
    names = _pick_models(rng, models, n_queries, weights)
    return list(zip(times, names.tolist()))


def seeded_prompts(n: int, prompt_len: int, vocab_size: int,
                  seed: int = 0) -> np.ndarray:
    """(n, prompt_len) int32 prompts — deterministic per seed, so a
    Workload replays identically through simulator and engine."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab_size, (n, prompt_len)).astype(np.int32)


def inverse_qos_weights(qos_ms: dict[str, float]) -> list[float]:
    """Per-model mix weights 1 / QoS target, in ``qos_ms``'s order (the
    tighter a model's target, the more often it is drawn)."""
    return [1.0 / qos_ms[m] for m in qos_ms]


synth_prompts = seeded_prompts
qos_inverse_weights = inverse_qos_weights
