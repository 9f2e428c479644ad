"""The arithmetic of the end-to-end metrics, over all requests and all
the time of the window, and the spread of repeated runs."""
from __future__ import annotations

import math
import statistics


def percentile(values: list[float], pct: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``pct``
    percent of ``values`` at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(pct / 100.0 * len(ordered)))
    return ordered[rank - 1]


def latency_metrics(reqs) -> dict:
    """TTFT and TPOT tails and the mean latency (ms) over every request of
    the window, each timed from its due time; a cell reports those its
    BENCHMARK.json entries name.  A request that failed has no times and
    is counted by the caller in ``failed``."""
    done = [r for r in reqs if r.finish is not None and r.first is not None]
    ttft = [(r.first - r.due) * 1e3 for r in done]
    lat = [(r.finish - r.due) * 1e3 for r in done]
    tpot = [(r.finish - r.first) * 1e3 / (len(r.output) - 1)
            for r in done if len(r.output) >= 2]
    out = {"latency_mean_ms": sum(lat) / len(lat)}
    for pct in (50, 90, 95, 99):
        out[f"ttft_p{pct}_ms"] = percentile(ttft, pct)
        out[f"tpot_p{pct}_ms"] = percentile(tpot, pct)
    return out


def tokens_per_s(reqs, t_open: float) -> float:
    """Output tokens of every finished request over the whole serve: from
    the window's opening to the last finish."""
    done = [r for r in reqs if r.finish is not None]
    tokens = sum(len(r.output) for r in done)
    return tokens / (max(r.finish for r in done) - t_open)


def spread(values: list[float]) -> float:
    """Distance between the first and third quartiles (Python's
    ``statistics.quantiles``, n=4) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
