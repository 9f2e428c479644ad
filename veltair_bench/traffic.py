"""The one traffic generator: a mix file's parameters -> requests.

Every seed gets the same multiset of sizes and arrival gaps (the
quantiles of each stated distribution), in another order, and its own
prompt tokens; so runs with different seeds do the same work and differ
only in how it interleaves.  A mix file (``traffic/<name>.json``) holds:

* ``arrivals``: ``{"process": "poisson", "rate_per_s": r}`` (an open
  loop: requests due at exponential gaps of mean 1/r, the first at 0,
  over the run's seconds) or ``{"process": "backlog", "burst_per_tenant":
  n, "bursts_per_s": b}`` (an offline backlog: round(b * seconds) bursts
  of n requests per tenant, all due at 0 and served in order);
* ``prompt_tokens``, ``output_tokens``: ``{"dist": "lognormal",
  "median", "sigma", "min", "max"}`` or ``{"dist": "uniform", "min",
  "max"}``; output tokens count the first token, which the prefill
  emits;
* the tenants share a mix evenly.
"""
from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np


@dataclasses.dataclass
class Req:
    """One request as generated, and what the run stamps on it."""
    idx: int
    tenant: str
    offset: float                 # due, in seconds after the window opens
    prompt: np.ndarray            # int32 token ids
    out_tokens: int               # output tokens asked for, the first too
    due: float = 0.0              # absolute host-clock due time
    admitted: float | None = None # host clock when a slot took it
    first: float | None = None    # host clock at the first token
    finish: float | None = None   # host clock when it finished
    output: list | None = None    # served tokens


def quantiles(spec: dict, n: int) -> list[int]:
    """The n mid-quantiles of a length distribution, rounded, clipped."""
    lo, hi = int(spec["min"]), int(spec["max"])
    qs = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "lognormal":
        mu, sigma = math.log(spec["median"]), float(spec["sigma"])
        nd = statistics.NormalDist()
        vals = [math.exp(mu + sigma * nd.inv_cdf(q)) for q in qs]
    elif spec["dist"] == "uniform":
        vals = [lo + (hi - lo) * q for q in qs]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [min(hi, max(lo, int(round(v)))) for v in vals]


def _per_tenant_counts(n: int, k: int) -> list[int]:
    return [n // k + (1 if i < n % k else 0) for i in range(k)]


def generate(mix: dict, tenants: list[tuple[str, int]], seed: int,
             seconds: float) -> list[Req]:
    """Requests of ``mix`` over ``seconds`` for ``tenants`` [(name,
    vocab size)], sorted by (offset, tenant) as the runtime sorts its
    arrivals; ``idx`` is that order."""
    rng = np.random.default_rng(int(seed))
    arr = mix["arrivals"]
    names = [t for t, _ in tenants]
    if arr["process"] == "poisson":
        rate = float(arr["rate_per_s"])
        n = max(2, int(round(rate * seconds)))
        counts = _per_tenant_counts(n, len(names))
        who = rng.permutation(np.repeat(np.arange(len(names)), counts))
        gaps = np.array([-math.log(1.0 - (i + 0.5) / (n - 1)) / rate
                         for i in range(n - 1)])
        offsets = np.concatenate([[0.0], np.cumsum(rng.permutation(gaps))])
    elif arr["process"] == "backlog":
        bursts = max(1, int(round(float(arr["bursts_per_s"]) * seconds)))
        per = int(arr["burst_per_tenant"]) * bursts
        counts = [per] * len(names)
        # burst after burst, each holding every tenant's share
        who = np.tile(np.repeat(np.arange(len(names)),
                                int(arr["burst_per_tenant"])), bursts)
        offsets = np.zeros(len(who))
    else:
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    sizes = {}
    for j, c in enumerate(counts):
        sizes[j] = (list(rng.permutation(quantiles(mix["prompt_tokens"], c))),
                    list(rng.permutation(quantiles(mix["output_tokens"], c))))
    out = []
    for off, j in zip(offsets.tolist(), who.tolist()):
        prompts, outs = sizes[j]
        plen, olen = int(prompts.pop()), int(outs.pop())
        toks = rng.integers(0, tenants[j][1], plen).astype(np.int32)
        out.append(Req(idx=-1, tenant=names[j], offset=float(off),
                       prompt=toks, out_tokens=olen))
    out.sort(key=lambda r: (r.offset, r.tenant))
    for i, r in enumerate(out):
        r.idx = i
    return out
