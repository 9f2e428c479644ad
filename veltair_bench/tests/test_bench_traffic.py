"""The traffic generator: deterministic per seed, the same sizes and gaps
for every seed in another order, and the stated distributions."""
from __future__ import annotations

import json
import statistics

import numpy as np
import pytest

from veltair_bench import cells, traffic

TENANTS = [("a", 49152), ("b", 50277)]
SEED = 2**31 + 4099          # past 32 signed bits, as the driver's are
# an open-loop chat mix: the generator's Poisson arrivals and log-normal
# lengths, which no committed cell uses yet
CHAT = {"arrivals": {"process": "poisson", "rate_per_s": 6.0},
        "prompt_tokens": {"dist": "lognormal", "median": 160, "sigma": 0.7,
                          "min": 32, "max": 768},
        "output_tokens": {"dist": "lognormal", "median": 64, "sigma": 0.6,
                          "min": 16, "max": 256}}


def mix(name):
    if name == "chat":
        return json.loads(json.dumps(CHAT))
    return json.loads((cells.HERE / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["chat", "batch_colo"])
def test_deterministic_per_seed(name):
    one = traffic.generate(mix(name), TENANTS, SEED, 30)
    two = traffic.generate(mix(name), TENANTS, SEED, 30)
    assert [(r.tenant, r.offset, r.out_tokens) for r in one] == \
        [(r.tenant, r.offset, r.out_tokens) for r in two]
    assert all(np.array_equal(a.prompt, b.prompt) for a, b in zip(one, two))


@pytest.mark.parametrize("name", ["chat", "batch_colo"])
def test_same_work_for_every_seed(name):
    one = traffic.generate(mix(name), TENANTS, SEED, 30)
    two = traffic.generate(mix(name), TENANTS, 7, 30)
    for t, _ in TENANTS:
        assert sorted(len(r.prompt) for r in one if r.tenant == t) == \
            sorted(len(r.prompt) for r in two if r.tenant == t)
        assert sorted(r.out_tokens for r in one if r.tenant == t) == \
            sorted(r.out_tokens for r in two if r.tenant == t)
    assert max(r.offset for r in one) == pytest.approx(
        max(r.offset for r in two))


def test_the_seed_draws_the_order_and_the_tokens():
    m = mix("chat")
    one = traffic.generate(m, TENANTS, SEED, 30)
    two = traffic.generate(m, TENANTS, 7, 30)
    assert [r.tenant for r in one] != [r.tenant for r in two]
    assert [r.offset for r in one] != [r.offset for r in two]
    assert [len(r.prompt) for r in one] != [len(r.prompt) for r in two]


def test_chat_lengths_and_arrivals():
    m = mix("chat")
    rate = m["arrivals"]["rate_per_s"]
    reqs = traffic.generate(m, TENANTS, SEED, 40)
    assert len(reqs) == round(rate * 40)
    assert reqs[0].offset == 0.0
    assert [r.idx for r in reqs] == list(range(len(reqs)))
    offs = [r.offset for r in reqs]
    assert offs == sorted(offs)
    # the mean gap is the rate's, the gaps exponential: median ln 2 / rate
    gaps = np.diff(offs)
    assert np.mean(gaps) == pytest.approx(1 / rate, rel=0.05)
    assert np.median(gaps) == pytest.approx(np.log(2) / rate, rel=0.1)
    plen = [len(r.prompt) for r in reqs]
    olen = [r.out_tokens for r in reqs]
    assert statistics.median(plen) == m["prompt_tokens"]["median"]
    assert statistics.median(olen) == m["output_tokens"]["median"]
    assert min(plen) >= 32 and max(plen) <= 768
    assert min(olen) >= 16 and max(olen) <= 256
    assert sum(r.tenant == "a" for r in reqs) == len(reqs) // 2
    for r in reqs:
        vocab = dict(TENANTS)[r.tenant]
        assert r.prompt.min() >= 0 and r.prompt.max() < vocab
        assert len(r.prompt) + r.out_tokens - 1 <= 1023


def test_quantiles_are_the_distributions():
    ln = {"dist": "lognormal", "median": 100, "sigma": 0.5, "min": 1,
          "max": 10**6}
    q = traffic.quantiles(ln, 1001)
    assert q[500] == 100
    # the 84th percentile of a log-normal is the median times e^sigma
    assert q[840] == pytest.approx(100 * np.exp(0.5), rel=0.01)
    un = {"dist": "uniform", "min": 16, "max": 128}
    assert traffic.quantiles(un, 4) == [30, 58, 86, 114]


def test_backlog_bursts():
    m = mix("batch_colo")
    reqs = traffic.generate(m, TENANTS, SEED, 30)
    bursts = round(m["arrivals"]["bursts_per_s"] * 30)
    per = m["arrivals"]["burst_per_tenant"]
    assert len(reqs) == 2 * bursts * per
    assert all(r.offset == 0.0 for r in reqs)
    olen = [r.out_tokens for r in reqs]
    assert min(olen) >= 256 and max(olen) <= 512
