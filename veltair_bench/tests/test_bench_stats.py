"""The end-to-end arithmetic over all requests and all the window's time,
against hand-worked cases."""
from __future__ import annotations

import numpy as np
import pytest

from veltair_bench import stats
from veltair_bench.traffic import Req


def req(due, first, finish, n_out):
    r = Req(idx=0, tenant="a", offset=0.0, prompt=np.zeros(4, np.int32),
            out_tokens=n_out)
    r.due, r.first, r.finish = due, first, finish
    r.output = [0] * n_out
    return r


def test_nearest_rank_percentile():
    vals = list(range(1, 21))                  # 1..20
    assert stats.percentile(vals, 95) == 19    # ceil(0.95 * 20) = 19th
    assert stats.percentile(vals, 90) == 18
    assert stats.percentile(vals, 50) == 10
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(list(range(1, 201)), 95) == 190


def test_latency_metrics_count_every_request_from_its_due_time():
    reqs = [req(0.0, 0.1, 1.1, 11),     # ttft 100 ms, tpot 100 ms
            req(1.0, 1.2, 1.6, 5),      # ttft 200, tpot 100
            req(2.0, 2.05, 2.05, 1)]    # ttft 50, one token: no tpot
    m = stats.latency_metrics(reqs)
    assert m["ttft_p90_ms"] == pytest.approx(200)
    assert m["tpot_p90_ms"] == pytest.approx(100)
    assert m["latency_mean_ms"] == pytest.approx((1100 + 600 + 50) / 3)


def test_a_stall_counts_against_every_request_due_during_it():
    # ten requests due 0.1 s apart; the system stalls from 0.2 s to 1.2 s,
    # then serves each 10 ms after the last.  Timed from the due time,
    # the requests that waited carry the stall; timed from admission
    # they would not.
    reqs, t = [], 0.0
    for i in range(10):
        due = 0.1 * i
        start = max(due, 1.2 if due >= 0.2 else due, t)
        t = start + 0.01
        reqs.append(req(due, t, t + 0.05, 2))
    m = stats.latency_metrics(reqs)
    ttft = sorted((r.first - r.due) * 1e3 for r in reqs)
    assert ttft[-1] == pytest.approx(1010)        # due at 0.2, served 1.21
    assert ttft[-2] == pytest.approx(920)         # due at 0.3, served 1.22
    assert m["ttft_p90_ms"] == pytest.approx(ttft[-2])   # 9th of 10
    assert m["latency_mean_ms"] == pytest.approx(
        np.mean([(r.finish - r.due) * 1e3 for r in reqs]))


def test_tokens_per_s_over_the_whole_serve():
    # 3 requests, 10 + 20 + 30 tokens, the window opened at 5.0 and the
    # last finished at 7.0 with an idle second in between: 60 / 2 s
    reqs = [req(5.0, 5.1, 5.5, 10), req(5.0, 5.2, 6.0, 20),
            req(5.0, 6.5, 7.0, 30)]
    assert stats.tokens_per_s(reqs, 5.0) == pytest.approx(30.0)


def test_spread_is_the_quartile_distance_over_the_median():
    # exclusive quartiles of six values sit at ranks 1.75 and 5.25:
    # q1 = 10, q3 = 13 + 0.25 * (14 - 13); the median is 11.5
    vals = [10.0, 10.0, 11.0, 12.0, 13.0, 14.0]
    assert stats.spread(vals) == pytest.approx((13.25 - 10.0) / 11.5)
