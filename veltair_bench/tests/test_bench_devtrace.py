"""The traced slice's reduction: every device event counts, wherever the
card's clock puts it against the host annotation; annotations mirrored
on the card's timeline are not its work; gaps are named by the engine
call the host was in."""
from __future__ import annotations

import types

import pytest
import torch

from veltair_bench import devtrace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, start, end, dev=CUDA, stream=7):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start,
        duration_ns=lambda: end - start, device_type=lambda: dev,
        device_resource_id=lambda: stream)


def test_every_device_event_counts_and_gaps_are_named():
    events = [
        ev(devtrace.SLICE, 0, 1000, CPU),
        ev(devtrace.SLICE, 0, 1000),                 # its mirror on the card
        ev("a.begin_quantum", 400, 600, CPU),
        ev("a.begin_quantum", 400, 600),
        # the card's clock sits 300 ns late: the last kernel ends past
        # the host annotation, and still counts
        ev("block_matmul_kernel<16>", 300, 500),
        ev("block_matmul_kernel<16>", 550, 900, stream=8),
        ev("elementwise", 950, 1200),
    ]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    s = devtrace.summarize(prof)
    assert s.kernel("block_matmul_kernel") == (pytest.approx(550e-9), 2)
    assert s.window_s == pytest.approx(1000e-9)
    assert s.busy_s == pytest.approx((200 + 350 + 250) * 1e-9)
    assert s.stream_busy_s == pytest.approx({"7": 450e-9, "8": 350e-9})
    # gaps 500-550 (inside a.begin_quantum) and 900-950 (outside)
    assert s.idle_by_host == pytest.approx({"a.begin_quantum": 50e-9,
                                            devtrace.HOST_IDLE: 50e-9})


def test_a_trace_without_device_events_gives_none():
    events = [ev(devtrace.SLICE, 0, 1000, CPU),
              ev("a.begin_quantum", 400, 600, CPU)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    assert devtrace.summarize(prof) is None


class FakeEvent:
    """A CUDA event at ``ms`` milliseconds on the card's clock."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_the_calls_events_stand_in_for_an_empty_trace():
    ref = FakeEvent(0.0)
    spans = [("a.begin_quantum", 1, FakeEvent(10.0), FakeEvent(60.0)),
             ("b.begin_quantum", 2, FakeEvent(40.0), FakeEvent(90.0)),
             ("a.prefill_step", 1, FakeEvent(150.0), FakeEvent(200.0))]
    s = devtrace.from_events(ref, spans, 0.25)
    assert s.window_s == 0.25
    assert s.busy_s == pytest.approx(0.130)          # 10-90 and 150-200 ms
    assert s.stream_busy_s == pytest.approx({"1": 0.100, "2": 0.050})
    assert s.idle_by_host == pytest.approx({devtrace.HOST_IDLE: 0.120})
    assert s.kernel("block_matmul") == (0.0, 0)      # no kernel by name
    ops = dict(s.breakdown()["device_ops"])
    assert ops == pytest.approx({
        "a.begin_quantum" + devtrace.EVENTS_NOTE: 0.050,
        "b.begin_quantum" + devtrace.EVENTS_NOTE: 0.050,
        "a.prefill_step" + devtrace.EVENTS_NOTE: 0.050})
