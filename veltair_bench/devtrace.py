"""The device trace of a steady slice of the window (``--trace 1``).

The slice (``trace_slice.json``: where it opens, as a share of the
run's seconds, and how long it lasts) is cut out of the serve by the
engine wrappers (``calls.py``): at its first engine call past the opening
the card is synchronised and ``torch.profiler`` starts (CPU and CUDA
activity); at the first call past the end it is synchronised again and
the profiler stops.  Each engine call inside is a host annotation named
``<tenant>.<method>``, so an idle gap on the card can be named by what
the host was doing.  The card launches some 290,000 kernels a second in
``colo.batch``; a short slice keeps the trace and its reduction small.
The summary is read from the profiler's raw results (building its Python
event tree for the hundreds of thousands of device events of a slice
would take minutes).

``merge_intervals`` and the per-stream busy union come from the
repository's chip smoke test (``stream_busy``).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import sys
import time

from veltair_bench.calls import TIMED

SLICE_FILE = pathlib.Path(__file__).resolve().parent / "trace_slice.json"
SLICE = "veltair_bench.slice"
HOST_IDLE = "cluster and runtime (no engine call)"
EVENTS_NOTE = " (CUDA events; the profiler recorded no device event)"


def merge_intervals(spans: list) -> list:
    """The union of (start, end) intervals, as disjoint sorted ones."""
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclasses.dataclass
class TraceSummary:
    """What the readers take from one traced slice (seconds)."""
    window_s: float                          # the slice, host annotation
    busy_s: float                            # union of device activity
    stream_busy_s: dict                      # stream -> its own union
    by_name: dict                            # device op -> (seconds, count)
    idle_by_host: dict                       # host label -> idle seconds

    def kernel(self, substring: str) -> tuple[float, int]:
        """Device seconds and launches of the ops whose name holds
        ``substring``."""
        secs = sum(s for n, (s, _) in self.by_name.items() if substring in n)
        count = sum(c for n, (_, c) in self.by_name.items()
                    if substring in n)
        return secs, count

    def breakdown(self) -> dict:
        ops = sorted(((s, n) for n, (s, _) in self.by_name.items()),
                     reverse=True)[:10]
        gaps = sorted(((s, n) for n, s in self.idle_by_host.items()),
                      reverse=True)[:10]
        return {"device_ops": [[n, s] for s, n in ops],
                "idle_gaps": [[n, s] for s, n in gaps]}


class Slice:
    """Starts and stops the profiler inside the serve; ``poll`` is called
    by every engine wrapper with the seconds since the window opened.

    Each engine call inside also records a CUDA event on its engine's
    stream before and after the work it enqueues.  Where the profiler's
    trace holds no device event at all, the slice is summarised from
    those instead (``from_events``): busy time from the calls' spans on
    the card, no kernel by name."""

    def __init__(self, start_s: float, length_s: float):
        self.start_s, self.end_s = start_s, start_s + length_s
        self.state = "waiting"
        self.prof = None
        self._mark = None
        self._ref = None
        self._t_begin = 0.0
        self._spans: list = []
        self.summary: TraceSummary | None = None

    @classmethod
    def for_run(cls, seconds: float) -> "Slice":
        spec = json.loads(SLICE_FILE.read_text())
        return cls(spec["open_share"] * seconds, spec["seconds"])

    @property
    def active(self) -> bool:
        return self.state == "on"

    def poll(self, t_rel: float) -> None:
        if self.state == "waiting" and t_rel >= self.start_s:
            self.begin()
        elif self.state == "on" and t_rel >= self.end_s:
            self.end()

    def begin(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._mark = record_function(SLICE)
        self._mark.__enter__()
        self._ref = torch.cuda.Event(enable_timing=True)
        self._ref.record()
        self._t_begin = time.perf_counter()
        self.state = "on"

    def end(self) -> None:
        import torch
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t_begin
        self._mark.__exit__(None, None, None)
        self.prof.stop()
        self.state = "done"
        self.summary = summarize(self.prof)
        if self.summary is None:
            print("trace: the profiler recorded no device event; the slice "
                  "is read from CUDA events around the engine calls",
                  file=sys.stderr)
            self.summary = from_events(self._ref, self._spans, window_s)
        self.prof = None

    def annotate(self, label: str, stream=None):
        """A host annotation and CUDA events on ``stream`` for one engine
        call (None outside the slice); the caller ``__exit__``s it."""
        if self.state != "on":
            return None
        return Mark(label, stream, self._spans)


class Mark:
    """One engine call inside the slice."""

    def __init__(self, label: str, stream, spans: list):
        import torch
        from torch.profiler import record_function
        self.label, self.stream, self.spans = label, stream, spans
        self.rf = record_function(label)
        self.rf.__enter__()
        self.start = None
        if stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(stream)

    def __exit__(self, *exc) -> None:
        import torch
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            self.spans.append((self.label, self.stream.cuda_stream,
                               self.start, end))
        self.rf.__exit__(*exc)


def from_events(ref, spans: list, window_s: float) -> TraceSummary:
    """The slice from the engine calls' CUDA events: each call's span on
    its stream runs from the card reaching its first event to the end of
    its work, so busy time can only read high (a call's own gaps count
    as busy).  ``spans``: (label, stream, start event, end event), read
    after the card was synchronised; ``ref`` was recorded as the slice
    opened."""
    intervals, per_stream = [], collections.defaultdict(list)
    by_name: dict = collections.defaultdict(lambda: [0.0, 0])
    for label, stream, start, end in spans:
        a = ref.elapsed_time(start) / 1e3
        b = ref.elapsed_time(end) / 1e3
        intervals.append((a, b))
        per_stream[stream].append((a, b))
        by_name[label + EVENTS_NOTE][0] += b - a
        by_name[label + EVENTS_NOTE][1] += 1
    union = merge_intervals(intervals)
    busy = sum(b - a for a, b in union)
    return TraceSummary(
        window_s=window_s, busy_s=busy,
        stream_busy_s={str(k): sum(b - a for a, b in merge_intervals(v))
                       for k, v in per_stream.items()},
        by_name={n: (s, c) for n, (s, c) in by_name.items()},
        idle_by_host={HOST_IDLE: max(window_s - busy, 0.0)})


def report(device: list, host: list, win: tuple) -> None:
    """One line on standard error: how many events the trace holds, and
    where the card's put them against the host annotation."""
    lo, hi = win
    line = (f"trace: {len(device)} device events on "
            f"{len({r for _, _, r in device})} streams, {len(host)} engine "
            f"calls, window {(hi - lo) / 1e9:.6f} s")
    if device:
        first = min(a for (a, _), _, _ in device)
        last = max(b for (_, b), _, _ in device)
        line += (f"; device from {(first - lo) / 1e6:+.3f} ms to "
                 f"{(last - hi) / 1e6:+.3f} ms of its edges")
    print(line, file=sys.stderr)


def summarize(prof) -> TraceSummary | None:
    """Reduce the raw results of a profiled slice; None where they hold
    no device event."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    win = None
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        span = (s, s + e.duration_ns())
        # the annotations appear on the card's timeline too: not its work
        ours = e.name() == SLICE or e.name().rsplit(".", 1)[-1] in TIMED
        if e.device_type() == cuda:
            if not ours:
                device.append((span, e.name(), e.device_resource_id()))
        elif e.name() == SLICE:
            win = span
        elif ours:
            host.append((span, e.name()))
    if win is None:
        return None
    report(device, host, win)
    if not device:
        return None
    # the card was synchronised before the profiler started and before it
    # stopped, so every device event belongs to the slice; its timestamps
    # are not clipped to the host annotation, whose clock the card's can
    # sit apart from (a quarter of a slice's launches fell outside once)
    lo, hi = win
    by_name: dict = collections.defaultdict(lambda: [0.0, 0])
    per_stream = collections.defaultdict(list)
    for (a, b), name, res in device:
        by_name[name][0] += (b - a) / 1e9
        by_name[name][1] += 1
        per_stream[res].append((a, b))
    union = merge_intervals([sp for sp, _, _ in device])
    busy = sum(b - a for a, b in union) / 1e9
    edges = [x for iv in union for x in iv][1:-1]     # the gaps between
    idle = collections.Counter()
    host.sort()
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = next((n for (s, e), n in host if s <= mid <= e), HOST_IDLE)
        idle[label] += (b - a) / 1e9
    return TraceSummary(
        window_s=(hi - lo) / 1e9, busy_s=busy,
        stream_busy_s={str(k): sum(b - a for a, b in merge_intervals(v))
                       / 1e9 for k, v in per_stream.items()},
        by_name={n: (s, c) for n, (s, c) in by_name.items()},
        idle_by_host=dict(idle))
