"""One run of one cell: set-up, the measured window, the metrics, the
check.  ``run.py`` is its command line; the calibration of the check
reuses its pieces."""
from __future__ import annotations

import dataclasses
import sys

import numpy as np

from veltair_bench import cells, correct, devtrace, roofline, stats, traffic
from veltair_bench.system import System


@dataclasses.dataclass
class Run:
    """What a per-layer reader gets (``metrics/<name>.py``)."""
    cell: cells.Cell
    tenants: list                # system.Tenant
    served: object               # system.Served
    capture_s: dict              # tenant -> capture seconds of set-up
    trace: devtrace.TraceSummary | None

    def tenant(self, name: str):
        return next(t for t in self.tenants if t.name == name)

    def kernel_least(self, kernel: str) -> tuple[float, int]:
        """The least seconds and the launches of ``kernel`` ("b1", "b2",
        "b4") over the traced slice's dispatches."""
        least, launches = 0.0, 0
        for step, tenant in self.traced_steps():
            work = tenant.ref.kernel_work(tenant.config, step).get(kernel, [])
            launches += len(work)
            least += sum(roofline.least_s(f, b) for f, b in work)
        return least, launches

    def roofline_share(self, kernel: str, name: str) -> float | None:
        """``kernel``'s least time over its device time in the traced
        slice (%), the least time of every launch the slice dispatched
        scaled by the share of them the trace holds (it has held 1%
        fewer).  None when the slice launched it not at all, or when the
        trace's count of ``name`` and the dispatches differ by over 5%."""
        if self.trace is None:
            return None
        least, launches = self.kernel_least(kernel)
        secs, count = self.trace.kernel(name)
        if not launches or not count:
            return None
        if abs(count - launches) > 0.05 * launches:
            print(f"{kernel}_roofline: the trace holds {count} launches of "
                  f"{name}, the dispatches {launches}; not read",
                  file=sys.stderr)
            return None
        return 100.0 * least * count / launches / secs

    def traced_steps(self):
        for q in self.served.quanta:
            if q.traced:
                t = self.tenant(q.tenant)
                for j in range(q.bucket):
                    kv = q.pos + np.minimum(j, q.n_left) + 1
                    yield ("decode", kv.tolist()), t
        for c in self.served.chunks:
            if c.traced:
                yield ("chunk", c.size, c.start), self.tenant(c.tenant)

    def model_flops(self) -> float:
        """Model FLOPs of every real token the window processed: prompt
        tokens in chunks, decoded tokens, and the output head for every
        output token."""
        flops = 0.0
        for c in self.served.chunks:
            t = self.tenant(c.tenant)
            flops += sum(t.ref.token_flops(t.config, c.start + i)
                         for i in range(c.valid))
        for q in self.served.quanta:
            t = self.tenant(q.tenant)
            for pos, n in zip(q.pos.tolist(), q.n_left.tolist()):
                flops += sum(t.ref.token_flops(t.config, pos + j)
                             for j in range(int(n)))
        for r in self.served.reqs:
            if r.output is not None:
                flops += len(r.output) * self.tenant(r.tenant).ref.head_flops(
                    self.tenant(r.tenant).config)
        return flops

    @property
    def serve_s(self) -> float:
        """The window's wall time, the trace's own cost and the waits for
        due times left out."""
        s = self.served
        return s.t_close - s.t_open - s.held_s


def end_to_end(cell: cells.Cell, served, setup_s: float) -> dict:
    """The end-to-end metrics that the cell's BENCHMARK.json entries name,
    out of every one the harness can take from a serve."""
    values = {"setup_s": setup_s,
              "tokens_per_s": stats.tokens_per_s(served.reqs, served.t_open)}
    values.update(stats.latency_metrics(served.reqs))
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(run: Run) -> dict:
    out = {}
    for m in run.cell.per_layer:
        value = cells.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(cell: cells.Cell, seed: int, seconds: float, trace: bool,
            device, t_start: float, *, hw=None, prepare=None) -> tuple:
    """Set up, serve the window, measure, free, check.  ``prepare(system)``
    runs after set-up (the tests plant faults with it).  Returns (result
    without ``device``, checks, memory peak, trace summary)."""
    import torch
    vocab = [(t["model"], t["config"]["vocab_size"])
             for t in cell.config["tenants"]]
    reqs = traffic.generate(cell.traffic, vocab, seed, seconds)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    system = System(cell.config, seed, dev, hw=hw)
    slice_ = devtrace.Slice.for_run(seconds) if trace else None
    if slice_ is not None and dev.type == "cuda":
        warm_profiler()
    if prepare is not None:
        prepare(system)
    served = system.serve(reqs, seed, slice_)
    setup_s = served.t_open - t_start
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    summary = slice_.summary if slice_ is not None else None
    run = Run(cell, system.tenants, served, system.capture_s, summary)
    metrics = (per_layer(run) if trace
               else end_to_end(cell, served, setup_s))
    system.free()
    checks = correct.check(system.tenants, reqs, seed, dev)
    failed = checks["failed_requests"]["value"]
    result = {"correct": correct.passed(checks), "attempted": len(reqs),
              "failed": failed, "metrics": metrics}
    notes = {"serve_s": served.t_close - served.t_open,
             "held_s": served.held_s, "ticks": served.ticks,
             "requests": len(reqs)}
    return result, checks, peak, summary, notes


def warm_profiler() -> None:
    """Start the profiler's tracer once during set-up, so that opening
    the slice inside the window does not pay its first start."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
