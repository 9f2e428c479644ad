"""Wrappers on the engine instances that time and stamp a serve.

Derived from the repository's chip smoke test (``EngineCalls``): each
engine's device-facing calls are shadowed by instance attributes that
time them.  On top of that they

* hand each request its generated prompt and output budget at
  admission, and hold the admission until the request is due (the
  runtime's idle jump can reach an arrival before its time);
* stamp the first token (the return of a prompt's final prefill chunk,
  which ends in a host sync) and the finish (the return of the quantum
  that completes it) on the harness's own clock;
* record every prefill chunk and decode quantum dispatched, with its
  positions, for the roofline and model-FLOP counts;
* open and close the traced slice (``devtrace.Slice``), whose own cost
  is counted as held time, outside the runtime's host time.

``close()`` restores the engines.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

TIMED = ("admit_request", "set_interference_level", "prefill_step",
         "begin_quantum", "finish_quantum")


@dataclasses.dataclass
class Chunk:
    tenant: str
    size: int              # padded chunk the graph ran
    start: int             # prompt tokens already prefilled
    valid: int             # real prompt tokens in it
    traced: bool


@dataclasses.dataclass
class Quantum:
    tenant: str
    bucket: int            # decode steps the graph ran
    pos: np.ndarray        # (slots,) positions at dispatch
    n_left: np.ndarray     # (slots,) steps each row decodes (0: frozen)
    traced: bool


class Stamps:
    def __init__(self, tenants, reqs, *, slice_=None):
        self.tenants = list(tenants)
        self.reqs = reqs
        self.slice = slice_
        self.t_open = 0.0
        self.inside_s = 0.0      # wall inside the engines' calls
        self.held_s = 0.0        # waits for due times and the trace's cost
        self.chunks: list[Chunk] = []
        self.quanta: list[Quantum] = []
        self._prefilled: dict[int, int] = collections.Counter()
        for t in self.tenants:
            for name in TIMED:
                setattr(t.engine, name, self._wrap(t, name,
                                                   getattr(t.engine, name)))

    def _poll(self) -> None:
        if self.slice is None:
            return
        t0 = time.perf_counter()
        self.slice.poll(t0 - self.t_open)
        self.held_s += time.perf_counter() - t0

    def _wrap(self, tenant, name, fn):
        engine = tenant.engine
        label = f"{tenant.name}.{name}"

        def call(*args, **kw):
            self._poll()
            if name == "admit_request":
                self._admit(args[0])
            pos = engine.slot_pos.copy() if name == "begin_quantum" else None
            mark = (self.slice.annotate(label, engine.stream)
                    if self.slice else None)
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
            finally:
                t1 = time.perf_counter()
                self.inside_s += t1 - t0
                if mark is not None:
                    mark.__exit__(None, None, None)
            traced = bool(self.slice and self.slice.active)
            if name == "prefill_step" and out is not None:
                self.chunks.append(Chunk(tenant.name, out.chunk,
                                         self._prefilled[out.rid],
                                         out.tokens, traced))
                self._prefilled[out.rid] += out.tokens
                if out.finished:
                    self.reqs[out.rid].first = t1
            elif name == "begin_quantum" and out is not None:
                self.quanta.append(Quantum(tenant.name, out.bucket, pos,
                                           np.array(out.n_left), traced))
            elif name == "admit_request" and out:
                self.reqs[args[0].rid].admitted = t1
            elif name == "finish_quantum":
                for req in out:
                    r = self.reqs[req.rid]
                    r.finish, r.output = t1, list(req.output)
            return out
        return call

    def _admit(self, req) -> None:
        """Give the runtime's request the generated prompt and budget,
        and wait for its due time."""
        r = self.reqs[req.rid]
        req.prompt = r.prompt
        req.max_new_tokens = r.out_tokens - 1
        wait = r.due - time.perf_counter()
        if wait > 0:
            t0 = time.perf_counter()
            time.sleep(wait)
            self.held_s += time.perf_counter() - t0

    def close(self) -> None:
        for t in self.tenants:
            for name in TIMED:
                t.engine.__dict__.pop(name, None)
