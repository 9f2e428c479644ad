"""Multi-version cache of the port's model entry points, each one a CUDA
graph on the card.

The PyTorch counterpart of ``repro.serving.version_cache``: one
:class:`VersionEntry` per tile configuration holds prefill, chunked
prefill, decode, fused-quantum and speculative-verify callables that run
their model calls under the entry's own
:func:`repro_torch.kernels.dispatch.tile_context`, so several engines
holding different versions in one process do not interfere through the
process-global table.  A level switch is a dictionary swap.

Where the reference holds one XLA executable per (entry, callable, shape
key) — a K-bucket, a (K-bucket, draft depth) pair, a prefill-chunk
bucket, a prompt length — this cache holds one :class:`GraphedCall`,
which on the card is one CUDA graph (with :class:`CudaGraphs`;
``graphs=None`` runs the same calls eagerly, as ``jax.disable_jit`` does
for the reference).  A call is bound to the tensors of its first use —
the engine's static input buffers, its persistent cache and its weights
— and raises :class:`StaticArgError` when later given others, on every
device, so the CPU runs the same static-buffer path the card replays.
Its first use runs eagerly (that is the call's result) and is then
captured: the tiles are baked into the graph as the reference bakes them
in at trace, and every later call only replays it.  A capture or replay
error raises; nothing falls back to the eager callable.

``traces`` counts builds — captures on the card, first uses without
graphs — under the reference's keys, so the "zero new builds after
``warmup()``" contract stays testable.  The callables update the cache
they are given in place (the reference donates it).

Launch accounting: the kernel wrappers count launches in Python, which a
replay skips.  A capture records each counter's change and restores the
counters (a capture launches nothing); every replay then adds the
recorded change once.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import operator
import time
from typing import Any, Callable

import torch

from repro_torch.kernels import dispatch


def tiles_key(tiles: dict[str, dict]) -> tuple:
    """Canonical hashable key for an op -> tiling-kwargs table."""
    return tuple(sorted(
        (op, tuple(sorted(kw.items()))) for op, kw in tiles.items()))


class StaticArgError(TypeError):
    """A static build-key argument (the K-bucket) is not a hashable
    integer from the sanctioned bucket space, or a built call was given
    other tensors than the ones it was built with."""


def _static_int(name: str, v: Any, minimum: int = 1) -> int:
    """Validate a static build key: a plain integer (no bools, no
    floats, nothing unhashable) of at least ``minimum``."""
    if isinstance(v, bool):
        raise StaticArgError(
            f"{name} must be a plain int build key, got bool {v!r}")
    try:
        i = operator.index(v)
    except TypeError:
        raise StaticArgError(
            f"{name} must be a hashable int build key, got "
            f"{type(v).__name__} {v!r}") from None
    if i < minimum:
        raise StaticArgError(f"{name}={i} must be >= {minimum}")
    return i


def _pow2_bucket(name: str, v: Any) -> int:
    """Validate a K-bucket key: a power-of-two ``_static_int``."""
    i = _static_int(name, v)
    if i & (i - 1):
        raise StaticArgError(
            f"{name}={i} is not a power-of-two bucket — every distinct "
            f"unbucketed value builds its own quantum; pick from the "
            f"engine's quantum_buckets")
    return i


def _tensor_ptrs(tree: Any, out: list) -> list:
    """The address and shape of every tensor in nested tuples, lists and
    dicts, in order: what a captured graph has baked in."""
    if isinstance(tree, torch.Tensor):
        out.append((tree.data_ptr(), tuple(tree.shape)))
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensor_ptrs(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _tensor_ptrs(v, out)
    return out


class CudaGraphs:
    """Capture and replay on the card: one capture stream and one memory
    pool (``torch.cuda.graph_pool_handle()``) for every graph of an
    engine.

    What a capture frees by its end goes back to the pool for the next
    capture, so one graph's intermediates may sit where another graph
    keeps its outputs: an output is consumed (copied out, or read by the
    next op on the stream) before any other graph of the pool replays.
    Replays run one at a time on the caller's current stream."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)

    def run(self, fn: Callable, args: tuple):
        """``fn(*args)`` eagerly on the capture stream, ordered after the
        current stream's work and before its later work.  Running there
        first makes each kernel's one-time set-up (``cudaFuncSetAttribute``,
        the libraries' handles and workspaces for this stream) happen
        outside any capture."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn(*args)
        current.wait_stream(self.stream)
        return out

    def capture(self, fn: Callable, args: tuple):
        """-> (graph, outputs): ``fn(*args)`` recorded, not run.

        Python's cyclic garbage collector is held off while the capture
        runs: it could free another engine's graphs or memory, and a CUDA
        call that frees them invalidates a capture in progress."""
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool)
                try:
                    out = fn(*args)
                except BaseException:
                    # the capture is abandoned; the error that ended it is
                    # the one to report
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        return graph, out


class GraphedCall:
    """One entry point at one build key, bound to the tensors of its first
    call.  ``graph`` is its CUDA graph (None without graphs) and ``out``
    the graph's static outputs; ``launches`` pairs each kernel launch
    counter with its change in one replay."""

    def __init__(self, owner: "TorchVersionCache", key: tuple,
                 fn: Callable):
        self.owner = owner
        self.key = key
        self.fn = fn
        self.ptrs: list | None = None
        self.graph = None
        self.out = None
        self.launches: list[tuple[collections.Counter,
                                  collections.Counter]] = []
        self.replays = 0

    def __call__(self, *args):
        ptrs = _tensor_ptrs(args, [])
        if self.ptrs is None:
            return self.owner._build(self, args, ptrs)
        if ptrs != self.ptrs:
            raise StaticArgError(
                f"{self.key}: called with other tensors than it was built "
                "with (a static input, a cache leaf or a weight was "
                "rebound); copy new values into the bound tensors")
        if self.graph is None:
            return self.fn(*args)
        self.graph.replay()
        self.replays += 1
        for counter, change in self.launches:
            counter.update(change)
        return self.out


@dataclasses.dataclass
class VersionEntry:
    """One code version: model entry points with the tiles bound in."""
    key: tuple
    tiles: dict[str, dict]
    prefill: Callable          # (params, tokens (1,L), row_cache) -> ...
    decode: Callable           # (params, {"tokens": (B,)}, cache, t) -> ...
    # (params, tokens (1,C), row_cache, t0, valid_len) -> (logits,
    #   row_cache); t0 and valid_len are device scalars
    prefill_chunk: Callable
    # K-bucket -> fused quantum decode
    #   (params, tokens (B,), cache, pos (B,), n_left (B,)) -> (block, cache, pos)
    quanta: dict[int, Callable] = dataclasses.field(default_factory=dict)
    # (K-bucket, draft depth) -> speculative verify
    #   (params, tokens (B,), drafts (B,d), cache, pos (B,), n_left (B,))
    #   -> (block (d+1,B), n_emit, accepted, cache, pos)
    spec: dict[tuple[int, int], Callable] = dataclasses.field(
        default_factory=dict)


class TorchVersionCache:
    """tiles -> VersionEntry, building (and counting) each call on first
    use: a capture with ``graphs`` (a :class:`CudaGraphs`), else an eager
    first use."""

    def __init__(self, model: Any, graphs: CudaGraphs | None = None):
        self.model = model
        self.graphs = graphs
        self._entries: dict[tuple, VersionEntry] = {}
        self._calls: dict[tuple, GraphedCall] = {}
        self.hits = 0              # get() found an existing entry
        self.misses = 0            # get() had to build one
        self.traces = 0            # builds of (entry, callable, shape)
        self.capture_s = 0.0       # host seconds spent capturing

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "traces": self.traces}

    def warmup(self, tile_tables) -> list[VersionEntry]:
        """One entry per tile table, in input order (duplicates resolve
        to the same entry)."""
        return [self.get(tiles) for tiles in tile_tables]

    def get(self, tiles: dict[str, dict]) -> VersionEntry:
        key = tiles_key(tiles)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entry(tiles, key)
            self._entries[key] = entry
            self.misses += 1
        else:
            self.hits += 1
        return entry

    def _call(self, key: tuple, fn: Callable) -> GraphedCall:
        call = self._calls.get(key)
        if call is None:
            call = self._calls[key] = GraphedCall(self, key, fn)
        return call

    def _build(self, call: GraphedCall, args: tuple, ptrs: list):
        """First use of ``call``: run it eagerly (its result is this
        call's), then capture it.  The eager run's launches count as the
        wrappers count them; the capture's are recorded and undone."""
        self.traces += 1
        if self.graphs is None:
            out = call.fn(*args)
            call.ptrs = ptrs
            return out
        out = self.graphs.run(call.fn, args)
        counters = dispatch.launch_counters()
        before = [collections.Counter(c) for c in counters]
        t0 = time.perf_counter()
        try:
            call.graph, call.out = self.graphs.capture(call.fn, args)
        finally:
            self.capture_s += time.perf_counter() - t0
            for c, b in zip(counters, before):
                change = c - b
                c.clear()
                c.update(b)
                if change and call.graph is not None:
                    call.launches.append((c, change))
        # bound only once built: a call whose build failed builds again
        call.ptrs = ptrs
        return out

    def _entry(self, tiles: dict[str, dict], key: tuple) -> VersionEntry:
        snap = {op: dict(kw) for op, kw in tiles.items()}
        model = self.model

        def run_prefill(params, tokens, row_cache):
            with dispatch.tile_context(snap):
                return model.prefill(params, {"tokens": tokens}, row_cache)

        def run_decode(params, inputs, cache, t):
            with dispatch.tile_context(snap):
                return model.decode_step(params, inputs, cache, t)

        def run_chunk(params, tokens, row_cache, t0, valid_len):
            with dispatch.tile_context(snap):
                return model.prefill_chunk(params, {"tokens": tokens},
                                           row_cache, t0, valid_len)

        def prefill(params, tokens, row_cache):
            return self._call((key, "prefill", tuple(tokens.shape)),
                              run_prefill)(params, tokens, row_cache)

        def decode(params, inputs, cache, t):
            return self._call((key, "decode", tuple(inputs["tokens"].shape)),
                              run_decode)(params, inputs, cache, t)

        def prefill_chunk(params, tokens, row_cache, t0, valid_len):
            return self._call((key, "prefill_chunk", tuple(tokens.shape)),
                              run_chunk)(params, tokens, row_cache, t0,
                                         valid_len)

        return VersionEntry(key=key, tiles=snap, prefill=prefill,
                            decode=decode, prefill_chunk=prefill_chunk)

    def quantum(self, entry: VersionEntry, k: int, batch: int) -> Callable:
        """The fused K-step decode of ``entry`` for ``batch`` rows (a
        :class:`GraphedCall`, built at its first call, then cached on the
        entry).  Raises :class:`StaticArgError` when ``k`` is not a
        power-of-two int."""
        k = _pow2_bucket("k", k)
        fn = entry.quanta.get(k)
        if fn is not None:
            self.hits += 1
            return fn
        self.misses += 1
        snap = entry.tiles
        model = self.model

        def run_quantum(params, tokens, cache, pos, n_left):
            with dispatch.tile_context(snap):
                return model.decode_quantum(params, tokens, cache, pos,
                                            n_left, k)
        fn = entry.quanta[k] = self._call(
            (entry.key, "quantum", k, int(batch)), run_quantum)
        return fn

    def verify_call(self, entry: VersionEntry, k: int, d: int,
                    batch: int) -> Callable:
        """The speculative verify of ``entry`` for ``batch`` rows, keyed
        per (K-bucket, draft depth) like :meth:`quantum`: ``k`` caps each
        row's emission on the device (a verify emits at most ``min(k,
        d+1)`` tokens a row), ``d`` fixes the (B, d+1) verify shape.
        Raises :class:`StaticArgError` for a ``k`` that is not a
        power-of-two int or a ``d`` that is not an int."""
        k, d = _pow2_bucket("k", k), _static_int("d", d)
        fn = entry.spec.get((k, d))
        if fn is not None:
            self.hits += 1
            return fn
        self.misses += 1
        snap = entry.tiles
        model = self.model

        def run_verify(params, tokens, drafts, cache, pos, n_left):
            with dispatch.tile_context(snap):
                return model.verify_quantum(params, tokens, drafts, cache,
                                            pos, n_left.clamp(max=k))
        fn = entry.spec[(k, d)] = self._call(
            (entry.key, "spec", k, d, int(batch)), run_verify)
        return fn

    # the reference's name, bound without a second ``def``: the static
    # analyzer resolves the reference engine's
    # ``self.version_cache.spec_quantum`` by the method name being unique
    spec_quantum = verify_call


# The class has its own name and the reference's name is an alias: the
# repository's static analyzer (repro.analysis.callgraph) keys classes by
# bare name, and a second class named VersionCache would merge with the
# reference's and shrink the reference's audited hot path.
VersionCache = TorchVersionCache
