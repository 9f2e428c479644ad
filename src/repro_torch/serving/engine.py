"""Batched serving engine of the PyTorch port (dense KV cache path of
``repro.serving.engine``).

Continuous batching over request slots: requests join free slots,
chunked prefill fills their cache rows, fused decode quanta run the whole
batch, finished rows free their slots.  Every slot decodes at its own
absolute position with its own kv-valid horizon, so staggered admissions
and mixed-length prompts match a one-request-at-a-time reference.

Admission is chunked and length-bucketed: ``admit_request`` validates the
prompt and queues power-of-two prefill chunks; ``prefill_step`` runs one
chunk into the slot's private row cache.  A decode quantum of K steps
runs on the device with on-device greedy sampling, and the host syncs
once per quantum (``finish_quantum``) and once per finishing prefill.

The VELTAIR integration point: ``set_interference_level`` selects the
code version (kernel tiles) for the current pressure and swaps in its
:class:`~repro_torch.serving.version_cache.VersionCache` entry; the
tiles reach every kernel launch of the entry's calls.  The built-in
table is :data:`H100_LEVEL_TILES`.

Entry points run on the card: ``device=None`` means ``"cuda"``, and an
engine raises ``RuntimeError`` when CUDA is absent unless the caller asks
for ``device="cpu"``.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cost_model as cm
from repro_torch.core.counters import CounterBank
from repro_torch.kernels import dispatch
from repro_torch.models.model import Model, cache_batch_axis
from repro_torch.models.params import tree_map_with_path
from repro_torch.serving.version_cache import VersionCache

# Fused-quantum sizes: a quantum of k decode steps runs as the smallest
# bucket >= k (rows past their budget freeze on device).
QUANTUM_BUCKETS = (1, 2, 4, 8, 16)

# Default prefill chunk: prompts are split into chunks of this many tokens
# and the tail is padded up to a power-of-two bucket.
PREFILL_CHUNK_LEN = 16


def _next_pow2(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


# Interference level -> tiles on the H100.  Low pressure: big tiles and
# reuse; high pressure: small tiles and more blocks (locality ->
# parallelism).  Every entry is a tile the kernels are built for, and
# every attention block fits shared memory at head_dim 256 (the largest,
# (64, 64), needs 214,272 of 232,448 bytes).  The reference's
# DEFAULT_LEVEL_TILES reach bm=256, bk=512: a 512 KB working set, beyond
# what a block can hold.
_H100_LEVELS = (
    # (bm, bn, bk), (bq, bkv)
    ((128, 128, 64), (64, 64)),
    ((128, 128, 32), (64, 64)),
    ((128, 64, 64), (64, 32)),
    ((128, 64, 32), (64, 32)),
    ((64, 128, 32), (32, 64)),
    ((64, 64, 64), (32, 64)),
    ((64, 64, 32), (32, 32)),
    ((64, 32, 32), (32, 32)),
    ((32, 64, 32), (16, 32)),
    ((32, 32, 32), (16, 16)),
)
H100_LEVEL_TILES = tuple(
    {"matmul": {"bm": bm, "bk": bk, "bn": bn},
     "attention": {"bq": bq, "bkv": bkv}}
    for (bm, bn, bk), (bq, bkv) in _H100_LEVELS)
assert len(H100_LEVEL_TILES) == cm.NUM_LEVELS


def resolve_device(device) -> torch.device:
    """``None`` means the card; asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (len,) int token ids
    max_new_tokens: int = 16
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _PrefillState:
    """An in-flight chunked prefill occupying a slot (not yet decodable)."""
    req: Request
    row_cache: object              # the slot's private batch-1 row cache
    schedule: collections.deque    # remaining chunk sizes (bucket table)
    done: int = 0                  # real prompt tokens prefilled so far


@dataclasses.dataclass
class PrefillQuantum:
    """Result of one executed prefill chunk (``prefill_step``)."""
    slot: int
    rid: int
    chunk: int                     # padded chunk size dispatched
    tokens: int                    # real prompt tokens consumed
    finished: bool                 # prompt fully prefilled, first token out


@dataclasses.dataclass
class QuantumHandle:
    """An in-flight fused dispatch quantum: ``block`` is still an
    on-device (possibly not yet computed) tensor; ``finish_quantum``
    performs the single device->host sync and the bookkeeping."""
    block: torch.Tensor            # (K, B) on-device token block
    n_left: np.ndarray             # (B,) per-row steps actually budgeted
    steps: int                     # quantum length (max over rows)
    active: list[int]              # slots live at dispatch time
    row_steps: dict = dataclasses.field(default_factory=dict)  # rid -> steps
    t0: float = 0.0                # perf_counter at dispatch (0 = untimed)
    traces0: int = -1              # version-cache builds at dispatch
    bucket: int = 0                # K-bucket the quantum ran
    tiles: tuple = ()              # tiles key of the dispatched version


class TorchServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 4,
                 max_len: int = 256,
                 quantum_buckets: tuple[int, ...] = QUANTUM_BUCKETS,
                 chunked_prefill: bool = True,
                 prefill_chunk_len: int = PREFILL_CHUNK_LEN,
                 ladder=None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = Model(cfg)
        self.params = tree_map_with_path(lambda _, a: a.to(self.device),
                                         params)
        self.slots = batch_slots
        self.max_len = max_len
        self.cache = self.model.init_cache(batch_slots, max_len, self.device)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int64)
        # chunk sizes are powers of two <= prefill_chunk_len, clamped so a
        # padded tail can never write past the cache's max_len rows
        self.chunked_prefill = chunked_prefill
        self.prefill_chunk_len = min(_next_pow2(prefill_chunk_len),
                                     _next_pow2(max_len + 1) // 2 or 1)
        self.prefill_buckets = tuple(
            1 << i for i in range(self.prefill_chunk_len.bit_length()))
        self._prefill: dict[int, _PrefillState] = {}   # slot -> state (FIFO)
        self.prefill_chunks = 0        # chunk quanta executed
        self.prefill_tokens = 0        # real prompt tokens prefilled
        self.prefill_pad_tokens = 0    # bucket-padding tokens (waste)
        self.rejected_invalid = 0      # admissions refused for length/ids
        # pristine single-slot row: never written in place; admissions
        # prefill into a fresh copy and releases write it over the slot,
        # so a reused slot cannot leak the previous tenant's KV
        self._empty_row = self.model.init_cache(1, max_len, self.device)
        # tiles: an autotuned level ladder (the ``ladder`` argument — a
        # LadderSpec or its raw levels list — else the process-global
        # ladder, snapshotted now), else H100_LEVEL_TILES
        lad = ladder if ladder is not None else dispatch.active_ladder()
        if lad is not None and hasattr(lad, "levels"):
            lad = lad.levels
        if lad is not None:
            if len(lad) != cm.NUM_LEVELS:
                raise ValueError(f"ladder has {len(lad)} levels, expected "
                                 f"{cm.NUM_LEVELS}")
            self._ladder = [{op: dict(kw) for op, kw in lvl.items()}
                            for lvl in lad]
        else:
            self._ladder = None
        # measured-counter loop: per-quantum wall times feed this bank
        self.counter_bank = CounterBank()
        self.co_runner_load = 0
        self.interference_level = 0.0
        self._active_tiles: dict | None = None
        self.level_switches = 0           # distinct-version switch count
        self.quantum_buckets = tuple(sorted(set(
            int(b) for b in quantum_buckets)))
        if not self.quantum_buckets or self.quantum_buckets[0] < 1:
            raise ValueError("quantum_buckets must be positive ints")
        # dispatch-granularity counters: tokens_per_sync is the tokens
        # decoded per device->host sync
        self.host_syncs = 0
        self.tokens_decoded = 0
        self.quantum_calls = 0
        self.version_cache = VersionCache(self.model)
        self._use_version({})             # baseline: no overrides installed

    # ------------------------------------------------------------------
    def _use_version(self, tiles: dict) -> None:
        entry = self.version_cache.get(tiles)
        self._entry = entry
        self._prefill_one = entry.prefill
        self._prefill_chunk = entry.prefill_chunk
        self._decode = entry.decode

    @property
    def tokens_per_sync(self) -> float:
        return self.tokens_decoded / max(self.host_syncs, 1)

    def tiles_for_level(self, level: float) -> dict:
        """The tile table selected at ``level``."""
        idx = cm.level_to_idx(cm.level_interference(level).level)
        table = self._ladder if self._ladder is not None \
            else H100_LEVEL_TILES
        return {op: dict(kw) for op, kw in table[idx].items()}

    def set_interference_level(self, level: float) -> dict:
        """Switch the active code version to the one for ``level`` (0.0 =
        solo .. 1.0 = heavy co-location): a version-cache swap, plus an
        atomic install of the same tiles in the process-global table for
        observability.  Returns the installed tiles."""
        itf = cm.level_interference(level)
        tiles = self.tiles_for_level(itf.level)
        if tiles != self._active_tiles:
            dispatch.install_tile_overrides(tiles)
            self._use_version(tiles)
            self._active_tiles = tiles
            self.level_switches += 1
        self.interference_level = itf.level
        return {op: dict(kw) for op, kw in tiles.items()}

    def warmup(self, prompt_lens: tuple[int, ...] = (),
               levels: list[float] | None = None,
               quantum_buckets: tuple[int, ...] | None = None) -> dict:
        """Build and run the entry points of every interference level
        (default: the full grid) so later level switches and steps build
        nothing: one decode per version, every fused K-bucket, every
        prefill-chunk bucket, and a monolithic prefill per length in
        ``prompt_lens``.  Rows of resident requests are restored after
        the warm decodes.  Returns the version-cache stats."""
        if levels is None:
            levels = [cm.grid_point(i) for i in range(cm.NUM_LEVELS)]
        buckets = (self.quantum_buckets if quantum_buckets is None
                   else tuple(quantum_buckets))
        live_rows = [(i, self._slice_row(i))
                     for i, r in enumerate(self.slot_req) if r is not None]
        toks = torch.zeros(self.slots, dtype=torch.int64, device=self.device)
        pos = torch.zeros(self.slots, dtype=torch.int64, device=self.device)
        tile_tables = [self._active_tiles if self._active_tiles is not None
                       else {}]
        tile_tables += [self.tiles_for_level(lv) for lv in levels]
        for entry in self.version_cache.warmup(tile_tables):
            _, self.cache = entry.decode(self.params, {"tokens": toks},
                                         self.cache, pos)
            for k in buckets:
                self.version_cache.quantum(entry, k, self.slots)
            if self.chunked_prefill:
                for cb in self.prefill_buckets:
                    entry.prefill_chunk(
                        self.params, torch.zeros((1, cb), dtype=torch.int64,
                                                 device=self.device),
                        self._fresh_row(), 0, cb)
            for plen in prompt_lens:
                entry.prefill(
                    self.params, torch.zeros((1, int(plen)),
                                             dtype=torch.int64,
                                             device=self.device),
                    self._fresh_row())
        for i, row in live_rows:
            self._write_row(i, row)
        return dict(self.version_cache.stats)

    @property
    def active_slots(self) -> int:
        return sum(r is not None for r in self.slot_req)

    # ------------------------------------------------------------------
    def _free_slot(self) -> int | None:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def _fresh_row(self):
        return tree_map_with_path(lambda _, a: a.clone(), self._empty_row)

    def _slice_row(self, slot: int):
        """A copy of one slot's cache as a batch-1 row."""
        return tree_map_with_path(
            lambda p, c: c.narrow(cache_batch_axis(p), slot, 1).clone(),
            self.cache)

    def _write_row(self, slot: int, row) -> None:
        """Copy a batch-1 row over one slot of the batched cache."""
        def put(p, c, r):
            ax = cache_batch_axis(p)
            c.select(ax, slot).copy_(r.select(ax, 0))
        tree_map_with_path(put, self.cache, row)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A small host array on the engine's device, copied without
        blocking the host (pinned staging)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def release_slot(self, slot: int) -> None:
        """Free a slot and write the pristine row over it, so the previous
        tenant's KV is unreachable."""
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0
        self._write_row(slot, self._empty_row)

    def _prefill_schedule(self, n: int) -> collections.deque:
        """Chunk sizes for an ``n``-token prompt: full chunks plus a
        power-of-two tail bucket (padded up), split further if the padding
        would write past ``max_len``."""
        out: collections.deque = collections.deque()
        done = 0
        c = self.prefill_chunk_len
        while n - done >= c:
            out.append(c)
            done += c
        rem = n - done
        while rem:
            b = _next_pow2(rem)
            if done + b <= self.max_len:
                out.append(b)                  # padded tail bucket
                break
            out.append(b // 2)                 # largest pow2 < rem, all real
            done += b // 2
            rem -= b // 2
        return out

    def admit_request(self, req: Request, *, drain: bool = False) -> bool:
        """Reserve a slot for ``req`` and queue its prefill chunks without
        running them (``prefill_step`` runs them); ``drain=True`` runs the
        queued chunks until this request's first token is out.

        Returns False when no slot is free.  Raises ``ValueError`` for a
        prompt the cache row cannot hold (empty, or ``len >= max_len``) or
        with token ids outside the vocabulary (the reference clamps them;
        an index past the embedding would fault on the card).

        With ``chunked_prefill=False`` the whole prompt prefills here."""
        n = len(req.prompt)
        prompt = np.asarray(req.prompt)
        if n < 1 or n >= self.max_len:
            self.rejected_invalid += 1
            raise ValueError(
                f"prompt length {n} outside [1, {self.max_len - 1}]: the "
                f"cache row holds max_len={self.max_len} positions and "
                "needs at least one free for decode")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            self.rejected_invalid += 1
            raise ValueError(f"prompt token ids outside [0, "
                             f"{self.cfg.vocab_size})")
        slot = self._free_slot()
        if slot is None:
            return False
        self.slot_req[slot] = req
        self.slot_pos[slot] = n
        if self.chunked_prefill:
            self._prefill[slot] = _PrefillState(
                req=req, row_cache=self._fresh_row(),
                schedule=self._prefill_schedule(n))
            if drain:
                while not req.output:
                    self.prefill_step()
            return True
        toks = self._to_device(prompt.astype(np.int64))[None, :]
        logits, row_cache = self._prefill_one(self.params, toks,
                                              self._fresh_row())
        self._write_row(slot, row_cache)
        # the one device->host sync of a monolithic admission
        first = int(torch.argmax(logits[0]))
        self.host_syncs += 1
        self.tokens_decoded += 1
        self.prefill_tokens += n
        req.output.append(first)
        return True

    @property
    def prefill_pending(self) -> int:
        """Slots whose prompts are not fully prefilled yet."""
        return len(self._prefill)

    def prefill_step(self, slot: int | None = None) -> PrefillQuantum | None:
        """Run ONE prefill chunk for ``slot`` (default: the oldest slot
        still prefilling) into the slot's row cache.  Only the final chunk
        syncs (the first-token argmax) and writes the row into the batched
        cache.  Returns what ran, or None when nothing is prefilling."""
        if not self._prefill:
            return None
        if slot is None:
            slot, st = next(iter(self._prefill.items()))
        else:
            st = self._prefill[slot]
        c = st.schedule.popleft()
        n = len(st.req.prompt)
        valid = min(c, n - st.done)
        toks = np.zeros(c, np.int64)
        toks[:valid] = st.req.prompt[st.done:st.done + valid]
        traces0 = self.version_cache.traces
        t0 = time.perf_counter()
        logits, st.row_cache = self._prefill_chunk(
            self.params, self._to_device(toks)[None], st.row_cache, st.done,
            valid)
        st.done += valid
        self.prefill_chunks += 1
        self.prefill_tokens += valid
        self.prefill_pad_tokens += c - valid
        finished = not st.schedule
        if finished:
            self._write_row(slot, st.row_cache)
            # the one device->host sync of an admission (finishing chunk)
            first = int(torch.argmax(logits[0]))
            if traces0 == self.version_cache.traces:
                self.counter_bank.observe(
                    "prefill", _next_pow2(max(st.done, 1)),
                    self._entry.key, time.perf_counter() - t0,
                    tokens=valid, co_runners=self.co_runner_load)
            self.host_syncs += 1
            self.tokens_decoded += 1
            st.req.output.append(first)
            del self._prefill[slot]
        return PrefillQuantum(slot=slot, rid=st.req.rid, chunk=c,
                              tokens=valid, finished=finished)

    def step_once(self) -> list[Request]:
        """One decode step for every active slot; returns finished reqs
        (a 1-step non-fused quantum: one sync, one token per row)."""
        return self.finish_quantum(self.begin_quantum(1, fused=False))

    # the reference's name, bound without a second ``def step``: the
    # repository's static analyzer resolves the reference's
    # ``t.engine.step()`` by that method name being unique
    step = step_once

    # ------------------------------------------------------------------
    # Fused dispatch quanta
    # ------------------------------------------------------------------
    def begin_quantum(self, k: int, *,
                      fused: bool = True) -> QuantumHandle | None:
        """Dispatch up to ``k`` decode steps for every active slot without
        syncing.  Per-row budgets (``n_left``) clamp each slot to its
        remaining token/length allowance and to ``k``; rows past their
        budget freeze on device, so the result is token-for-token
        identical to ``k`` sequential :meth:`step` calls.  The quantum is
        capped at the largest K-bucket.  ``fused=False`` dispatches one
        plain decode step.  Returns None when no slot is decodable."""
        active = [i for i, r in enumerate(self.slot_req)
                  if r is not None and i not in self._prefill]
        if not active or k <= 0:
            return None
        n_left = np.zeros(self.slots, np.int64)
        toks = np.zeros(self.slots, np.int64)
        for i in active:
            req = self.slot_req[i]
            need = req.max_new_tokens + 1 - len(req.output)
            room = self.max_len - 1 - int(self.slot_pos[i])
            # a live row always decodes at least one step
            n_left[i] = max(1, min(need, room))
            toks[i] = req.output[-1]
        if not fused:
            # free slots decode garbage at position 0; the next
            # admission writes a whole prefilled row over them
            traces0 = self.version_cache.traces
            t0 = time.perf_counter()
            inp = self._to_device(np.stack([toks, self.slot_pos]))
            logits, self.cache = self._decode(
                self.params, {"tokens": inp[0]}, self.cache, inp[1])
            n_left = np.minimum(n_left, 1)
            return QuantumHandle(block=torch.argmax(logits, dim=-1)[None],
                                 n_left=n_left, steps=1, active=active,
                                 t0=t0, traces0=traces0, bucket=1,
                                 tiles=self._entry.key)
        steps = int(min(int(k), int(n_left.max()),
                        self.quantum_buckets[-1]))
        bucket = next(b for b in self.quantum_buckets if b >= steps)
        n_left = np.minimum(n_left, steps)
        qfn = self.version_cache.quantum(self._entry, bucket, self.slots)
        traces0 = self.version_cache.traces
        t0 = time.perf_counter()
        inp = self._to_device(np.stack([toks, self.slot_pos, n_left]))
        block, self.cache, _ = qfn(self.params, inp[0], self.cache, inp[1],
                                   inp[2])
        self.quantum_calls += 1
        return QuantumHandle(block=block, n_left=n_left, steps=steps,
                             active=active, t0=t0, traces0=traces0,
                             bucket=bucket, tiles=self._entry.key)

    def finish_quantum(self, handle: QuantumHandle | None) -> list[Request]:
        """Block on a dispatched quantum — the single device->host sync —
        and do the bookkeeping: append each row's tokens, advance
        positions, free finished slots.  Returns finished requests."""
        if handle is None:
            return []
        # the one device->host sync of a quantum
        block = handle.block.cpu().numpy()
        self.host_syncs += 1
        if handle.t0 > 0.0 and \
                handle.traces0 == self.version_cache.traces:
            self.counter_bank.observe(
                "decode", handle.bucket, handle.tiles,
                time.perf_counter() - handle.t0,
                tokens=int(handle.n_left.sum()),
                co_runners=self.co_runner_load)
        finished = []
        for i in handle.active:
            req = self.slot_req[i]
            took = int(handle.n_left[i])
            req.output.extend(int(t) for t in block[:took, i])
            self.slot_pos[i] += took
            self.tokens_decoded += took
            handle.row_steps[req.rid] = took
        for i in handle.active:
            req = self.slot_req[i]
            if len(req.output) >= req.max_new_tokens + 1 or \
                    self.slot_pos[i] >= self.max_len - 1:
                req.done = True
                finished.append(req)
                self.release_slot(i)
        return finished

    def step_quantum(self, k: int) -> list[Request]:
        """Fused ``k``-step decode with exactly one host sync."""
        return self.finish_quantum(self.begin_quantum(k))

    def run_to_completion(self, reqs: list[Request],
                          max_steps: int = 10_000, *,
                          fused: bool = True) -> list[Request]:
        """Serve ``reqs`` to completion (largest K-bucket per fused
        dispatch, or the per-token loop with ``fused=False``; both give
        identical token streams)."""
        pending = collections.deque(reqs)
        done: list[Request] = []
        k = self.quantum_buckets[-1] if fused else 1
        steps = 0
        while (pending or any(r is not None for r in self.slot_req)) \
                and steps < max_steps:
            while pending and self.admit_request(pending[0]):
                pending.popleft()
            while self._prefill:        # drain queued chunks before decode
                self.prefill_step()
            done.extend(self.finish_quantum(self.begin_quantum(
                k, fused=fused)))
            steps += 1
        return done


# The class has its own name and the reference's name is an alias: the
# repository's static analyzer (repro.analysis.callgraph) keys classes by
# bare name, and a second class named ServingEngine would merge with the
# reference's and shrink the reference's audited hot path.
ServingEngine = TorchServingEngine
