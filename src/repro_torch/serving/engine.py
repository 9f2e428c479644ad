"""Batched serving engine of the PyTorch port (the dense and paged KV
cache paths of ``repro.serving.engine``).

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

Paged KV cache (``page_size=...``): the linear KV leaves live in one
physical page pool per layer, addressed through a per-slot page table
that rides inside the cache dict; memory becomes a scheduler-visible
dimension (``PagePool`` commitments gate admission, free-page headroom
clamps decode quanta) and common prompt prefixes are shared across
requests (refcounted pages, copy-on-write before the first decode write).
Prefill still fills a dense batch-1 row, which is scattered into pages
when the prompt finishes.

The VELTAIR integration point: ``set_interference_level`` selects the
code version (kernel tiles) for the current pressure and swaps in its
:class:`~repro_torch.serving.version_cache.VersionCache` entry; the
tiles reach every kernel launch of the entry's calls.  The tiles come
from the dominant layer's multi-version table when the engine is given
``version_sets`` (a plan compiled by the adaptive compiler, e.g. for
``cost_model.H100_SXM``), else from a level ladder, else from the
built-in :data:`H100_LEVEL_TILES`.  On the card every version of that
table must be a tile ``block_matmul`` is built for, or construction
raises.

Streams: on the card every device operation of an engine (admission and
row copies, the staged inputs, graph replays, the host sync's copy) runs
on the engine's own CUDA stream (``stream=``; a new one by default), so
engines that share a card overlap their work instead of serializing on
the default stream.

Entry points run on the card: ``device=None`` means ``"cuda"``, and an
engine raises ``RuntimeError`` when CUDA is absent unless the caller asks
for ``device="cpu"``.

Speculative decode quanta (``speculative=True``): a prompt-lookup
drafter (:class:`~repro_torch.serving.speculative.NgramDrafter`) proposes
up to ``spec_depth`` tokens per row from the request's own history; one
batched verify forward (``TorchModel.verify_quantum``) scores them and
each row emits its longest matching prefix plus a corrected token.  No
usable draft, a row too close to ``max_len``, or too few free pages falls
back to the plain fused quantum (counted in ``spec_fallbacks``).  The
token block, the rows' emission and acceptance come back in one host
sync.

CUDA graphs (``cuda_graphs=True``, the default): on the card every call
of a version-cache entry — a fused quantum per K-bucket, a speculative
verify per (K-bucket, draft depth), a prefill chunk per bucket, the
one-step decode, a monolithic prefill per prompt length — is a CUDA
graph, captured at its first use (``warmup()`` captures them
all) and replayed after.  A step copies its few host values into the
engine's static inputs (:class:`StepInputs`), copies a prefilling slot's
row into the static prefill row, and replays.  ``cuda_graphs=False``
runs the same calls and buffers eagerly (the reference's
``jax.disable_jit``); on the CPU the calls always run eagerly, through
the same static buffers.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cost_model as cm
from repro_torch.core.counters import CounterBank
from repro_torch.kernels import block_matmul, dispatch
from repro_torch.models.model import Model, cache_batch_axis
from repro_torch.models.params import tree_map_with_path
from repro_torch.serving.paging import TRASH_PAGE, PagePool
from repro_torch.serving.speculative import NgramDrafter
from repro_torch.serving.version_cache import CudaGraphs, VersionCache

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


def _leaf(tree: dict, path: tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def on_engine_stream(method):
    """Run an engine method with the engine's stream as the current CUDA
    stream (``torch.cuda.stream(None)`` on a CPU engine changes
    nothing)."""
    @functools.wraps(method)
    def run(self, *args, **kw):
        with torch.cuda.stream(self.stream):
            return method(self, *args, **kw)
    return run


def resolve_device(device) -> torch.device:
    """``None`` means the card; asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev


class StepInputs:
    """The host values of one step on their way to the static inputs that
    every graph of an engine reads: one persistent int64 device buffer
    holding a prefill chunk's start ``t0`` and ``valid`` length, the rows'
    positions ``pos`` and step budgets ``n_left`` (B,), a speculative
    engine's ``drafts`` (B, depth) and the tokens (up to ``max_len``),
    written by one non-blocking copy per step from a persistent pinned
    staging buffer.

    The staging buffer has ``DEPTH`` rows, used in turn, and a row is
    rewritten only after its previous copy has run (an event per row): the
    host may run up to ``DEPTH`` steps ahead of the device, as it does
    through a run of prefill chunks, which do not sync."""

    DEPTH = 4

    def __init__(self, slots: int, max_len: int, device: torch.device,
                 depth: int = 0):
        self.cuda = device.type == "cuda"
        self.slots = slots
        self._drafts = 2 + 2 * slots
        self._tok = self._drafts + slots * depth
        width = self._tok + max(max_len, slots)
        self.dev = torch.zeros(width, dtype=torch.int64, device=device)
        self._host = torch.zeros((self.DEPTH, width), dtype=torch.int64,
                                 pin_memory=self.cuda)
        self._events = ([torch.cuda.Event() for _ in range(self.DEPTH)]
                        if self.cuda else None)
        self._next = 0
        self.t0 = self.dev[0]
        self.valid = self.dev[1]
        self.pos = self.dev[2:2 + slots]
        self.n_left = self.dev[2 + slots:self._drafts]
        self.drafts = self.dev[self._drafts:self._tok].view(slots, depth)
        self.tokens = self.dev[self._tok:self._tok + slots]

    def prompt(self, n: int) -> torch.Tensor:
        """The (1, n) static token input of a prefill of n tokens."""
        return self.dev[self._tok:self._tok + n].view(1, n)

    def push(self, tokens, *, t0: int = 0, valid: int = 0, pos=None,
             n_left=None, drafts=None) -> None:
        """Stage one step's values and copy them to the device buffer on
        the current stream.  Fields not given are overwritten with stale
        values: every call pushes each field it reads."""
        i = self._next
        self._next = (i + 1) % self.DEPTH
        if self.cuda:
            # veltair: ignore[torch-host-sync] waits only for this row's copy of DEPTH pushes ago (a no-op until first recorded), so the pinned row is not rewritten under it; it bounds the host's lead to DEPTH steps
            self._events[i].synchronize()
        # veltair: ignore[torch-host-sync] _host is a pinned CPU tensor: .numpy() views host memory, nothing is copied from the card and nothing waits
        row = self._host[i].numpy()
        b, n = self.slots, self._tok + len(tokens)
        row[0], row[1] = t0, valid
        if pos is not None:
            row[2:2 + b] = pos
        if n_left is not None:
            row[2 + b:self._drafts] = n_left
        if drafts is not None:
            row[self._drafts:self._tok] = np.asarray(drafts).reshape(-1)
        row[self._tok:n] = tokens
        self.dev[:n].copy_(self._host[i, :n], non_blocking=True)
        if self.cuda:
            self._events[i].record()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (len,) int token ids
    max_new_tokens: int = 16
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    tier: str | None = None       # SLO tier (core.qos.TIER_ORDER); None =
                                  # untiered legacy request (standard urgency,
                                  # legacy qos_s-relative satisfaction)


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
    on-device (possibly not yet computed) tensor, the engine's own copy
    (a graph's output buffer is rewritten by later replays, so it is
    copied out on the stream right after the replay), written on the
    engine's stream: read it there or after that stream;
    ``finish_quantum`` performs the single device->host sync and the
    bookkeeping."""
    block: torch.Tensor            # (K, B) on-device token block
    n_left: np.ndarray             # (B,) per-row steps actually budgeted
    steps: int                     # quantum length (max over rows)
    active: list[int]              # slots live at dispatch time
    row_steps: dict = dataclasses.field(default_factory=dict)  # rid -> steps
    t0: float = 0.0                # perf_counter at dispatch (0 = untimed)
    traces0: int = -1              # version-cache builds at dispatch
    bucket: int = 0                # K-bucket the quantum ran
    tiles: tuple = ()              # tiles key of the dispatched version
    # speculative quanta (kind "spec"): ``block`` is the packed (d+3, B)
    # copy of the token block, the rows' emission and their acceptance;
    # ``emitted`` and ``accepted`` are views of its last two rows, and
    # finish_quantum folds the synced emission into n_left
    kind: str = "decode"           # "decode" | "spec"
    emitted: torch.Tensor | None = None   # (B,) n_emit (spec only)
    accepted: torch.Tensor | None = None  # (B,) acceptance (spec only)
    drafted: int = 0               # draft depth dispatched (spec only)


class TorchServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 4,
                 max_len: int = 256,
                 quantum_buckets: tuple[int, ...] = QUANTUM_BUCKETS,
                 chunked_prefill: bool = True,
                 prefill_chunk_len: int = PREFILL_CHUNK_LEN,
                 page_size: int | None = None, n_pages: int | None = None,
                 page_reserve: str = "worst", prefix_sharing: bool = True,
                 ladder=None, device=None, cuda_graphs: bool = True,
                 version_sets: list | None = None, stream=None,
                 speculative: bool = False, spec_depth: int = 4,
                 spec_ngram: int = 3, spec_recurrent: bool = True):
        """``cuda_graphs=False`` runs every entry point eagerly on the
        card (the same static buffers, no capture): the eager side of an
        eager/graph comparison.  On the CPU nothing is captured either
        way.  ``version_sets``: the plan's multi-version tables (the
        dominant layer's becomes the tile source).  ``stream``: the CUDA
        stream the engine's work runs on (None: a new stream of its own;
        engines given one stream serialize).  ``speculative``: fused
        quanta verify up to ``spec_depth`` drafted tokens per row (drafts
        from n-grams of up to ``spec_ngram`` tokens); a model with
        recurrent cache state speculates only with ``spec_recurrent``
        (its verify runs a restore pass)."""
        self.device = resolve_device(device)
        self.stream = (None if self.device.type != "cuda" else stream
                       if stream is not None else torch.cuda.Stream(
                           self.device))
        self.cfg = cfg
        self.model = Model(cfg)
        self.params = tree_map_with_path(lambda _, a: a.to(self.device),
                                         params)
        self.slots = batch_slots
        self.max_len = max_len
        # paged KV cache: page_size=None keeps the dense per-slot rows
        self.paged = page_size is not None
        self.page_size = int(page_size) if self.paged else 0
        self.page_reserve = page_reserve
        if self.paged:
            if self.page_size < 1 or max_len % self.page_size:
                raise ValueError(
                    f"page_size={page_size} must be >= 1 and divide "
                    f"max_len={max_len}")
            if page_reserve not in ("worst", "prompt"):
                raise ValueError(
                    f"page_reserve={page_reserve!r} not in ('worst', "
                    "'prompt')")
            self._paged_paths = self.model.paged_leaf_paths()
            if not self.model.all_cache_leaves_paged():
                raise ValueError(
                    f"{cfg.name}: not every cache leaf is pageable "
                    "(linear KV) — recurrent-state models keep the dense "
                    "layout")
            self.pages_per_slot = max_len // self.page_size
            if n_pages is None:
                n_pages = batch_slots * self.pages_per_slot
            self.pool: PagePool | None = PagePool(int(n_pages),
                                                 self.page_size)
            self.prefix_sharing = bool(prefix_sharing)
            self.cache = self.model.init_paged_cache(
                batch_slots, max_len, int(n_pages), self.page_size,
                self.device)
            # host mirror of the device page table + per-slot page maps
            self._page_table = np.zeros((batch_slots, self.pages_per_slot),
                                        np.int32)
            self._table_dirty = False
            self._slot_pages: list[dict[int, int]] = [
                {} for _ in range(batch_slots)]     # logical -> physical
            self._slot_shared: list[set[int]] = [
                set() for _ in range(batch_slots)]  # borrowed (COW-guarded)
            self._slot_commit = [0] * batch_slots   # reserved, unallocated
        else:
            self._paged_paths = frozenset()
            self.pages_per_slot = 0
            self.pool = None
            self.prefix_sharing = False
            self.cache = self.model.init_cache(batch_slots, max_len,
                                               self.device)
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
        # so a reused slot cannot leak the previous tenant's KV.  A paged
        # engine prefills into a dense row too and scatters it into pages
        self._empty_row = self.model.init_cache(1, max_len, self.device)
        # speculative decode quanta (the reference's semantics): drafts
        # from the request's own history, one batched verify forward, the
        # longest matching prefix plus a corrected token emitted
        self.speculative = bool(speculative)
        self.spec_depth = int(spec_depth)
        if self.speculative and self.spec_depth < 1:
            raise ValueError("spec_depth must be >= 1")
        self._spec_enabled = self.speculative and (
            bool(spec_recurrent) or not self.model.has_recurrent_leaves())
        self.drafter = (NgramDrafter(depth=self.spec_depth,
                                     max_ngram=int(spec_ngram))
                        if self.speculative else None)
        self.spec_quanta = 0       # speculative quanta dispatched
        self.spec_fallbacks = 0    # spec-eligible dispatches that fell back
        self.tokens_drafted = 0    # draft tokens submitted to verify
        self.tokens_accepted = 0   # tokens emitted past the corrected one
        self.spec_rollbacks = 0    # row-quanta where a draft was rejected
        self._spec_accept_ewma = 1.0   # emitted tokens per row and verify
        # static inputs of every graph: the step's host values, and the
        # prefill row every chunk and monolithic prefill runs in (a slot's
        # row is copied in before and out after; chunks of different
        # slots interleave)
        self._inputs = StepInputs(
            batch_slots, max_len, self.device,
            self.spec_depth if self._spec_enabled else 0)
        self._row = self.model.init_cache(1, max_len, self.device)
        # tiles: the dominant layer's multi-version table when version sets
        # are given (on the card each of its versions must be a tile the
        # kernel is built for: no fallback to another table), else an
        # autotuned level ladder (the ``ladder`` argument — a LadderSpec
        # or its raw levels list — else the process-global ladder,
        # snapshotted now), else H100_LEVEL_TILES
        self.version_sets = version_sets
        self._tile_source = (max(version_sets,
                                 key=lambda vs: vs.solo_tuned().flops)
                             if version_sets else None)
        if self._tile_source is not None and self.device.type == "cuda":
            unbuilt = sorted({(v.bm, v.bk, v.bn)
                              for v in self._tile_source.versions
                              if v.bm not in block_matmul.BM_CHOICES
                              or v.bk not in block_matmul.BK_CHOICES
                              or v.bn not in block_matmul.BN_CHOICES})
            if unbuilt:
                raise ValueError(
                    f"{cfg.name}: version set {self._tile_source.layer_name}"
                    f" holds (bm, bk, bn) tiles {unbuilt} that block_matmul "
                    f"is not built for (bm {block_matmul.BM_CHOICES}, bk "
                    f"{block_matmul.BK_CHOICES}, bn "
                    f"{block_matmul.BN_CHOICES}); compile the plan for the "
                    "card's spec (cost_model.H100_SXM)")
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
        self.version_cache = VersionCache(
            self.model, graphs=CudaGraphs(self.device)
            if self.device.type == "cuda" and cuda_graphs else None)
        # occupancy telemetry (peak valid tokens, peak occupied slots)
        self.peak_cache_tokens = 0
        self.peak_active_slots = 0
        # baseline: no overrides installed, or, given version sets, their
        # level-0 version (the engine then only ever runs the plan's)
        self._use_version(self.tiles_for_level(0.0)
                          if self._tile_source is not None else {})
        if self.stream is not None:
            # the weights, caches and buffers were made on the caller's
            # stream: the engine's first work waits for them
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    # ------------------------------------------------------------------
    def _use_version(self, tiles: dict) -> None:
        entry = self.version_cache.get(tiles)
        self._entry = entry
        self._entry_tiles = tiles
        self._prefill_one = entry.prefill
        self._prefill_chunk = entry.prefill_chunk
        self._decode = entry.decode

    @property
    def tokens_per_sync(self) -> float:
        return self.tokens_decoded / max(self.host_syncs, 1)

    # The runtime's and the SLO scheduler's hooks.  Each is defined under a
    # port name and bound to the reference's name as a class attribute,
    # not by a second ``def``: the repository's static analyzer resolves
    # some of the reference's calls by the method name being unique.
    @property
    def draft_acceptance(self) -> float:
        """Accepted draft tokens / drafted tokens (0.0 before any
        speculative quantum ran)."""
        return self.tokens_accepted / max(self.tokens_drafted, 1)

    draft_hit_rate = draft_acceptance

    def accept_per_step(self) -> float:
        """Expected tokens emitted per dispatched decode step (>= 1.0;
        exactly 1.0 without speculative quanta): an EWMA of the rows'
        emission per verify.  The SLO scheduler's slack arithmetic
        multiplies its step budget by this."""
        if not self._spec_enabled:
            return 1.0
        return max(1.0, float(self._spec_accept_ewma))

    expected_accept_per_step = accept_per_step

    @property
    def speculative_stats(self) -> dict:
        """Speculative-decode counters for the metrics (the reference's
        keys)."""
        return {"spec_quanta": self.spec_quanta,
                "spec_fallbacks": self.spec_fallbacks,
                "tokens_drafted": self.tokens_drafted,
                "tokens_accepted": self.tokens_accepted,
                "draft_hit_rate": self.draft_acceptance,
                "spec_rollbacks": self.spec_rollbacks}

    spec_stats = speculative_stats

    def tiles_for_level(self, level: float) -> dict:
        """The tile table selected at ``level``: the tile source's version
        for that pressure (a ``"matmul"`` table only; attention then runs
        its default block, level 0's), else the ladder's or the built-in
        table's level."""
        itf = cm.level_interference(level)
        if self._tile_source is not None:
            v = self._tile_source.version_for_pressure(itf)
            return {"matmul": {"bm": int(v.bm), "bk": int(v.bk),
                               "bn": int(v.bn)}}
        idx = cm.level_to_idx(itf.level)
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

    @on_engine_stream
    def warmup(self, prompt_lens: tuple[int, ...] = (),
               levels: list[float] | None = None,
               quantum_buckets: tuple[int, ...] | None = None) -> dict:
        """Build (capture, on the card) and run the entry points of every
        distinct version the interference levels select (default: the
        full grid of levels) so later level switches and steps build
        nothing: one decode per version, every fused K-bucket, every
        reachable (K-bucket, draft depth) verify of a speculative engine,
        every prefill-chunk bucket, and a monolithic prefill per length
        in ``prompt_lens``.  The warm quanta and verifies freeze every row
        (``n_left`` 0), the warm decodes write position 0 of every slot,
        and rows of resident requests are restored after.  Returns the
        version-cache stats."""
        if levels is None:
            levels = [cm.grid_point(i) for i in range(cm.NUM_LEVELS)]
        buckets = (self.quantum_buckets if quantum_buckets is None
                   else tuple(quantum_buckets))
        # a paged engine's pools survive the warm decodes, which write to
        # the trash page; dense rows of resident requests are restored
        live_rows = [(i, self._slice_row(i))
                     for i, r in enumerate(self.slot_req)
                     if r is not None and not self.paged]
        if self.paged:
            # aim every slot at the trash page while the warm decodes run
            # at position 0: their writes land there, never in live pages
            self.cache["page_table"].zero_()
            self._table_dirty = True
        inp = self._inputs
        zeros = np.zeros(self.slots, np.int64)
        tile_tables = [self._entry_tiles]
        tile_tables += [self.tiles_for_level(lv) for lv in levels]
        warmed: set = set()
        for entry in self.version_cache.warmup(tile_tables):
            # levels that select one version warm it once
            if entry.key in warmed:
                continue
            warmed.add(entry.key)
            inp.push(zeros, pos=zeros, n_left=zeros,
                     drafts=np.zeros(inp.drafts.shape, np.int64))
            # the calls update the cache in place and return it: adopting
            # it rebinds self.cache to the same tensors
            _, self.cache = entry.decode(self.params, {"tokens": inp.tokens},
                                         self.cache, inp.pos)
            for k in buckets:
                qfn = self.version_cache.quantum(entry, k, self.slots)
                _, self.cache, _ = qfn(self.params, inp.tokens, self.cache,
                                       inp.pos, inp.n_left)
            if self._spec_enabled:
                # every reachable (bucket, depth) pair: a verify runs the
                # smallest bucket covering min(k, d+1), so buckets above
                # that one are never asked for
                cap = min(self.spec_depth + 1, self.quantum_buckets[-1])
                top = next(b for b in self.quantum_buckets if b >= cap)
                for bucket in buckets:
                    if bucket > top:
                        continue
                    sfn = self.version_cache.spec_quantum(
                        entry, bucket, self.spec_depth, self.slots)
                    out = sfn(self.params, inp.tokens, inp.drafts,
                              self.cache, inp.pos, inp.n_left)
                    self.cache = out[3]
            if self.chunked_prefill:
                for cb in self.prefill_buckets:
                    inp.push(np.zeros(cb, np.int64), valid=cb)
                    entry.prefill_chunk(self.params, inp.prompt(cb),
                                        self._row, inp.t0, inp.valid)
            for plen in prompt_lens:
                inp.push(np.zeros(int(plen), np.int64))
                entry.prefill(self.params, inp.prompt(int(plen)), self._row)
        for i, row in live_rows:
            self._write_row(i, row)
        self._sync_table()       # restore the real table from the mirror
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

    @staticmethod
    def _copy_row(dst, src) -> None:
        """Copy one batch-1 row cache over another, leaf by leaf, in
        place."""
        tree_map_with_path(lambda _, d, s: d.copy_(s), dst, src)

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

    # A paged engine's cache leaves are all page pools (L, n_pages + 1,
    # page_size, ...) under the same paths as the dense row's
    # (L, 1, max_len, ...) leaves, plus the page table; a layer outside
    # the stacked blocks (deepseek's ``pro_0``) has no leading L, so its
    # pages are axis 0 (``cache_batch_axis``).
    def _scatter_row(self, row, wtab: np.ndarray) -> None:
        """Write a dense batch-1 row into the pools, page by page, at the
        physical pages of ``wtab`` (pages_per_slot,); logical pages that
        ``wtab`` sends to the trash page (borrowed or unmapped) are
        skipped."""
        js = np.flatnonzero(wtab != TRASH_PAGE)
        if not len(js):
            return
        src = self._to_device(js)
        dst = self._to_device(wtab[js].astype(np.int64))
        for path in self._paged_paths:
            r, ax = _leaf(row, path), cache_batch_axis(path)
            pages = r.reshape(*r.shape[:ax], self.pages_per_slot,
                              self.page_size, *r.shape[ax + 2:])
            _leaf(self.cache, path).index_copy_(
                ax, dst, pages.index_select(ax, src))

    def _gather_row(self, trow: np.ndarray):
        """A fresh dense batch-1 row holding the pages of ``trow``
        (pages_per_slot,) at their logical offsets (the shared-prefix
        admission path: borrowed pages land where the unshared tail can
        prefill on top of them; entries still unmapped read the trash
        page, garbage the remaining chunks overwrite before any query
        attends to it)."""
        idx = self._to_device(trow.astype(np.int64))
        return tree_map_with_path(
            lambda path, r: _leaf(self.cache, path).index_select(
                cache_batch_axis(path), idx).reshape(r.shape),
            self._empty_row)

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: physical page ``src`` into ``dst`` in every pool
        (one logical page has the same physical index in every layer's
        pool), in place, on the stream ahead of the quantum that writes
        the page."""
        for path in self._paged_paths:
            pool, ax = _leaf(self.cache, path), cache_batch_axis(path)
            pool.select(ax, dst).copy_(pool.select(ax, src))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A small host array on the engine's device, copied without
        blocking the host (pinned staging)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ------------------------------------------------------------------
    # Page accounting (paged engines only)
    # ------------------------------------------------------------------
    def _sync_table(self) -> None:
        """Push the host page-table mirror to the device when stale, into
        the one table tensor every paged graph reads, without blocking the
        host: on the card through a pinned copy of the mirror (the host
        edits the mirror right after)."""
        if self.paged and self._table_dirty:
            table = torch.from_numpy(self._page_table)
            if self.device.type == "cuda":
                table = table.pin_memory()
            self.cache["page_table"].copy_(table, non_blocking=True)
            self._table_dirty = False

    def _alloc_page(self, slot: int) -> int | None:
        """One physical page for ``slot``, drawing down its admission
        commitment first (those draws cannot fail); uncommitted draws
        return None when the pool's free surplus is exhausted (counted as
        a stall by the pool)."""
        assert self.pool is not None
        if self._slot_commit[slot] > 0:
            self._slot_commit[slot] -= 1
            return self.pool.take_page(reserved=True)
        return self.pool.take_page(reserved=False)

    def _probe_prefix(self, prompt) -> tuple[list, tuple | None]:
        """Published pages covering a prefix of ``prompt``: the full-page
        hits [(logical, physical), ...] plus an optional partial-tail hit,
        a published page whose tokens start with the whole rest of the
        prompt (positions beyond stay causally masked until copy-on-write
        privatizes the page)."""
        assert self.pool is not None
        ps = self.page_size
        toks = tuple(int(t) for t in prompt)
        n = len(toks)
        shared: list[tuple[int, int]] = []
        j = 0
        while (j + 1) * ps <= n:
            phys = self.pool.lookup_page(toks[:j * ps],
                                         toks[j * ps:(j + 1) * ps])
            if phys is None:
                break
            shared.append((j, phys))
            j += 1
        partial = None
        rem = toks[j * ps:]
        if rem and len(rem) < ps:
            phys = self.pool.lookup_covering_page(toks[:j * ps], rem)
            if phys is not None:
                partial = (j, phys)
        return shared, partial

    def _horizon_pages(self, n: int, max_new_tokens: int) -> int:
        """Pages a request reserves: its worst case (prompt plus every new
        token) or, with ``page_reserve="prompt"``, the prompt and one."""
        horizon = (n + max(int(max_new_tokens), 1)
                   if self.page_reserve == "worst" else n + 1)
        return self.pool.pages_for_tokens(min(horizon, self.max_len))

    def pages_to_admit(self, prompt,
                       max_new_tokens: int) -> tuple[int, int | None]:
        """(pages_needed, pages_free) for an admission controller: the
        worst-case pages this request would commit (net of shareable
        prefix pages) and the pool's uncommitted free surplus.  A dense
        engine reports (0, None): memory is no conflict dimension there."""
        if not self.paged:
            return 0, None
        assert self.pool is not None
        shared: list = []
        if self.prefix_sharing and self.chunked_prefill:
            shared, _ = self._probe_prefix(prompt)
        need = self._horizon_pages(len(prompt), max_new_tokens) - len(shared)
        return max(need, 0), self.pool.uncommitted_free

    # the reference's name, bound without a second ``def``: the static
    # analyzer resolves the reference runtime's ``engine.admission_pages``
    # by the method name being unique
    admission_pages = pages_to_admit

    def _paged_admit(self, req: Request, slot: int,
                     n: int) -> tuple[int, object] | None:
        """Page-pool side of admission: probe the prefix index, commit the
        worst-case page budget, map shared pages (refcounted) and allocate
        owned pages covering the unshared prompt.  Returns (start,
        row_cache) — the prefill start (shared tokens skip prefill; the
        last prompt token always prefills, for the first-token logits)
        and, past a shared prefix, the row holding it to prefill on top
        of (None: a fresh row) — or None when the pool cannot commit
        (counted as a conflict)."""
        assert self.pool is not None
        pool, ps = self.pool, self.page_size
        shared: list[tuple[int, int]] = []
        partial: tuple | None = None
        if self.prefix_sharing and self.chunked_prefill:
            shared, partial = self._probe_prefix(req.prompt)
        commit = max(self._horizon_pages(n, req.max_new_tokens)
                     - len(shared), 0)
        if not pool.reserve(commit):
            return None
        self._slot_commit[slot] = commit
        pages = self._slot_pages[slot]
        borrowed = self._slot_shared[slot]
        pages.clear()
        borrowed.clear()
        trow = self._page_table[slot]
        trow[:] = TRASH_PAGE
        shared_len = len(shared) * ps
        if partial is not None:
            shared = shared + [partial]
            shared_len = n
        for j, phys in shared:
            pool.retain_page(phys)
            pool.shared_hits += 1
            pages[j] = phys
            borrowed.add(j)
            trow[j] = phys
        # owned pages covering the rest of the prompt (the commitment
        # covers every one of them, so these allocations cannot fail)
        for j in range(len(shared), pool.pages_for_tokens(n)):
            phys = self._alloc_page(slot)
            assert phys is not None
            pages[j] = phys
            trow[j] = phys
        self._table_dirty = True
        start = min(shared_len, n - 1)
        return start, self._gather_row(trow) if start > 0 else None

    def _write_table(self, slot: int) -> np.ndarray:
        """Scatter destinations of a finished prefill row: owned pages
        keep their physical index, borrowed and unmapped pages divert to
        the trash page (their content already lives in the pool or was
        never real)."""
        wtab = np.full(self.pages_per_slot, TRASH_PAGE, np.int32)
        borrowed = self._slot_shared[slot]
        for j, phys in self._slot_pages[slot].items():
            if j not in borrowed:
                wtab[j] = phys
        return wtab

    def _publish_slot_pages(self, slot: int, req: Request) -> None:
        """Advertise the slot's owned FULL prompt pages in the prefix
        index.  Partial tail pages are never published: decode writes into
        them, and an owner never writes its own published page (published
        spans end at or before the prompt, decode writes after it)."""
        if not (self.paged and self.prefix_sharing):
            return
        assert self.pool is not None
        ps = self.page_size
        toks = tuple(int(t) for t in req.prompt)
        borrowed = self._slot_shared[slot]
        for j, phys in self._slot_pages[slot].items():
            if j not in borrowed and (j + 1) * ps <= len(toks):
                self.pool.publish_page(toks[:j * ps],
                                       toks[j * ps:(j + 1) * ps], phys)

    def _finish_row(self, slot: int, row, req: Request) -> None:
        """Write a fully prefilled row into the batched cache (scattered
        into the slot's owned pages on a paged engine, whose full prompt
        pages are then published)."""
        if self.paged:
            self._scatter_row(row, self._write_table(slot))
            self._publish_slot_pages(slot, req)
        else:
            self._write_row(slot, row)

    @on_engine_stream
    def release_slot(self, slot: int) -> None:
        """Free a slot so the previous tenant's KV is unreachable.  Dense:
        write the pristine row over it.  Paged: drop the slot's page
        references (a page frees when its last holder leaves; published
        pages another request still shares survive), return unused
        commitment, and park the table row on the trash page."""
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0
        if not self.paged:
            self._write_row(slot, self._empty_row)
            return
        assert self.pool is not None
        for phys in self._slot_pages[slot].values():
            self.pool.release_page(phys)
        self._slot_pages[slot].clear()
        self._slot_shared[slot].clear()
        self.pool.unreserve(self._slot_commit[slot])
        self._slot_commit[slot] = 0
        self._page_table[slot, :] = TRASH_PAGE
        self._table_dirty = True

    def _paged_preflight(self, active: list[int],
                         n_left: np.ndarray) -> np.ndarray:
        """Map or privatize every page the coming decode writes touch.

        For each row writing positions [pos, pos + n_left): allocate
        missing pages (commitment first), and privatize borrowed pages
        before their first write — copy-on-write while other holders
        remain, plain takeover (unpublish) when this slot is the last.  A
        row that cannot get a page is clamped to its last mapped position
        (the pool counts the stall; with ``page_reserve="worst"`` stalls
        cannot happen).  Ends by uploading the table."""
        assert self.pool is not None
        pool, ps = self.pool, self.page_size
        for i in active:
            steps = int(n_left[i])
            if steps <= 0:
                continue
            pos = int(self.slot_pos[i])
            pages = self._slot_pages[i]
            borrowed = self._slot_shared[i]
            for j in range(pos // ps, (pos + steps - 1) // ps + 1):
                phys = pages.get(j)
                if phys is None:
                    new = self._alloc_page(i)
                    if new is None:
                        n_left[i] = max(j * ps - pos, 0)
                        break
                    pages[j] = new
                    self._page_table[i, j] = new
                    self._table_dirty = True
                elif j in borrowed:
                    if pool.page_refcount(phys) > 1:
                        new = self._alloc_page(i)
                        if new is None:
                            n_left[i] = max(j * ps - pos, 0)
                            break
                        self._copy_page(phys, new)
                        pool.release_page(phys)
                        pool.cow_copies += 1
                        pages[j] = new
                        self._page_table[i, j] = new
                    else:
                        # sole holder: take ownership; stop advertising
                        # the original tokens (the content will diverge)
                        pool.unpublish_page(phys)
                    borrowed.discard(j)
                    self._table_dirty = True
        self._sync_table()
        return n_left

    def decode_headroom(self, k: int) -> int:
        """Clamp a decode quantum to free-page headroom: the largest
        k' <= k whose worst-case new-page demand across decodable rows the
        pool can meet now.  Never below 1 (the preflight clamps, and
        counts, rows a single step cannot map).  A dense engine returns k
        unchanged."""
        if not self.paged or k <= 1:
            return max(int(k), 1)
        assert self.pool is not None
        ps = self.page_size
        rows = [(int(self.slot_pos[i]), budget, self._slot_pages[i])
                for i, _, budget in self.decodable_rows()]
        free = self.pool.free_pages
        best = 1
        for kk in range(1, int(k) + 1):
            demand = 0
            for pos, budget, pages in rows:
                steps = min(kk, budget)
                demand += sum(
                    1 for j in range(pos // ps, (pos + steps - 1) // ps + 1)
                    if j not in pages)
            if demand > free:
                break
            best = kk
        return best

    # the reference's name, bound without a second ``def`` (see
    # ``admission_pages``)
    decode_k_headroom = decode_headroom

    # ------------------------------------------------------------------
    # Occupancy telemetry
    # ------------------------------------------------------------------
    @property
    def cache_valid_tokens(self) -> int:
        """Tokens resident on behalf of live requests (prefilled plus
        decoded positions across occupied slots)."""
        total = 0
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            st = self._prefill.get(i)
            total += st.done if st is not None else int(self.slot_pos[i])
        return total

    @property
    def cache_utilization(self) -> float:
        """Peak valid tokens / peak resident token capacity (dense:
        slots * max_len; paged: the page high-water mark).  Shared pages
        are resident once but valid for every holder, so prefix sharing
        can push this past 1.0."""
        cap = (self.pool.peak_used * self.page_size
               if self.paged and self.pool is not None
               else self.slots * self.max_len)
        return self.peak_cache_tokens / cap if cap else 0.0

    def _note_occupancy(self) -> None:
        self.peak_active_slots = max(self.peak_active_slots,
                                     self.active_slots)
        self.peak_cache_tokens = max(self.peak_cache_tokens,
                                     self.cache_valid_tokens)

    @property
    def page_stats(self) -> dict:
        """Pool counters ({} on a dense engine)."""
        if not self.paged:
            return {}
        assert self.pool is not None
        p = self.pool
        return {"page_size": self.page_size, "total_pages": p.total,
                "used_pages": p.used_pages, "peak_used": p.peak_used,
                "committed": p.committed, "shared_hits": p.shared_hits,
                "cow_copies": p.cow_copies, "stalls": p.stalls,
                "conflicts": p.conflicts,
                "published": p.published_pages}

    def _prefill_schedule(self, n: int, start: int = 0) -> collections.deque:
        """Chunk sizes for an ``n``-token prompt: full chunks plus a
        power-of-two tail bucket (padded up), split further if the padding
        would write past ``max_len``.  ``start`` skips tokens already
        resident (shared prefix pages): the schedule covers [start, n)."""
        out: collections.deque = collections.deque()
        done = start
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

    @on_engine_stream
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
        start, row = 0, None
        if self.paged:
            admitted = self._paged_admit(req, slot, n)
            if admitted is None:
                return False     # the pool cannot commit (a conflict)
            start, row = admitted
        self.slot_req[slot] = req
        self.slot_pos[slot] = n
        if self.chunked_prefill:
            self._prefill[slot] = _PrefillState(
                req=req, row_cache=row if row is not None
                else self._fresh_row(),
                schedule=self._prefill_schedule(n, start), done=start)
            self._note_occupancy()
            if drain:
                while not req.output:
                    self.prefill_step()
            return True
        self._copy_row(self._row, self._empty_row)
        self._inputs.push(prompt.astype(np.int64))
        logits, _ = self._prefill_one(self.params, self._inputs.prompt(n),
                                      self._row)
        first = torch.argmax(logits[0])   # before another graph replays
        self._finish_row(slot, self._row, req)
        # veltair: ignore[torch-host-sync] the one device->host sync of a monolithic admission (host_syncs counts it): the first token goes to the request
        first = int(first)
        self.host_syncs += 1
        self.tokens_decoded += 1
        self.prefill_tokens += n
        self._note_occupancy()
        req.output.append(first)
        return True

    @property
    def prefill_pending(self) -> int:
        """Slots whose prompts are not fully prefilled yet."""
        return len(self._prefill)

    @property
    def has_decodable(self) -> bool:
        """Any occupied slot past prefill (eligible for decode quanta)."""
        return any(r is not None and i not in self._prefill
                   for i, r in enumerate(self.slot_req))

    decode_ready = has_decodable

    def prefill_backlog(self) -> list[tuple[int, int, int]]:
        """Slots mid-prefill, FIFO order: (slot, rid, chunks_left), the SLO
        scheduler's view of the prefill backlog."""
        return [(slot, st.req.rid, len(st.schedule))
                for slot, st in self._prefill.items()]

    prefill_queue = prefill_backlog

    def decodable_rows(self) -> list[tuple[int, int, int]]:
        """Decodable slots: (slot, rid, tokens_left), ``tokens_left`` the
        remaining decode budget the SLO scheduler sizes quanta from."""
        out = []
        for i, req in enumerate(self.slot_req):
            if req is None or i in self._prefill:
                continue
            need = req.max_new_tokens + 1 - len(req.output)
            room = self.max_len - 1 - int(self.slot_pos[i])
            out.append((i, req.rid, max(1, min(need, room))))
        return out

    decode_backlog = decodable_rows

    def prefill_turn(self, last_was_prefill: bool) -> bool:
        """Strict prefill/decode alternation (the FIFO scheduler): spend
        this quantum on a prefill chunk when a prompt is mid-prefill and
        either nothing is decodable yet or the previous quantum was a
        decode."""
        return bool(self._prefill) and (not self.has_decodable
                                        or not last_was_prefill)

    should_prefill = prefill_turn

    @on_engine_stream
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
        inp = self._inputs
        self._copy_row(self._row, st.row_cache)
        inp.push(toks, t0=st.done, valid=valid)
        logits, _ = self._prefill_chunk(self.params, inp.prompt(c),
                                        self._row, inp.t0, inp.valid)
        st.done += valid
        self.prefill_chunks += 1
        self.prefill_tokens += valid
        self.prefill_pad_tokens += c - valid
        finished = not st.schedule
        if not finished:
            self._copy_row(st.row_cache, self._row)
        else:
            first = torch.argmax(logits[0])   # before another graph replays
            self._finish_row(slot, self._row, st.req)
            # veltair: ignore[torch-host-sync] the one device->host sync of an admission, at its finishing chunk (host_syncs counts it): the first token goes to the request
            first = int(first)
            if traces0 == self.version_cache.traces:
                self.counter_bank.observe(
                    "prefill", _next_pow2(max(st.done, 1)),
                    self._entry.key, time.perf_counter() - t0,
                    tokens=valid, co_runners=self.co_runner_load)
            self.host_syncs += 1
            self.tokens_decoded += 1
            st.req.output.append(first)
            del self._prefill[slot]
        self._note_occupancy()
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
    @on_engine_stream
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
        if fused and self._spec_enabled:
            handle = self._dispatch_verify(int(k), active, n_left.copy(),
                                           toks)
            if handle is not None:
                return handle
            # no usable draft, no room for the d+1 write span: the plain
            # fused quantum below is the fallback
        if self.paged:
            cap = 1 if not fused else min(int(k), self.quantum_buckets[-1])
            n_left = self._paged_preflight(active, np.minimum(n_left, cap))
            if not any(n_left[i] > 0 for i in active):
                return None      # every decodable row waits on a free page
        if not fused:
            # free slots decode garbage at position 0; the next
            # admission writes a whole prefilled row over them
            traces0 = self.version_cache.traces
            t0 = time.perf_counter()
            inp = self._inputs
            inp.push(toks, pos=self.slot_pos)
            logits, self.cache = self._decode(
                self.params, {"tokens": inp.tokens}, self.cache, inp.pos)
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
        inp = self._inputs
        inp.push(toks, pos=self.slot_pos, n_left=n_left)
        block, self.cache, _ = qfn(self.params, inp.tokens, self.cache,
                                   inp.pos, inp.n_left)
        self.quantum_calls += 1
        return QuantumHandle(block=block.clone(), n_left=n_left, steps=steps,
                             active=active, t0=t0, traces0=traces0,
                             bucket=bucket, tiles=self._entry.key)

    def _dispatch_verify(self, k: int, active: list[int], n_left: np.ndarray,
                         toks: np.ndarray) -> QuantumHandle | None:
        """Dispatch one speculative verify quantum, or return None to fall
        back to the plain fused quantum: no row drafted, a row too close
        to ``max_len`` for the d+1 write span, or (paged) too few free
        pages for the worst-case d+1 writes per row, or a preflight that
        leaves no row a token.  Every fallback is counted."""
        d = self.spec_depth
        # the verify writes positions [pos, pos + d] of every active row,
        # whatever it accepts, so every row needs d steps of room
        if any(self.max_len - 1 - int(self.slot_pos[i]) < d
               for i in active):
            self.spec_fallbacks += 1
            return None
        if self.paged and self.decode_k_headroom(d + 1) < d + 1:
            self.spec_fallbacks += 1
            return None
        drafts = np.zeros((self.slots, d), np.int64)
        n_drafted = 0
        for i in active:
            req = self.slot_req[i]
            dr = self.drafter.propose(
                np.concatenate([np.asarray(req.prompt, np.int32),
                                np.asarray(req.output, np.int32)]), d)
            if dr is not None:
                drafts[i] = dr
                n_drafted += 1
        if n_drafted == 0:
            # nothing to verify: one token per row for d+1 positions of
            # work, so the plain quantum is strictly better
            self.spec_fallbacks += 1
            return None
        cap = min(max(int(k), 1), d + 1, self.quantum_buckets[-1])
        n_left = np.minimum(n_left, cap)
        if self.paged:
            span = np.zeros(self.slots, np.int64)
            span[active] = d + 1
            span = self._paged_preflight(active, span)
            # writes past a row's mapped span land on the trash page:
            # tokens whose KV lives there are never emitted
            n_left = np.minimum(n_left, span)
            if not any(n_left[i] > 0 for i in active):
                self.spec_fallbacks += 1
                return None
        bucket = next(b for b in self.quantum_buckets if b >= cap)
        sfn = self.version_cache.spec_quantum(self._entry, bucket, d,
                                              self.slots)
        traces0 = self.version_cache.traces
        t0 = time.perf_counter()
        inp = self._inputs
        inp.push(toks, pos=self.slot_pos, n_left=n_left, drafts=drafts)
        block, n_emit, accepted, self.cache, _ = sfn(
            self.params, inp.tokens, inp.drafts, self.cache, inp.pos,
            inp.n_left)
        # the graph's outputs are rewritten by later replays: one packed
        # copy, on the stream right after the replay, and one sync for it
        packed = torch.cat([block, n_emit[None], accepted[None]])
        self.quantum_calls += 1
        self.spec_quanta += 1
        self.tokens_drafted += d * len(active)
        # steps=1: a verify is ONE forward, so virtual clocks charge it
        # like a single decode step while it emits up to min(k, d+1)
        # tokens a row
        return QuantumHandle(block=packed, n_left=n_left, steps=1,
                             active=active, t0=t0, traces0=traces0,
                             bucket=bucket, tiles=self._entry.key,
                             kind="spec", emitted=packed[-2],
                             accepted=packed[-1], drafted=d)

    # the reference's name, bound without a second ``def`` (see ``step``)
    _try_spec_quantum = _dispatch_verify

    @on_engine_stream
    def finish_quantum(self, handle: QuantumHandle | None) -> list[Request]:
        """Block on a dispatched quantum — the single device->host sync —
        and do the bookkeeping: append each row's tokens, advance
        positions, free finished slots.  Returns finished requests."""
        if handle is None:
            return []
        # the one device->host sync of a quantum (a verify's block, its
        # rows' emission and acceptance come packed in one tensor)
        # veltair: ignore[torch-host-sync] the one sanctioned sync a quantum, counted in host_syncs
        block = handle.block.cpu().numpy()
        self.host_syncs += 1
        if handle.kind == "spec":
            block, emitted, accepted = block[:-2], block[-2], block[-1]
            # the rows' real emission, for every consumer below and in
            # the runtimes
            handle.n_left = emitted
            for i in handle.active:
                self.tokens_accepted += max(int(emitted[i]) - 1, 0)
                if int(accepted[i]) < handle.drafted:
                    self.spec_rollbacks += 1
            if handle.active:
                mean = float(emitted[handle.active].sum()) \
                    / len(handle.active)
                self._spec_accept_ewma = (0.8 * self._spec_accept_ewma
                                          + 0.2 * mean)
        # speculative quanta observe under their own kind: their wall per
        # token varies with acceptance, and pooling them with "decode"
        # would read as interference
        if handle.t0 > 0.0 and \
                handle.traces0 == self.version_cache.traces:
            self.counter_bank.observe(
                handle.kind, handle.bucket, handle.tiles,
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
        self._note_occupancy()               # peak before finished rows free
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
