"""Kernel dispatch: the tile tables that shape the hand-written kernels.

The port of ``repro.kernels.dispatch`` without its execution modes: a
kernel wrapper routes by the device of its tensors (a CPU tensor goes to
the plain PyTorch version, a CUDA tensor to the CUDA kernel), so there is
no process-global switch that could put a plain version on the card.

Tile overrides come from two sources, consulted in order:

  1. an active *override context* (``tile_context``) — a complete table
     pushed by whoever runs a model call (each serving version-cache
     entry runs its calls under its own tiles, so several engines can
     hold different code versions in one process);
  2. the process-global table (``install_tile_overrides``) — the last
     level installed anywhere, kept for observability and for code that
     runs outside a context.

A context is *atomic*: while one is active, ops it does not name have NO
override (the global table is not consulted).  PyTorch runs eagerly, so
the tiles are read when a kernel is called.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
from typing import Callable, Iterator

# Process-global tile overrides: op name -> dict of tiling kwargs.
_TILE_OVERRIDES: dict[str, dict] = {}

# Stack of complete override tables pushed by tile_context (innermost last).
_CONTEXT_STACK: list[dict[str, dict]] = []

# Process-global autotuned level ladder (grid idx -> {op: tiling kwargs}).
_LADDER: list | None = None


def install_tile_overrides(tiles: dict[str, dict]) -> None:
    """Atomically replace the whole global table with ``tiles`` (ops
    absent from ``tiles`` are cleared)."""
    _TILE_OVERRIDES.clear()
    for op, kw in tiles.items():
        _TILE_OVERRIDES[op] = dict(kw)


def clear_tile_overrides() -> None:
    _TILE_OVERRIDES.clear()


@contextlib.contextmanager
def tile_context(tiles: dict[str, dict]) -> Iterator[None]:
    """Scope a complete override table: inside the ``with``, every op
    reads from ``tiles`` only (ops it does not name get no override)."""
    _CONTEXT_STACK.append({op: dict(kw) for op, kw in tiles.items()})
    try:
        yield
    finally:
        _CONTEXT_STACK.pop()


def tile_overrides(op: str) -> dict:
    if _CONTEXT_STACK:
        return dict(_CONTEXT_STACK[-1].get(op, {}))
    return dict(_TILE_OVERRIDES.get(op, {}))


def all_tile_overrides() -> dict[str, dict]:
    """Snapshot of every installed override (observability)."""
    src = _CONTEXT_STACK[-1] if _CONTEXT_STACK else _TILE_OVERRIDES
    return {op: dict(kw) for op, kw in src.items()}


def install_ladder(levels: list | None) -> None:
    """Install (or clear, with None) the process-global level ladder:
    a per-grid-level list of op -> tiling-kwargs tables (the ``levels``
    payload of a ``LadderSpec``).  Engines built afterwards snapshot it."""
    global _LADDER
    if levels is None:
        _LADDER = None
        return
    _LADDER = [{op: dict(kw) for op, kw in lvl.items()} for lvl in levels]


def active_ladder() -> list | None:
    """Deep copy of the installed ladder levels (None when none is)."""
    if _LADDER is None:
        return None
    return [{op: dict(kw) for op, kw in lvl.items()} for lvl in _LADDER]


def load_ladder(path) -> list:
    """Load a serialized LadderSpec JSON and install its levels as the
    process-global ladder."""
    data = json.loads(pathlib.Path(path).read_text())
    levels = data.get("levels")
    if not isinstance(levels, list) or not levels or \
            not all(isinstance(lvl, dict) for lvl in levels):
        raise ValueError(f"{path}: not a serialized LadderSpec "
                         "(missing/malformed 'levels')")
    install_ladder(levels)
    return active_ladder()


def launch_counters() -> tuple:
    """Every kernel wrapper's launch counter (``LAUNCHES``).  A wrapper
    counts the launches it makes in Python, so a CUDA graph's replay adds
    the launches its capture recorded here (``serving.version_cache``)."""
    from repro_torch.kernels import block_matmul, flash_attention, \
        flash_attention_paged, ssd_scan
    return (block_matmul.LAUNCHES, flash_attention.LAUNCHES,
            flash_attention_paged.LAUNCHES, ssd_scan.LAUNCHES)


def get_matmul() -> Callable:
    """``x (..., K) @ w (K, N)`` through ``block_matmul`` under the
    current ``"matmul"`` tiles."""
    from repro_torch.kernels import ops

    def mm(x, w):
        return ops.block_matmul(x, w, **tile_overrides("matmul"))
    return mm


def get_attention() -> Callable:
    """Masked GQA attention through ``flash_attention`` under the current
    ``"attention"`` tiles."""
    from repro_torch.kernels import ops

    def attn(q, k, v, *, q_positions, kv_valid_len, window, softcap):
        return ops.flash_attention(
            q, k, v, q_positions=q_positions, kv_valid_len=kv_valid_len,
            window=window, softcap=softcap, **tile_overrides("attention"))
    return attn


def get_paged_attention() -> Callable:
    """Decode attention read through the page table, through
    ``flash_attention_paged``.  No tile table is read: the page size
    fixes the KV block, so a level switch changes no paged-attention
    kernel."""
    from repro_torch.kernels import ops

    def attn(q, k_pool, v_pool, *, page_table, q_positions, kv_valid_len,
             window, softcap):
        return ops.flash_attention_paged(
            q, k_pool, v_pool, page_table=page_table,
            q_positions=q_positions, kv_valid_len=kv_valid_len,
            window=window, softcap=softcap)
    return attn


def get_ssd() -> Callable:
    """The Mamba-2 chunked scan through ``ssd_scan`` at the model's chunk.
    No tile table is read: the level tiles name no ``"ssd"`` entry, so a
    level switch changes no kernel on this path."""
    from repro_torch.kernels import ops

    def ssd(x, dt, a, b, c, *, chunk_size, initial_state=None):
        return ops.ssd_scan(x, dt, a, b, c, chunk_size=chunk_size,
                            initial_state=initial_state)
    return ssd
