"""Collective-communication statistics of a traced step
(``repro.launch.hlo_stats``).

The reference parses XLA's optimized HLO for the collectives the SPMD
partitioner chose.  The port has no HLO: it counts the collectives that
DTensor issues while a step runs over sharded DTensors — what PyTorch's
sharding propagation and ``redistribute`` ask for, not what a compiler
chose — as :class:`CollectiveRecorder` sees them: the
``_c10d_functional`` ops (and DTensor's own all-to-all) on the local
shards.  Each event is (op, result bytes, group size), with the ops
under the reference's five names, and per-device link bytes come from
the reference's ring-collective factors:

    all-gather          (n-1)/n * result_bytes
    all-reduce        2*(n-1)/n * result_bytes
    reduce-scatter      (n-1)   * result_bytes     (operand = n * result)
    all-to-all          (n-1)/n * result_bytes
    collective-permute           result_bytes
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute")

# (namespace, op) of the collectives DTensor issues on local shards ->
# the reference's name; ``send`` is the point-to-point one
_TORCH_OPS = {
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("c10d", "send"): "collective-permute",
}


def ring_link_bytes(op: str, result_bytes: int, n: int) -> float:
    """Per-device bytes on the links of one collective on a ring of n."""
    if op == "collective-permute":
        return float(result_bytes)    # point-to-point, no group concept
    if n <= 1:
        return 0.0
    if op == "all-gather":
        return (n - 1) / n * result_bytes
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if op == "reduce-scatter":
        return (n - 1) * result_bytes
    if op == "all-to-all":
        return (n - 1) / n * result_bytes
    return float(result_bytes)


@dataclasses.dataclass
class TorchCollectiveStats:
    counts: dict
    payload_bytes: dict
    link_bytes: float                   # per-device, summed over ops

    def payload_total(self) -> float:
        return sum(self.payload_bytes.values())

    # the reference's name, bound without a second ``def`` (see below)
    total_payload = payload_total


CollectiveStats = TorchCollectiveStats


def collective_stats(events, default_group: int = 1) -> CollectiveStats:
    """Counts, payload bytes and per-device link bytes of ``events``:
    (op, result bytes, group size or None for ``default_group``) with op
    one of the five names; any other op (a compute op) is not counted."""
    counts = {op: 0 for op in _OPS}
    payload = {op: 0.0 for op in _OPS}
    link = 0.0
    for op, rb, n in events:
        if op not in counts:
            continue
        counts[op] += 1
        payload[op] += rb
        link += ring_link_bytes(op, rb, n if n is not None else default_group)
    return CollectiveStats(counts=counts, payload_bytes=payload,
                           link_bytes=link)


def count_events(events, opcode: str) -> int:
    """Events of op ``opcode``."""
    return sum(1 for op, _, _ in events if op == opcode)


def _tensor_bytes(out) -> int:
    leaves = out if isinstance(out, (list, tuple)) else [out]
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _event(op: str, args, out) -> tuple[str, int, int]:
    """(op, bytes, group size) of one collective: a point-to-point send
    moves its tensors (no group); the others their result, in the group
    their last argument names."""
    if op == "collective-permute":
        return op, _tensor_bytes(args[0]), 1
    from torch.distributed.distributed_c10d import _resolve_process_group
    return op, _tensor_bytes(out), _resolve_process_group(args[-1]).size()


class CollectiveRecorder(TorchDispatchMode):
    """Records (op, result bytes, group size) of every collective issued
    on plain (local) tensors while active, in ``events``.  An op on a
    DTensor is left to DTensor first (``NotImplemented``), so the
    collectives its sharding propagation issues come back through here."""

    def __init__(self):
        super().__init__()
        self.events: list[tuple[str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if isinstance(func, torch._ops.OpOverload):
            op = _TORCH_OPS.get((func.namespace, func._opname))
            if op is not None:
                self.events.append(_event(op, args, out))
        return out

    def collective_summary(self) -> CollectiveStats:
        return collective_stats(self.events)


# the reference's names, bound without a second ``def``: the repository's
# static analyzer resolves the reference's calls of them by the function
# name being unique in the corpus
_link_bytes = ring_link_bytes
parse_collectives = collective_stats
count_op = count_events
