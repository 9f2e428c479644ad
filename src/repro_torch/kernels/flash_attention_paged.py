"""Decode attention read through a page table — the port's fourth kernel.

Port of the paged kernel of ``repro.kernels.flash_attention`` (the TPU
kernel ``_paged_flash_kernel`` / ``flash_attention_paged``).  q is
(B, S, H, D) with small S (1 on the serving path); the K and V caches are
physical page pools (P, page_size, K, D) whose page 0 is the pinned trash
page; ``page_table`` (B, pages_per_slot) int32 maps each row's logical
page to a physical one.  Query i of row b sits at ``offset[b] + i``; key
j of row b lives at ``pool[page_table[b, j // page_size], j % page_size]``
and is visible when ``j <= q_pos``, ``j < min(kv_valid_len[b],
pages_per_slot * page_size)`` and, with a window w, ``j > q_pos - w``.
There is no tile knob: the page size fixes the KV block.

On a CUDA tensor the wrapper launches ``csrc/flash_attention_paged.cu``;
on a CPU tensor it runs :func:`paged_attention_plain`, which gathers the
pools through the table into dense rows and calls the dense kernel's
plain version, so on the CPU a paged cache attends exactly as a dense
one holding the same keys.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.flash_attention import MAX_SMEM_BYTES, _per_row, \
    attention_plain

# Logical keys the kernel gathers into one shared-memory KV tile
# (``kTile`` in the CUDA source).
KV_TILE = 64

# Launches of the CUDA kernel, keyed by the page size it ran.
LAUNCHES: collections.Counter = collections.Counter()


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Pool (P, ps, K, D) read through ``page_table`` (B, n_slot) as
    dense rows (B, n_slot * ps, K, D)."""
    b, n_slot = page_table.shape
    rows = pool[page_table.long()]
    return rows.reshape(b, n_slot * pool.shape[1], *pool.shape[2:])


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_table: torch.Tensor, *,
                          offset, kv_valid_len, window: int | None = None,
                          softcap: float | None = None) -> torch.Tensor:
    """The kernel's plain version: gather, then dense attention."""
    return attention_plain(q, gather_pages(k_pool, page_table),
                           gather_pages(v_pool, page_table), offset=offset,
                           kv_valid_len=kv_valid_len, window=window,
                           softcap=softcap)


def smem_bytes(rows: int, d: int) -> int:
    """Dynamic shared memory of one block holding ``rows`` = S * H/K query
    rows: fp32 q and accumulator, the score tile and m/l/alpha (padded to
    16 bytes), then the bf16 V tile and the row-padded K tile."""
    floats = (2 * rows * d + rows * KV_TILE + 3 * rows + 3) & ~3
    return 4 * floats + 2 * KV_TILE * d + 2 * KV_TILE * (d + 2)


def launch_count() -> int:
    return sum(LAUNCHES.values())


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("flash_attention_paged")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_paged_bf16.argtypes = [
            p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, f, i, p]
        lib.flash_attention_paged_bf16.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def flash_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_table: torch.Tensor, *,
                          offset, kv_valid_len, window: int | None = None,
                          softcap: float | None = None) -> torch.Tensor:
    """q (B,S,H,D); k/v pools (P, page_size, K, D); page_table
    (B, pages_per_slot) int32 of physical page indices below P; offset /
    kv_valid_len are ints or (B,) tensors.  Returns (B,S,H,D) in
    ``q.dtype``."""
    if q.ndim != 4 or k_pool.ndim != 4 or k_pool.shape != v_pool.shape or \
            k_pool.shape[3] != q.shape[3] or q.shape[2] % k_pool.shape[2] or \
            page_table.ndim != 2 or page_table.shape[0] != q.shape[0]:
        raise ValueError(f"flash_attention_paged: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}, "
                         f"page_table {tuple(page_table.shape)}")
    devices = {q.device, k_pool.device, v_pool.device, page_table.device}
    if devices == {torch.device("cpu")}:
        return paged_attention_plain(q, k_pool, v_pool, page_table,
                                     offset=offset, kv_valid_len=kv_valid_len,
                                     window=window, softcap=softcap)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention_paged: tensors on {devices}; the "
                         "kernel takes one CUDA device")
    if {q.dtype, k_pool.dtype, v_pool.dtype} != {torch.bfloat16} or \
            page_table.dtype != torch.int32:
        raise TypeError("flash_attention_paged: kernel takes bf16 q and "
                        "pools and an int32 page table")
    if not all(t.is_contiguous() for t in (q, k_pool, v_pool, page_table)):
        raise ValueError("flash_attention_paged: kernel takes contiguous "
                         "tensors")
    b, s, h, d = q.shape
    ps, kh = k_pool.shape[1], k_pool.shape[2]
    n_slot = page_table.shape[1]
    if d % 8:
        raise ValueError(f"flash_attention_paged: head_dim {d} must be a "
                         "multiple of 8 (16-byte key loads)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_paged: window {window} must be "
                         ">= 1")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention_paged: softcap {softcap} must be "
                         "> 0")
    smem = smem_bytes(s * (h // kh), d)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention_paged: {s} queries x {h // kh} "
                         f"heads per KV head at head_dim {d} need {smem} "
                         f"bytes of shared memory (at most {MAX_SMEM_BYTES})")
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    off = _per_row(offset, b, q.device).contiguous()
    kvl = _per_row(kv_valid_len, b, q.device).contiguous()
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_paged_bf16(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            out.data_ptr(), page_table.data_ptr(), off.data_ptr(),
            kvl.data_ptr(), b, s, h, kh, d, ps, n_slot, int(window or 0),
            float(softcap or 0.0), float(d ** -0.5), smem, stream)
    cuda_build.check(lib, err, "flash_attention_paged_bf16")
    LAUNCHES[ps] += 1
    return out
