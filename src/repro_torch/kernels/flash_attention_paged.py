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
There is no tile knob: the page size does not change the kernel's block
(64-key tiles gathered through the table), and a level switch changes
nothing here.

On a CUDA tensor the wrapper launches ``csrc/flash_attention_paged.cu``
(the dense kernel's block over gathered pages, split-KV across a cluster
as :func:`launch_geometry` decides from the shapes alone); on a CPU
tensor it runs :func:`paged_attention_plain`, which gathers the
pools through the table into dense rows and calls the dense kernel's
plain version, so on the CPU a paged cache attends exactly as a dense
one holding the same keys.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import HEAD_DIMS, MAX_ROWS, \
    MAX_SMEM_BYTES, _per_row, attention_plain

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


def smem_bytes(rows: int, d: int, n_slot: int) -> int:
    """Dynamic shared memory of one block of ``rows`` flattened (query,
    head-of-group) rows (at most MAX_ROWS a block) over a table of
    ``n_slot`` entries a row: the dense kernel's block at a 64-key tile,
    then the staged table entries (int32, padded to 16 bytes).  The
    wrapper refuses a call beyond the card's limit with it;
    :func:`kernel_smem_bytes` is the kernel's own count, which the card
    checks hold equal to this one."""
    return fa.smem_bytes(min(rows, MAX_ROWS), KV_TILE, d) + \
        -(-4 * n_slot // 16) * 16


def kernel_smem_bytes(rows: int, d: int, n_slot: int) -> int:
    """Dynamic shared memory the built kernel gives such a block (on a
    machine with ``nvcc``), or -1 for a block it is not built for."""
    return _lib().flash_attention_paged_smem_bytes(min(rows, MAX_ROWS), d,
                                                   n_slot)


def launch_geometry(b: int, s: int, h: int, kh: int, page_size: int,
                    n_slot: int) -> tuple[int, int]:
    """The split and the number of blocks of the one launch a (B, S, H, D)
    query over pools of ``page_size`` and a (B, n_slot) table gets.
    Decided from shapes alone, as ``fa.split_kv`` does for the dense
    kernel: the keys a row can see depend on offsets that live on the
    device, and reading them would add a host sync."""
    rows = s * (h // kh)
    bq = min(rows, MAX_ROWS)
    q_tiles = -(-rows // bq) if bq else 0
    split = fa.split_kv(b, kh, q_tiles, n_slot * page_size, KV_TILE)
    return split, b * kh * q_tiles * split


def launch_count() -> int:
    return sum(LAUNCHES.values())


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("flash_attention_paged")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_paged_bf16.argtypes = [
            p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, i, p]
        lib.flash_attention_paged_bf16.restype = ctypes.c_int
        lib.flash_attention_paged_smem_bytes.argtypes = [i, i, i]
        lib.flash_attention_paged_smem_bytes.restype = ctypes.c_int
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
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_paged: head_dim {d} is not one "
                         f"the kernel is built for {HEAD_DIMS}")
    if any(x.data_ptr() % 16 for x in (q, k_pool, v_pool)):
        raise ValueError("flash_attention_paged: kernel takes 16-byte "
                         "aligned tensors")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_paged: window {window} must be "
                         ">= 1")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention_paged: softcap {softcap} must be "
                         "> 0")
    rows = s * (h // kh)
    smem = smem_bytes(rows, d, n_slot)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention_paged: {min(rows, MAX_ROWS)} "
                         f"query rows at head_dim {d} over {n_slot} table "
                         f"entries a row need {smem} bytes of shared memory "
                         f"(at most {MAX_SMEM_BYTES})")
    if n_slot == 0:         # no key at all: every row writes 0
        return torch.zeros_like(q)
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    split, _ = launch_geometry(b, s, h, kh, ps, n_slot)
    off = _per_row(offset, b, q.device).contiguous()
    kvl = _per_row(kv_valid_len, b, q.device).contiguous()
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_paged_bf16(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            out.data_ptr(), page_table.data_ptr(), off.data_ptr(),
            kvl.data_ptr(), b, s, h, kh, d, ps, n_slot, min(rows, MAX_ROWS),
            int(window or 0), float(softcap or 0.0), float(d ** -0.5), split,
            stream)
    cuda_build.check(lib, err, "flash_attention_paged_bf16")
    LAUNCHES[ps] += 1
    return out
