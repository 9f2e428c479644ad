"""block_matmul: ``x (M,K) @ w (K,N)`` with an fp32 accumulator, output in
``x.dtype`` — the multi-version compilation target of the port.

Port of ``repro.kernels.block_matmul`` (the TPU kernel ``_matmul_kernel``
/ ``block_matmul_2d``).  The (bm, bk, bn) tile is the locality knob the
adaptive compiler picks per interference level.  On a CUDA tensor the
wrapper launches the hand-written kernel in ``csrc/block_matmul.cu`` with
the selected tile and the split-K cluster size :func:`split_k` picks for
the shape (one launch either way); on a CPU tensor it runs
:func:`matmul_plain`, the kernel's plain PyTorch version.

The TPU wrapper clamps the tile to the zero-padded problem (``bm <=
ceil8(M)``, ``bk <= ceil128(K)``, ``bn <= ceil128(N)``); the CUDA kernel
masks instead of padding, and the tile never exceeds the problem rounded
up to a power of two no smaller than the kernel's least tile
(:func:`effective_tiles`).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import cuda_build

# Tiles the CUDA kernel is instantiated for.
BM_CHOICES = (16, 32, 64, 128)
BN_CHOICES = (32, 64, 128)
BK_CHOICES = (32, 64)

# Streaming multiprocessors of an H100 SXM, and the largest thread-block
# cluster the kernel splits K across (the portable cluster size).
SMS = 132
MAX_SPLIT = 8
# K tiles each block of a split keeps at least (the ring's depth)
MIN_K_TILES = 4

# Launches of the CUDA kernel, keyed by the (bm, bk, bn) tile and the
# split it ran.
LAUNCHES: collections.Counter = collections.Counter()


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: fp32 product, cast to ``x.dtype``."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _pow2_at_least(n: int, floor: int) -> int:
    return max(floor, 1 << (max(int(n), 1) - 1).bit_length())


def effective_tiles(m: int, k: int, n: int, bm: int, bk: int,
                    bn: int) -> tuple[int, int, int]:
    """The (bm, bk, bn) the kernel runs for an (m, k) @ (k, n) product."""
    return (min(bm, _pow2_at_least(m, BM_CHOICES[0])),
            min(bk, _pow2_at_least(k, BK_CHOICES[0])),
            min(bn, _pow2_at_least(n, BN_CHOICES[0])))


def smem_bytes(bm: int, bk: int, bn: int) -> int:
    """Dynamic shared memory of one block of the (bm, bk, bn) tile, as the
    built kernel sizes it: its cp.async ring of bf16 x and w tiles, or the
    fp32 partial tile a split sums, whichever is larger.  The layout is
    decided in ``csrc/block_matmul.cu`` alone, so this asks the library
    (on a machine with ``nvcc``); -1 for a tile it is not built for.
    Replaces ``vmem_bytes``."""
    return _lib().block_matmul_smem_bytes(bm, bn, bk)


def split_k(m: int, k: int, n: int, bm: int, bk: int, bn: int) -> int:
    """Blocks of the cluster that share one (bm, bn) output tile, each on
    a contiguous run of K tiles: doubled from 1 while the output tiles
    times the split leave SMs idle, up to MAX_SPLIT, as long as every
    block keeps MIN_K_TILES K tiles.  Takes the effective tile, reads no
    tile table."""
    tiles = -(-m // bm) * -(-n // bn)
    k_tiles = -(-k // bk)
    split = 1
    while split < MAX_SPLIT and tiles * split < SMS and \
            k_tiles >= MIN_K_TILES * 2 * split:
        split *= 2
    return split


def split_ranges(n: int, parts: int) -> list[tuple[int, int]]:
    """The kernels' partition of ``n`` tiles among ``parts`` blocks
    (``sm90::split_range`` in ``csrc/sm90_tiles.cuh``): min(parts, n)
    contiguous, non-empty runs in rank order; further ranks get none."""
    used = min(parts, n)
    return [(r * n // used, (r + 1) * n // used) for r in range(used)]


def launch_geometry(m: int, k: int, n: int, bm: int, bk: int, bn: int
                    ) -> tuple[tuple[int, int, int], int, int]:
    """The effective (bm, bk, bn) tile, the split and the number of blocks
    of the one launch an (m, k) @ (k, n) product gets."""
    tbm, tbk, tbn = effective_tiles(m, k, n, bm, bk, bn)
    split = split_k(m, k, n, tbm, tbk, tbn)
    return (tbm, tbk, tbn), split, -(-m // tbm) * -(-n // tbn) * split


def launch_count() -> int:
    return sum(LAUNCHES.values())


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("block_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.block_matmul_bf16.argtypes = [p, p, p, i, i, i, i, i, i, i, i,
                                          i, p]
        lib.block_matmul_bf16.restype = ctypes.c_int
        lib.block_matmul_smem_bytes.argtypes = [i, i, i]
        lib.block_matmul_smem_bytes.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def block_matmul_2d(x: torch.Tensor, w: torch.Tensor, *, bm: int = 128,
                    bk: int = 64, bn: int = 128) -> torch.Tensor:
    """x (M,K) @ w (K,N) -> (M,N) in ``x.dtype``."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"block_matmul_2d: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return matmul_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"block_matmul_2d: tensors on {x.device} and "
                         f"{w.device}; the kernel takes one CUDA device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"block_matmul_2d: kernel takes bf16, got "
                        f"{x.dtype} @ {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("block_matmul_2d: kernel takes contiguous tensors")
    m, k = x.shape
    n = w.shape[1]
    (tbm, tbk, tbn), split, _ = launch_geometry(m, k, n, bm, bk, bn)
    if tbm not in BM_CHOICES or tbk not in BK_CHOICES or \
            tbn not in BN_CHOICES:
        raise ValueError(f"block_matmul_2d: tile (bm={tbm}, bk={tbk}, "
                         f"bn={tbn}) is not one the kernel is built for "
                         f"(bm {BM_CHOICES}, bk {BK_CHOICES}, bn "
                         f"{BN_CHOICES})")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    vec_x = int(k % 8 == 0 and x.data_ptr() % 16 == 0)
    vec_w = int(n % 8 == 0 and w.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.block_matmul_bf16(x.data_ptr(), w.data_ptr(),
                                    out.data_ptr(), m, n, k, tbm, tbn, tbk,
                                    vec_x, vec_w, split, stream)
    cuda_build.check(lib, err, "block_matmul_bf16")
    LAUNCHES[(tbm, tbk, tbn, split)] += 1
    return out
