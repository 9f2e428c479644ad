"""Peaks of the card and the least work of each kernel and of the model.

The least time of a kernel launch is the larger of its operations at the
bf16 tensor-core peak and its bytes at the memory bandwidth, each input
byte read once and each output byte written once, whatever the kernel
reads again; where the work depends on the positions (causal attention),
the positions the launch was given are counted.  Peaks: NVIDIA's data
sheet for the H100 SXM, dense rates without sparsity, at 700 W.
"""
from __future__ import annotations

BF16_FLOPS = 989e12          # dense bf16, tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16 = 2                     # bytes
FP32 = 4


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def matmul(m: int, k: int, n: int) -> tuple[float, float]:
    """B1: (m, k) @ (k, n), bf16 in and out -> (flops, bytes)."""
    return 2.0 * m * k * n, float(BF16 * (m * k + k * n + m * n))


def attention(seqs: list[list[int]], heads: int, kv_heads: int,
              head_dim: int) -> tuple[float, float]:
    """B2 over the sequences of one launch (a decode step's rows, or a
    prefill chunk of one row): ``seqs`` holds, per sequence, the number
    of keys each of its query rows attends (causal, within the cache).
    Q and the output are read and written once per query row, K and V
    once per sequence, up to its longest row."""
    flops = nbytes = 0.0
    for lens in seqs:
        flops += 4.0 * heads * head_dim * sum(lens)
        nbytes += BF16 * (2 * len(lens) * heads * head_dim
                          + 2 * max(lens) * kv_heads * head_dim)
    return flops, nbytes


def ssd_scan(length: int, heads: int, p: int, n: int, chunk: int,
             groups: int, with_init: bool) -> tuple[float, float]:
    """B4 for one row of ``length`` tokens (the repository's chip smoke
    test, ``ssd_bound``): x and y bf16, dt fp32, a fp32, B and C bf16 per
    group, the initial and final state fp32; the causal products inside
    each chunk and the state's update and readout."""
    nbytes = length * (heads * (2 * p * BF16 + FP32) + groups * 2 * n * BF16)
    nbytes += heads * FP32 + heads * p * n * FP32 * (1 + int(with_init))
    flops = 0
    for c0 in range(0, length, chunk):
        r = min(chunk, length - c0)
        flops += r * (r + 1) // 2 * (2 * n + 2 * p) + 4 * r * p * n
    return float(flops * heads), float(nbytes)
