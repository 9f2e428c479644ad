"""Mamba-2 SSD chunked scan — the port's third kernel.

Port of ``repro.kernels.ssd_scan`` (the TPU kernel ``_ssd_kernel`` /
``ssd_scan``).  Per batch row b and head h the sequence is cut into
chunks of ``q = min(chunk_size, L)`` tokens.  Inside a chunk, with
``seg`` the inclusive cumsum of ``dt * a``:

    y_i = sum_{j<=i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j
          + exp(seg_i) C_i . h_in                      (h_in (P, N))
    h_out = exp(seg_last) h_in + sum_j exp(seg_last - seg_j) dt_j x_j B_j^T

and ``h_out`` carries into the next chunk.  The TPU wrapper pads L to a
chunk multiple with ``dt = 0`` (an exact no-op); the plain version and
the CUDA kernel cut the last chunk short instead, which gives the same
real rows of y and the same final state.

On a CUDA tensor the wrapper launches ``csrc/ssd_scan.cu``; on a CPU
tensor it runs :func:`ssd_scan_plain`, the kernel's plain PyTorch version
(fp32 arithmetic, one chunk after another).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import cuda_build

# Dynamic shared memory one block may use on an H100 (232,448 bytes).
MAX_SMEM_BYTES = 227 * 1024
# The kernel's register tiles: query rows and key rows per sub-tile of the
# intra-chunk product, and the widest head_dim (P) one block holds.
SUB_TILE = 64
MAX_HEAD_DIM = 64

# Launches of the CUDA kernel, keyed by the chunk length q it ran.
LAUNCHES: collections.Counter = collections.Counter()


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, *,
                   chunk_size: int = 256,
                   initial_state: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: x (B,L,H,P); dt (B,L,H); a (H,);
    b/c (B,L,H,N) -> (y (B,L,H,P) in ``x.dtype``, state (B,H,P,N) fp32)."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if initial_state is None
             else initial_state.float())
    y = torch.empty_like(x)
    q = min(chunk_size, l)
    af = a.float()
    for c0 in range(0, l, max(q, 1)):
        rows = min(q, l - c0)
        xs = x[:, c0:c0 + rows].float()                   # (B,R,H,P)
        dts = dt[:, c0:c0 + rows].float()                 # (B,R,H)
        bs = b[:, c0:c0 + rows].float()                   # (B,R,H,N)
        cs = c[:, c0:c0 + rows].float()
        seg = torch.cumsum(dts * af, dim=1)               # inclusive
        total = seg[:, -1]                                # (B,H)
        causal = torch.ones(rows, rows, dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        # exp only where j <= i: above the diagonal it may overflow
        diff = seg[:, :, None, :] - seg[:, None, :, :]    # (B,Ri,Rj,H)
        gate = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)),
                           0.0)
        cb = torch.einsum("bihn,bjhn->bijh", cs, bs)
        m_att = cb * gate * dts[:, None, :, :]
        yc = torch.einsum("bijh,bjhp->bihp", m_att, xs)
        yc = yc + torch.exp(seg)[..., None] * torch.einsum(
            "bihn,bhpn->bihp", cs, state)
        w = torch.exp(total[:, None, :] - seg) * dts       # (B,R,H)
        state = torch.exp(total)[:, :, None, None] * state + torch.einsum(
            "bjhp,bjhn->bhpn", xs, bs * w[..., None])
        y[:, c0:c0 + rows] = yc.to(x.dtype)
    return y, state


def smem_bytes(q: int, p: int, n: int) -> int:
    """Dynamic shared memory of one block at chunk ``q``: the chunk's B
    and C (bf16, rows padded to an even stride of at least n + 1), x
    (bf16), the (P, N + 1) fp32 state, seg, dt and w (fp32), and one
    fp32 (SUB_TILE, SUB_TILE + 1) score tile."""
    sbc = (n | 1) + 1
    return 2 * (2 * q * sbc + q * p) + 4 * (p * (n + 1) + 3 * q) + \
        4 * SUB_TILE * (SUB_TILE + 1)


def launch_count() -> int:
    return sum(LAUNCHES.values())


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("ssd_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_bf16.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                      i, i, p]
        lib.ssd_scan_bf16.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk_size: int = 256,
             initial_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,L,H,P); dt (B,L,H) fp32; a (H,) fp32; b/c (B,L,H,N), already
    expanded from groups to heads; initial_state (B,H,P,N) fp32 or None.
    Returns (y (B,L,H,P) in ``x.dtype``, final state (B,H,P,N) fp32)."""
    if x.ndim != 4 or dt.shape != x.shape[:3] or \
            tuple(a.shape) != (x.shape[2],) or b.ndim != 4 or \
            b.shape != c.shape or b.shape[:3] != x.shape[:3]:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}")
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    if initial_state is not None and \
            tuple(initial_state.shape) != (bsz, h, p, n):
        raise ValueError(f"ssd_scan: initial_state "
                         f"{tuple(initial_state.shape)}, expected "
                         f"{(bsz, h, p, n)}")
    if chunk_size < 1:
        raise ValueError(f"ssd_scan: chunk_size {chunk_size} must be >= 1")
    tensors = [x, dt, a, b, c] + ([] if initial_state is None
                                  else [initial_state])
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return ssd_scan_plain(x, dt, a, b, c, chunk_size=chunk_size,
                              initial_state=initial_state)
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"ssd_scan: tensors on {devices}; the kernel "
                         "takes one CUDA device")
    if x.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or \
            c.dtype != torch.bfloat16 or dt.dtype != torch.float32 or \
            a.dtype != torch.float32 or (
                initial_state is not None and
                initial_state.dtype != torch.float32):
        raise TypeError("ssd_scan: kernel takes bf16 x, b, c and fp32 dt, "
                        "a, initial_state")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan: kernel takes contiguous tensors")
    if p > MAX_HEAD_DIM:
        raise ValueError(f"ssd_scan: head_dim {p} above the kernel's "
                         f"{MAX_HEAD_DIM}")
    q = min(chunk_size, l)
    smem = smem_bytes(max(q, 1), p, n)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan: chunk {q} at head_dim {p}, state_dim "
                         f"{n} needs {smem} bytes of shared memory (at "
                         f"most {MAX_SMEM_BYTES})")
    y = torch.empty_like(x)
    if l == 0 or bsz == 0 or h == 0:
        state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                             device=x.device) if initial_state is None
                 else initial_state.clone())
        return y, state
    state = torch.empty((bsz, h, p, n), dtype=torch.float32,
                        device=x.device)
    h0 = 0 if initial_state is None else initial_state.data_ptr()
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_bf16(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                                b.data_ptr(), c.data_ptr(), h0,
                                y.data_ptr(), state.data_ptr(), bsz, l, h,
                                p, n, q, smem, stream)
    cuda_build.check(lib, err, "ssd_scan_bf16")
    LAUNCHES[q] += 1
    return y, state
