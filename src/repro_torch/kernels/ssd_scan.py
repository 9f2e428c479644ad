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

B and C come per group, (B, L, G, N) with G dividing H: head h reads
group ``h // (H / G)``; the per-head form is G = H.

On a CUDA tensor the wrapper launches ``csrc/ssd_scan.cu`` (one block per
16 columns of P, head and row: :func:`launch_geometry`); on a CPU tensor
it runs :func:`ssd_scan_plain`, the kernel's plain PyTorch version (fp32
arithmetic, one chunk after another).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import cuda_build

# Dynamic shared memory one block may use on an H100 (232,448 bytes).
MAX_SMEM_BYTES = 227 * 1024
# Columns of P one block takes (``kPW`` in the CUDA source).
P_BLOCK = 16

# Launches of the CUDA kernel, keyed by the chunk length q it ran.
LAUNCHES: collections.Counter = collections.Counter()


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, *,
                   chunk_size: int = 256,
                   initial_state: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: x (B,L,H,P); dt (B,L,H); a (H,);
    b/c (B,L,G,N), G dividing H -> (y (B,L,H,P) in ``x.dtype``, state
    (B,H,P,N) fp32)."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    if b.shape[2] != h:                       # per group: expand to heads
        b = torch.repeat_interleave(b, h // b.shape[2], dim=2)
        c = torch.repeat_interleave(c, h // c.shape[2], dim=2)
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


def smem_bytes(q: int, n: int) -> int:
    """Dynamic shared memory of one block at chunk ``q`` and state dim
    ``n`` (``Layout`` in the CUDA source; rows padded to 16, N to 32):
    the chunk's B and C and the x slice (bf16, rows padded by 8), the
    (x * w)^T hi / lo operands, the state slice (fp32) and its hi / lo,
    the C.h term of y, and seg, dt, w.  The wrapper refuses a chunk beyond
    the card's limit with it; :func:`kernel_smem_bytes` is the kernel's own
    count, which the card checks hold equal to this one."""
    qp, np_ = -(-q // 16) * 16, -(-n // 32) * 32
    sb, sqw, sh = np_ + 8, qp + 8, np_ + 4
    return 2 * 2 * qp * sb + 2 * qp * 24 + 2 * 2 * P_BLOCK * sqw + \
        2 * 2 * P_BLOCK * sb + 4 * P_BLOCK * sh + 4 * qp * P_BLOCK + \
        3 * 4 * qp


def kernel_smem_bytes(q: int, n: int) -> int:
    """The built kernel's shared memory at (q, n) (on a machine with
    ``nvcc``)."""
    return _lib().ssd_scan_smem_bytes(q, n)


def launch_geometry(b: int, h: int, p: int) -> tuple[int, int]:
    """The P split (blocks per head and row, each on P_BLOCK columns) and
    the block count of one launch."""
    split = -(-p // P_BLOCK)
    return split, b * h * split


# The phases of the kernel's per-phase clock stamps (``csrc/ssd_phases.cuh``,
# in that order).
PHASES = ("state load", "staging", "cumsum", "intra-chunk products",
          "C.h and y", "state update", "state store")


def launch_count() -> int:
    return sum(LAUNCHES.values())


_LIB: ctypes.CDLL | None = None
_PHASE_LIB: ctypes.CDLL | None = None
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("ssd_scan")
        lib.ssd_scan_bf16.argtypes = _ARGTYPES
        lib.ssd_scan_bf16.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.ssd_scan_smem_bytes.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _phase_lib() -> ctypes.CDLL:
    global _PHASE_LIB
    if _PHASE_LIB is None:
        lib = cuda_build.load("ssd_scan_phases")
        lib.ssd_scan_phases_bf16.argtypes = _ARGTYPES + [ctypes.c_void_p]
        lib.ssd_scan_phases_bf16.restype = ctypes.c_int
        _PHASE_LIB = lib
    return _PHASE_LIB


def _check(x, dt, a, b, c, chunk_size, initial_state) -> list:
    """Shape checks; the call's tensors."""
    if x.ndim != 4 or dt.shape != x.shape[:3] or \
            tuple(a.shape) != (x.shape[2],) or b.ndim != 4 or \
            b.shape != c.shape or b.shape[:2] != x.shape[:2] or \
            b.shape[2] < 1 or x.shape[2] % b.shape[2]:
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
    return [x, dt, a, b, c] + ([] if initial_state is None
                               else [initial_state])


def _kernel_args(x, dt, a, b, c, chunk_size, initial_state, tensors):
    """Card-side checks; (y, state, the C entry's arguments before the
    stream), or (y, state, None) when there is nothing to launch."""
    devices = {t.device for t in tensors}
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
    bsz, l, h, p = x.shape
    g, n = b.shape[2:]
    q = min(chunk_size, l)
    smem = smem_bytes(max(q, 1), n)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan: chunk {q} at state_dim {n} needs "
                         f"{smem} bytes of shared memory (at most "
                         f"{MAX_SMEM_BYTES})")
    y = torch.empty_like(x)
    if l == 0 or bsz == 0 or h == 0:
        state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                             device=x.device) if initial_state is None
                 else initial_state.clone())
        return y, state, None
    state = torch.empty((bsz, h, p, n), dtype=torch.float32,
                        device=x.device)
    h0 = 0 if initial_state is None else initial_state.data_ptr()
    return y, state, (x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                      b.data_ptr(), c.data_ptr(), h0, y.data_ptr(),
                      state.data_ptr(), bsz, l, h, g, p, n, q)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk_size: int = 256,
             initial_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,L,H,P); dt (B,L,H) fp32; a (H,) fp32; b/c (B,L,G,N) with G
    dividing H (G = H: per head); initial_state (B,H,P,N) fp32 or None.
    Returns (y (B,L,H,P) in ``x.dtype``, final state (B,H,P,N) fp32)."""
    tensors = _check(x, dt, a, b, c, chunk_size, initial_state)
    if {t.device for t in tensors} == {torch.device("cpu")}:
        return ssd_scan_plain(x, dt, a, b, c, chunk_size=chunk_size,
                              initial_state=initial_state)
    y, state, args = _kernel_args(x, dt, a, b, c, chunk_size,
                                  initial_state, tensors)
    if args is None:
        return y, state
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_bf16(*args, stream)
    cuda_build.check(lib, err, "ssd_scan_bf16")
    LAUNCHES[args[-1]] += 1
    return y, state


def phase_clocks(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, *, chunk_size: int = 256,
                 initial_state: torch.Tensor | None = None) -> dict:
    """Where one launch spends its time, phase by phase: the kernel built
    with per-phase clock stamps (``csrc/ssd_phases.cuh``; each marker
    syncs the block, so the build is a little slower than the real one)
    runs once on CUDA tensors.  Returns the mean over blocks of each
    phase's µs (:data:`PHASES`), of the block's span from first to last
    stamp, the span from the first block's start to the last block's end
    on the global timer, the SM clock the stamps ran at, and the block
    count.  A measurement, not the serving path: it counts no launch."""
    tensors = _check(x, dt, a, b, c, chunk_size, initial_state)
    y, state, args = _kernel_args(x, dt, a, b, c, chunk_size,
                                  initial_state, tensors)
    if args is None:
        raise ValueError("ssd_scan.phase_clocks: nothing to launch")
    blocks = launch_geometry(x.shape[0], x.shape[2], x.shape[3])[1]
    k = len(PHASES)
    clocks = torch.zeros((blocks, k + 3), dtype=torch.int64,
                         device=x.device)
    lib = _phase_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_phases_bf16(*args, stream, clocks.data_ptr())
    cuda_build.check(lib, err, "ssd_scan_phases_bf16")
    stamps = clocks.cpu().double()
    ns = stamps[:, k + 2] - stamps[:, k + 1]
    ghz = float((stamps[:, k] / ns.clamp_min(1.0)).median())
    return {"phases_us": {name: float(stamps[:, i].mean()) / ghz / 1e3
                          for i, name in enumerate(PHASES)},
            "block_us": float(stamps[:, k].mean()) / ghz / 1e3,
            "span_us": float(stamps[:, k + 2].max()
                             - stamps[:, k + 1].min()) / 1e3,
            "clock_ghz": ghz, "blocks": blocks}
