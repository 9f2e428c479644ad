"""Causal GQA/MQA flash attention (online softmax) — the port's second
kernel.

Port of the dense kernel of ``repro.kernels.flash_attention`` (the TPU
kernel ``_flash_kernel`` / ``flash_attention``).  Query i of batch row b
sits at absolute position ``offset[b] + i``; key j is visible when ``j <=
q_pos``, ``j < kv_valid_len[b]`` and, with a window w, ``j > q_pos - w``.
The kv head of query head h is ``h // (H / K)``.  The (bq, bkv) block is
the second per-level knob: the kernel holds all G = H/K query heads of a
KV group in one block, so bq counts rows of the flattened (S x G) query
axis (row s*G + g), and bkv is the key tile.

On a CUDA tensor the wrapper launches ``csrc/flash_attention.cu`` with
the selected block and the split-KV cluster size :func:`split_kv` picks
(one launch either way); on a CPU tensor it runs :func:`attention_plain`, the
kernel's plain PyTorch version with the same numerics contract (fp32
scores of the upcast, scaled q; masked scores at ``NEG_INF``; masked
probabilities zeroed; denominator clamped at 1e-30, so a fully masked
row is 0).

Under autograd (grad enabled and q, k or v requiring grad) the call goes
through :class:`FlashAttentionGrad`: its forward is the same launch, its
backward the gradient of :func:`attention_plain` recomputed from the
saved q, k and v (the reference differentiates only its plain attention
too; a backward kernel from a saved log-sum-exp is open work).  Without
grad the call is the launch alone, as on the serving paths.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.dist.placement import hint
from repro_torch.kernels import cuda_build
from repro_torch.kernels.block_matmul import MAX_SPLIT, SMS, \
    _pow2_at_least

NEG_INF = -2.3819763e38

# Dynamic shared memory one block may use on an H100 (232,448 bytes).
MAX_SMEM_BYTES = 227 * 1024

# What the CUDA kernel is instantiated for: head dims, key tiles, and at
# most 64 flattened query rows per block.
HEAD_DIMS = (32, 64, 128, 256)
BKV_CHOICES = (16, 32, 64)
MAX_ROWS = 64

# Launches of the CUDA kernel, keyed by the (bq, bkv) block and the split
# it ran.
LAUNCHES: collections.Counter = collections.Counter()


def _per_row(v, b: int, device) -> torch.Tensor:
    """A scalar or (B,) position argument as a (B,) int32 tensor."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).reshape(-1).expand(b)
    return torch.full((b,), int(v), dtype=torch.int32, device=device)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    offset, kv_valid_len, window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """The kernel's plain version: q (B,S,H,D), k/v (B,T,K,D)."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.float().reshape(b, s, kh, g, d) * (d ** -0.5)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    # keep scores sharded like the KV sequence (a no-op outside
    # ``dist.placement.use_rules``)
    scores = hint(scores, ("batch", None, None, None, "seq"))
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    off = _per_row(offset, b, q.device)
    kvl = torch.clamp(_per_row(kv_valid_len, b, q.device), max=t)
    qpos = off[:, None] + torch.arange(s, device=q.device)[None, :]
    j = torch.arange(t, device=q.device)[None, None, :]
    mask = (j <= qpos[:, :, None]) & (j < kvl[:, None, None])
    if window is not None:
        mask &= j > qpos[:, :, None] - window
    mask = mask[:, None, None]                        # (B,1,1,S,T)
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgst,btkd->bkgsd", p, v.float()) / denom
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def smem_bytes(bq: int, bkv: int, d: int) -> int:
    """Dynamic shared memory of one block of ``bq`` flattened query rows
    (padded to 16, 32 or 64): the bf16 Q tile, fp32 scores, bf16 P hi and
    lo, fp32 m/l/alpha, then two buffers of bf16 K and V tiles or, if
    larger, the fp32 partial accumulator a split combines (``Layout`` in
    the CUDA source; bf16 rows padded by 8, fp32 score rows by 4).  The
    wrapper refuses a block beyond the card's limit with it;
    :func:`kernel_smem_bytes` is the kernel's own count, which the card
    checks hold equal to this one."""
    rows = _pow2_at_least(bq, 16)
    ring = 2 * 2 * bkv * (d + 8) * 2
    return rows * (d + 8) * 2 + rows * (bkv + 4) * 4 + \
        2 * rows * (bkv + 8) * 2 + 3 * rows * 4 + max(ring, rows * d * 4)


def kernel_smem_bytes(bq: int, bkv: int, d: int) -> int:
    """Dynamic shared memory the built kernel gives a (bq, bkv) block at
    head_dim ``d`` (``Layout::BYTES``; on a machine with ``nvcc``), or -1
    for a block it is not built for."""
    return _lib().flash_attention_smem_bytes(bq, bkv, d)


def split_kv(batch: int, kv_heads: int, q_tiles: int, t: int,
             bkv: int) -> int:
    """Blocks of the cluster that share one (KV head, row, query tile),
    each on a contiguous run of the visible KV tiles: doubled from 1 while
    the blocks leave SMs idle, up to MAX_SPLIT, as long as the cache holds
    a KV tile for every block.  Decided from shapes alone (the visible tiles
    depend on per-row offsets on the device); a block whose run is empty
    only joins the combine.  Reads no tile table."""
    blocks = batch * kv_heads * q_tiles
    kv_tiles = -(-t // bkv)
    split = 1
    while split < MAX_SPLIT and blocks * split < SMS and \
            kv_tiles >= 2 * split:
        split *= 2
    return split


def launch_geometry(b: int, s: int, h: int, kh: int, t: int, bq: int,
                    bkv: int) -> tuple[tuple[int, int], int, int]:
    """The effective (bq, bkv) block (bq in flattened (query, head-of-group)
    rows), the split and the number of blocks of the one launch a
    (B, S, H, D) x (B, T, KH, D) call gets."""
    rows = s * (h // kh)
    tbq, tbkv = min(bq, rows), min(bkv, _pow2_at_least(t, BKV_CHOICES[0]))
    q_tiles = -(-rows // tbq) if tbq else 0
    split = split_kv(b, kh, q_tiles, t, tbkv)
    return (tbq, tbkv), split, b * kh * q_tiles * split


def launch_count() -> int:
    return sum(LAUNCHES.values())


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                             i, i, i, i, i, f, f, i, p]
        lib.flash_attention_bf16.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [i, i, i]
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    offset, kv_valid_len, bq: int = 64, bkv: int = 64,
                    window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """q (B,S,H,D); k/v (B,T,K,D); offset / kv_valid_len are ints or (B,)
    tensors.  Returns (B,S,H,D) in ``q.dtype``; differentiable in q, k
    and v when grad is enabled and one of them requires it."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or \
            q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionGrad.apply(q, k, v, offset, kv_valid_len, bq,
                                        bkv, window, softcap)
    return _launch(q, k, v, offset, kv_valid_len, bq, bkv, window, softcap)


class FlashAttentionGrad(torch.autograd.Function):
    """B2 forward, the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, q, k, v, offset, kv_valid_len, bq, bkv, window,
                softcap):
        out = _launch(q, k, v, offset, kv_valid_len, bq, bkv, window,
                      softcap)
        ctx.save_for_backward(q, k, v)
        ctx.mask = (offset, kv_valid_len, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        offset, kv_valid_len, window, softcap = ctx.mask
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            out = attention_plain(*inputs, offset=offset,
                                  kv_valid_len=kv_valid_len, window=window,
                                  softcap=softcap)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, dout))
        return (*(next(grads) if t.requires_grad else None
                  for t in inputs), None, None, None, None, None, None)


def _launch(q, k, v, offset, kv_valid_len, bq, bkv, window,
            softcap) -> torch.Tensor:
    """One call: the plain version on CPU tensors, else one launch of the
    kernel."""
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return attention_plain(q, k, v, offset=offset,
                               kv_valid_len=kv_valid_len, window=window,
                               softcap=softcap)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {devices}; the "
                         "kernel takes one CUDA device")
    if {q.dtype, k.dtype, v.dtype} != {torch.bfloat16}:
        raise TypeError("flash_attention: kernel takes bf16 q, k, v")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: kernel takes contiguous tensors")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} is not one the "
                         f"kernel is built for {HEAD_DIMS}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: kernel takes 16-byte aligned "
                         "tensors")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap {softcap} must be > 0")
    (tbq, tbkv), split, _ = launch_geometry(b, s, h, kh, t, bq, bkv)
    smem = smem_bytes(tbq, tbkv, d)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention: block (bq={tbq}, bkv={tbkv}) "
                         f"at head_dim {d} needs {smem} bytes of shared "
                         f"memory (at most {MAX_SMEM_BYTES})")
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    if not 1 <= tbq <= MAX_ROWS or tbkv not in BKV_CHOICES:
        raise ValueError(f"flash_attention: block (bq={tbq}, bkv={tbkv}) "
                         "is not one the kernel is built for (bq <= "
                         f"{MAX_ROWS} flattened rows, bkv {BKV_CHOICES})")
    off = _per_row(offset, b, q.device).contiguous()
    kvl = _per_row(kv_valid_len, b, q.device).contiguous()
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            off.data_ptr(), kvl.data_ptr(), b, s, h, t, kh, d, tbq, tbkv,
            int(window or 0), float(softcap or 0.0), float(d ** -0.5), split,
            stream)
    cuda_build.check(lib, err, "flash_attention_bf16")
    LAUNCHES[(tbq, tbkv, split)] += 1
    return out
