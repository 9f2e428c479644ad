"""Adapters from model-side calling conventions to the kernels' layouts
(the dispatch contract of ``repro.kernels.ops``): leading dimensions of a
matmul input are flattened, attention (dense and paged) takes
``q_positions[..., 0]`` as each row's offset (every call site uses
row-contiguous positions), and the SSD scan takes the reference's layouts
as they are."""
from __future__ import annotations

import torch

from repro_torch.kernels import block_matmul as _bm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_paged as _fap
from repro_torch.kernels import ssd_scan as _ssd


def block_matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int = 128,
                 bk: int = 64, bn: int = 128) -> torch.Tensor:
    """x (..., K) @ w (K, N) through the tiled kernel."""
    lead = x.shape[:-1]
    out = _bm.block_matmul_2d(x.reshape(-1, x.shape[-1]), w, bm=bm, bk=bk,
                              bn=bn)
    return out.reshape(*lead, w.shape[-1])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, kv_valid_len, window=None,
                    softcap=None, bq: int = 64,
                    bkv: int = 64) -> torch.Tensor:
    """Models pass q_positions (B,S); the kernel takes a per-row offset
    with query i of row b at offset[b] + i."""
    offset = q_positions[..., 0].reshape(-1)
    return _fa.flash_attention(q, k, v, offset=offset,
                               kv_valid_len=kv_valid_len, bq=bq, bkv=bkv,
                               window=window, softcap=softcap)


def flash_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, *, page_table: torch.Tensor,
                          q_positions: torch.Tensor, kv_valid_len,
                          window=None, softcap=None) -> torch.Tensor:
    """k/v are physical page pools (P, page_size, K, D) read through
    ``page_table`` (B, pages_per_slot); no tile knob (the page size fixes
    the KV block)."""
    offset = q_positions[..., 0].reshape(-1)
    return _fap.flash_attention_paged(q, k_pool, v_pool, page_table,
                                      offset=offset,
                                      kv_valid_len=kv_valid_len,
                                      window=window, softcap=softcap)


def ssd_scan(x, dt, a, b, c, *, chunk_size: int = 256, initial_state=None):
    """x (B,L,H,P), dt (B,L,H), a (H,), b/c (B,L,H,N) -> (y, state)."""
    return _ssd.ssd_scan(x, dt, a, b, c, chunk_size=chunk_size,
                         initial_state=initial_state)
