"""Multi-head Latent Attention (DeepSeek-V2) of the PyTorch port
(``repro.models.mla``).

KV is compressed to a ``kv_lora_rank`` latent (plus a single shared RoPE key
head), which is what gets cached: 512 + 64 values a token instead of
2 * H * head_dim.  Two decode paths, as in the reference:

  * plain    — cached latents are re-expanded through W_uk / W_uv each call;
  * absorbed — W_uk is folded into the query and W_uv into the output, so
               attention runs directly in latent space.

Attention is plain PyTorch ops, as the reference's is plain ``jnp``: the
q.k width (qk_nope + qk_rope) differs from v's, and no kernel runs here.
Caches (dense rows or page pools) are updated in place through
``layers.write_rows``; a paged cache gathers the full horizon of latents
through the page table.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.models.layers import apply_norm, apply_rope, norm_specs, \
    write_rows
from repro_torch.models.params import ParamSpec

NEG_INF = -2.3819763e38  # large negative, bf16-safe after cast

# Above this many scores a row block (S x T) is scored in query chunks.
SCORE_CHUNK_ELEMS = 1 << 22


def latent_attention_params(cfg: ModelConfig, mla: MLAConfig) -> dict:
    m, h = cfg.d_model, cfg.num_heads
    dn, dr, dv = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    r = mla.kv_lora_rank
    return {
        "wq": ParamSpec((m, h, dn + dr), axes=("embed", "heads", "head_dim")),
        "w_dkv": ParamSpec((m, r + dr), axes=("embed", "kv_lora")),
        "kv_norm": norm_specs(cfg, r),
        "w_uk": ParamSpec((r, h, dn), axes=("kv_lora", "heads", "head_dim")),
        "w_uv": ParamSpec((r, h, dv), axes=("kv_lora", "heads", "head_dim")),
        "wo": ParamSpec((h, dv, m), axes=("heads", "head_dim", "embed")),
    }


def latent_leaves(cfg: ModelConfig, batch: int, t_max: int) -> dict:
    """One MLA layer's cache: the normalized latent and the rotated RoPE
    key, bf16, with a ``"seq"`` axis (so they page, and a verify keeps
    their writes as KV leaves)."""
    r, dr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    return {"c_kv": ParamSpec((batch, t_max, r), cfg.cache_dtype(),
                              ("batch", "seq", "kv_lora"), init="zeros"),
            "k_rope": ParamSpec((batch, t_max, 1, dr), cfg.cache_dtype(),
                                ("batch", "seq", None, "head_dim"),
                                init="zeros")}


def compress_latents(params, x, cfg: ModelConfig, mla: MLAConfig, positions):
    """x -> (c_kv (B,S,r) normalized, k_rope (B,S,1,dr) rotated)."""
    r = mla.kv_lora_rank
    ckv_full = torch.einsum("bsm,mr->bsr", x, params["w_dkv"].to(x.dtype))
    c_kv = apply_norm(params["kv_norm"], ckv_full[..., :r], cfg.norm_type)
    k_rope = ckv_full[..., r:][:, :, None, :]          # (B,S,1,dr)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    return c_kv, k_rope


def latent_queries(params, x, cfg: ModelConfig, mla: MLAConfig, positions):
    dn = mla.qk_nope_head_dim
    q = torch.einsum("bsm,mhd->bshd", x, params["wq"].to(x.dtype))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def latent_mask(t: int, q_positions: torch.Tensor, kv_valid_len):
    """(B,S,T): key j visible to a query at p when j <= p and j is below
    the row's valid length (an int or a (B,) tensor)."""
    j = torch.arange(t, device=q_positions.device)[None, None, :]
    mask = j <= q_positions[:, :, None]
    if isinstance(kv_valid_len, torch.Tensor) and kv_valid_len.ndim:
        return mask & (j < kv_valid_len.reshape(-1, 1, 1))
    return mask & (j < kv_valid_len)


def score_chunk_len(s: int, t: int) -> int:
    """Largest divisor of s with chunk * t <= SCORE_CHUNK_ELEMS (>= 1)."""
    target = max(SCORE_CHUNK_ELEMS // max(t, 1), 1)
    best = 1
    for c in range(1, min(target, s) + 1):
        if s % c == 0:
            best = c
    return best


def latent_attention(params: dict, x: torch.Tensor, *, cfg: ModelConfig,
                     positions: torch.Tensor, cache: dict | None = None,
                     cache_index=None, live: torch.Tensor | None = None,
                     page_table: torch.Tensor | None = None) -> torch.Tensor:
    """MLA self-attention; cache = {"c_kv": (B,T,r), "k_rope": (B,T,1,dr)},
    updated in place (``layers.write_rows``: ``cache_index`` a host int or
    (B,) positions, ``live`` masking each row's write).

    With ``page_table`` (B, pages_per_slot) the cached latents live in
    physical page pools ``(n_pages + 1, page_size, ...)``: the new latents
    land in each row's pages (unmapped spans and rows that are not live on
    the trash page) and the full horizon is gathered through the table.
    -> (B,S,M)."""
    mla = cfg.mla
    b, s, _ = x.shape
    dn, dr = mla.qk_nope_head_dim, mla.qk_rope_head_dim
    scale = (dn + dr) ** -0.5

    q_nope, q_rope = latent_queries(params, x, cfg, mla, positions)
    c_kv, k_rope = compress_latents(params, x, cfg, mla, positions)

    settle = None
    if cache is None:
        ckv_all, krope_all, kv_len = c_kv, k_rope, s
    else:
        settle = write_rows(cache, {"c_kv": c_kv, "k_rope": k_rope},
                            cache_index, live=live, page_table=page_table)
        ckv_all, krope_all = cache["c_kv"], cache["k_rope"]
        if page_table is not None:
            n = page_table.shape[1] * ckv_all.shape[1]
            ckv_all = ckv_all[page_table.long()].reshape(
                b, n, *ckv_all.shape[2:])
            krope_all = krope_all[page_table.long()].reshape(
                b, n, *krope_all.shape[2:])
        kv_len = cache_index + s
    t = ckv_all.shape[1]
    w_uk = params["w_uk"].to(x.dtype)
    w_uv = params["w_uv"].to(x.dtype)

    if mla.absorb:
        def attn_chunk(q_nope_c, q_rope_c, pos_c):
            # fold W_uk into q: q_lat (B,C,H,r); score against raw latents
            mask = latent_mask(t, pos_c, kv_len)[:, None]
            q_lat = torch.einsum("bshd,rhd->bshr", q_nope_c, w_uk)
            s_nope = torch.einsum("bshr,btr->bhst", q_lat.float(),
                                  ckv_all.float())
            s_rope = torch.einsum("bshd,btzd->bhst", q_rope_c.float(),
                                  krope_all.float())
            scores = torch.where(mask, (s_nope + s_rope) * scale, NEG_INF)
            probs = torch.softmax(scores, dim=-1)
            ctx = torch.einsum("bhst,btr->bshr", probs,
                               ckv_all.float())        # (B,C,H,r)
            return torch.einsum("bshr,rhd->bshd", ctx.to(x.dtype), w_uv)
    else:
        k_nope = torch.einsum("btr,rhd->bthd", ckv_all, w_uk)  # (B,T,H,dn)
        v = torch.einsum("btr,rhd->bthd", ckv_all, w_uv)       # (B,T,H,dv)
        k_full = torch.cat([k_nope, krope_all.expand(
            b, t, cfg.num_heads, dr)], dim=-1)

        def attn_chunk(q_nope_c, q_rope_c, pos_c):
            mask = latent_mask(t, pos_c, kv_len)[:, None]
            q = torch.cat([q_nope_c, q_rope_c], dim=-1)
            scores = torch.einsum("bshd,bthd->bhst", q.float(),
                                  k_full.float()) * scale
            scores = torch.where(mask, scores, NEG_INF)
            probs = torch.softmax(scores, dim=-1)
            return torch.einsum("bhst,bthd->bshd", probs,
                                v.float()).to(x.dtype)

    if s * t <= SCORE_CHUNK_ELEMS or s == 1:
        y = attn_chunk(q_nope, q_rope, positions)
    else:
        cs = score_chunk_len(s, t)
        y = torch.cat([attn_chunk(q_nope[:, i:i + cs], q_rope[:, i:i + cs],
                                  positions[:, i:i + cs])
                       for i in range(0, s, cs)], dim=1)
    if settle is not None:
        settle()
    return torch.einsum("bshd,hdm->bsm", y, params["wo"].to(x.dtype))


# The reference's names, bound without a second ``def``: the repository's
# static analyzer resolves the reference's ``from repro.models import mla``
# calls by the function name being unique in the corpus.
mla_specs = latent_attention_params
_compress = compress_latents
_queries = latent_queries
_mask = latent_mask
mla_attention = latent_attention
