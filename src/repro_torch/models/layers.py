"""Model layers of the PyTorch port (the dense family of
``repro.models.layers``).

Conventions, as in the reference:
  x           (B, S, M)    activations, bf16
  q           (B, S, H, D)
  k, v        (B, T, K, D) K = kv heads
  positions   (B, S) int
  norms, rope and the MLP activation run in fp32 and cast back.

The hot-spot ops go through the kernel hooks (``kernels.dispatch``)
unless a caller passes ``use_kernel_hook=False``, which runs the kernels'
plain versions on any device.  Caches (dense rows or page pools) are
updated in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.kernels.ref import attention_ref, matmul_ref, \
    paged_attention_ref
from repro_torch.models.params import ParamSpec

# Physical page 0 of every paged cache pool is the pinned trash page: free
# slots, unmapped table entries and frozen rows' writes point at it.
TRASH_PAGE = 0


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def norm_specs(cfg: ModelConfig, width: int | None = None) -> dict:
    w = width or cfg.d_model
    if cfg.norm_type == "layernorm":
        return {"scale": ParamSpec((w,), torch.float32, ("embed",),
                                   init="ones"),
                "bias": ParamSpec((w,), torch.float32, ("embed",),
                                  init="zeros")}
    return {"scale": ParamSpec((w,), torch.float32, ("embed",), init="ones")}


def apply_norm(params: dict, x: torch.Tensor, norm_type: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if norm_type == "layernorm":
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + eps)
        out = out * params["scale"] + params["bias"]
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * params["scale"]
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Rotary embeddings (split halves, llama / gemma convention)
# --------------------------------------------------------------------------
def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freq_idx = torch.arange(half, dtype=torch.float32, device=x.device)
    inv_freq = theta ** (-2.0 * freq_idx / d)
    ang = positions.float()[..., None] * inv_freq           # (B, S, half)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA / MQA / MHA; causal; optional sliding window)
# --------------------------------------------------------------------------
def attention_specs(cfg: ModelConfig) -> dict:
    m, h, k, d = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((m, h, d), axes=("embed", "heads", "head_dim")),
        "wk": ParamSpec((m, k, d), axes=("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((m, k, d), axes=("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, d, m), axes=("heads", "head_dim", "embed")),
    }


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           q_positions: torch.Tensor, kv_valid_len,
           window: int | None = None, softcap: float | None = None,
           use_kernel_hook: bool = True) -> torch.Tensor:
    """Masked GQA attention over row-contiguous query positions.

    q: (B, S, H, D); k/v: (B, T, K, D).  q_positions (B, S): absolute
    position of each query; kv slot j holds absolute position j and
    slots >= kv_valid_len (an int or a (B,) tensor) are invalid."""
    if use_kernel_hook:
        return dispatch.get_attention()(
            q, k, v, q_positions=q_positions, kv_valid_len=kv_valid_len,
            window=window, softcap=softcap)
    return attention_ref(q, k, v, offset=q_positions[..., 0].reshape(-1),
                         kv_valid_len=kv_valid_len, window=window,
                         softcap=softcap)


def attention(params: dict, x: torch.Tensor, *, cfg: ModelConfig,
              positions: torch.Tensor, cache: dict | None = None,
              cache_index: int | torch.Tensor | None = None,
              live: torch.Tensor | None = None,
              page_table: torch.Tensor | None = None,
              use_kernel_hook: bool = True) -> torch.Tensor:
    """Self-attention with an optional KV cache, updated in place.

    cache: {"k": (B, Tmax, K, D), "v": ...}; cache_index: absolute
    position of the first new token — a Python int when all rows are
    aligned (prefill from the host), or a (B,) tensor of per-row positions
    (continuous batching decode, and a prefill chunk whose start is a
    device scalar).  ``live`` (B,) bool masks the per-row write: a row
    that is not live keeps its cache entry bit-exact (frozen rows of a
    fused decode quantum); None writes every row.

    With ``page_table`` (B, pages_per_slot) the cache leaves are physical
    page pools ``(n_pages + 1, page_size, K, D)``: the new token's KV
    lands in its slot's page at ``cache_index`` and attention reads
    through the table.  Decode only (S == 1): prefill fills dense rows,
    which the serving engine scatters into pages."""
    b, s, _ = x.shape
    q = torch.einsum("bsm,mhd->bshd", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsm,mkd->bskd", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsm,mkd->bskd", x, params["wv"].to(x.dtype))
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = q.contiguous()
    if cache is None:
        y = attend(q, k.contiguous(), v.contiguous(), q_positions=positions,
                   kv_valid_len=s, window=cfg.sliding_window,
                   use_kernel_hook=use_kernel_hook)
    elif page_table is not None:
        if s != 1 or isinstance(cache_index, int):
            raise ValueError("a paged cache takes one-token decode steps "
                             "at (B,) positions (prefill fills dense rows)")
        ck, cv = cache["k"], cache["v"]
        ps = ck.shape[1]
        bidx = torch.arange(b, device=x.device)
        phys = page_table[bidx, cache_index // ps].long()
        if live is not None:
            # a row that is not live writes to the trash page: its own
            # pages stay bit-exact and no shared page is touched
            phys = torch.where(live, phys, TRASH_PAGE)
        off = cache_index % ps
        ck[phys, off] = k[:, 0].to(ck.dtype)
        cv[phys, off] = v[:, 0].to(cv.dtype)
        kvl = cache_index + 1
        if use_kernel_hook:
            y = dispatch.get_paged_attention()(
                q, ck, cv, page_table=page_table, q_positions=positions,
                kv_valid_len=kvl, window=cfg.sliding_window, softcap=None)
        else:
            y = paged_attention_ref(q, ck, cv, page_table,
                                    offset=positions[..., 0].reshape(-1),
                                    kv_valid_len=kvl,
                                    window=cfg.sliding_window)
    else:
        ck, cv = cache["k"], cache["v"]
        if isinstance(cache_index, int):
            # a host int is checked on the host; a tensor's rows are the
            # caller's to keep inside the cache (reading them would sync)
            if cache_index < 0 or cache_index + s > ck.shape[1]:
                raise ValueError(
                    f"cache write [{cache_index}, {cache_index + s}) "
                    f"outside the {ck.shape[1]}-position cache")
            ck[:, cache_index:cache_index + s] = k.to(ck.dtype)
            cv[:, cache_index:cache_index + s] = v.to(cv.dtype)
        else:
            rows = cache_index[:, None] + torch.arange(s, device=x.device)
            bidx = torch.arange(b, device=x.device)[:, None]
            nk, nv = k.to(ck.dtype), v.to(cv.dtype)
            if live is not None:
                keep = live[:, None, None, None]
                nk = torch.where(keep, nk, ck[bidx, rows])
                nv = torch.where(keep, nv, cv[bidx, rows])
            ck[bidx, rows] = nk
            cv[bidx, rows] = nv
        y = attend(q, ck, cv, q_positions=positions,
                   kv_valid_len=cache_index + s, window=cfg.sliding_window,
                   use_kernel_hook=use_kernel_hook)
    return torch.einsum("bshd,hdm->bsm", y, params["wo"].to(x.dtype))


# --------------------------------------------------------------------------
# MLPs: swiglu / geglu (gated) and plain gelu
# --------------------------------------------------------------------------
def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    m, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.activation in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec((m, f), axes=("embed", "mlp")),
            "w_up": ParamSpec((m, f), axes=("embed", "mlp")),
            "w_down": ParamSpec((f, m), axes=("mlp", "embed")),
        }
    return {
        "w_up": ParamSpec((m, f), axes=("embed", "mlp")),
        "b_up": ParamSpec((f,), torch.float32, ("mlp",), init="zeros"),
        "w_down": ParamSpec((f, m), axes=("mlp", "embed")),
        "b_down": ParamSpec((m,), torch.float32, ("embed",), init="zeros"),
    }


def _gelu_tanh(a: torch.Tensor) -> torch.Tensor:
    return F.gelu(a, approximate="tanh")


def apply_mlp(params: dict, x: torch.Tensor, activation: str, *,
              use_kernel_hook: bool = True) -> torch.Tensor:
    """Every GEMM runs through ``block_matmul`` (or its plain version)."""
    mm = dispatch.get_matmul() if use_kernel_hook else matmul_ref
    if activation in ("swiglu", "geglu"):
        gate = mm(x, params["w_gate"].to(x.dtype))
        up = mm(x, params["w_up"].to(x.dtype))
        act = F.silu if activation == "swiglu" else _gelu_tanh
        h = act(gate.float()).to(x.dtype) * up
        return mm(h, params["w_down"].to(x.dtype))
    h = mm(x, params["w_up"].to(x.dtype))
    h = h + params["b_up"].to(h.dtype)
    h = _gelu_tanh(h.float()).to(x.dtype)
    out = mm(h, params["w_down"].to(x.dtype))
    return out + params["b_down"].to(out.dtype)


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------
def embed_specs(cfg: ModelConfig) -> dict:
    s = {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model),
                                axes=("vocab", "embed"), init="embed")}
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                 axes=("embed", "vocab"))
    return s


def embed(params: dict, tokens: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    x = params["embedding"][tokens]
    if cfg.embed_scale:
        # the reference rounds sqrt(d_model) to the activation dtype
        # first (45.25 for gemma-2b, not 45.2548)
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
        x = x * float(scale)
    return x


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """bf16 product, then cast to fp32 (the reference's rounding)."""
    if cfg.tie_embeddings:
        logits = torch.einsum("bsm,vm->bsv", x,
                              params["embedding"].to(x.dtype))
    else:
        logits = torch.einsum("bsm,mv->bsv", x, params["unembed"].to(x.dtype))
    logits = logits.float()
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits
