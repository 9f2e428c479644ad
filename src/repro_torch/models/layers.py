"""Model layers of the PyTorch port (the dense family of
``repro.models.layers``).

Conventions, as in the reference:
  x           (B, S, M)    activations, bf16
  q           (B, S, H, D)
  k, v        (B, T, K, D) K = kv heads
  positions   (B, S) int, or (3, B, S) (t, h, w) for M-RoPE
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
from repro_torch.dist.placement import grad_in_place_of, hint
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
# Rotary embeddings (RoPE and qwen2-vl M-RoPE; split halves, llama / gemma
# convention) and sinusoidal position encodings
# --------------------------------------------------------------------------
def rotary_angles(positions: torch.Tensor, head_dim: int, theta: float,
                  mrope_sections: tuple[int, int, int] | None
                  ) -> torch.Tensor:
    """-> (B, S, D/2) fp32 angles.  ``positions`` (B, S), or (3, B, S)
    (t, h, w) with ``mrope_sections``: frequency pairs [0:s0] take the t
    row, [s0:s0+s1] the h row, the rest the w row."""
    half = head_dim // 2
    freq_idx = torch.arange(half, dtype=torch.float32,
                            device=positions.device)
    inv_freq = theta ** (-2.0 * freq_idx / head_dim)        # (half,)
    posf = positions.float()
    if mrope_sections is None:
        return posf[..., None] * inv_freq                   # (B, S, half)
    s0, s1, s2 = mrope_sections
    if s0 + s1 + s2 != half:
        raise ValueError(f"M-RoPE sections {mrope_sections} do not split "
                         f"{half} frequency pairs")
    _, b, s = posf.shape
    pos_sel = torch.cat([posf[i:i + 1].expand(n, b, s)
                         for i, n in enumerate(mrope_sections)])
    return pos_sel.movedim(0, -1) * inv_freq                # (B, S, half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple[int, int, int] | None = None
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions (B, S), or (3, B, S) with
    ``mrope_sections``."""
    d = x.shape[-1]
    half = d // 2
    ang = rotary_angles(positions, d, theta, mrope_sections)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor,
                         width: int) -> torch.Tensor:
    """(B, S) -> (B, S, width) fp32 sinusoidal position encoding: sines
    of the first half of the frequencies, then cosines."""
    half = width // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# the reference's names, bound without a second ``def``: the repository's
# static analyzer resolves the reference's calls of them by the function
# name being unique in the corpus
_rope_angles = rotary_angles
sinusoidal_pe = sinusoidal_positions


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


def _settled():
    """The ``write_rows`` result of a write that needs no settling."""


def write_rows(cache: dict, new: dict, cache_index, *,
               live: torch.Tensor | None = None,
               page_table: torch.Tensor | None = None):
    """Write each row's S new entries (``new[name]`` (B, S, ...)) into the
    cache leaves ``cache[name]`` (dense rows (B, Tmax, ...) or, with
    ``page_table``, page pools (n_pages + 1, page_size, ...)) from
    ``cache_index`` on, in place.  Returns ``settle``, which the caller
    calls once it has read the cache.

    ``cache_index`` is a host int (all rows aligned; checked on the host)
    or a (B,) tensor.  ``live`` (B,) bool masks the per-row write.  A
    dense row that is not live is written too, so that its attention reads
    its own new entries as the reference's (which writes every row and
    reverts afterwards) does: whatever routes every row together (a
    capacity MoE) sees the reference's inputs; ``settle()`` then puts its
    old entries back, bit-exact.  A paged row that is not live writes to
    the trash page (its pages may be shared with a live row's prefix) and
    reads its stale entry.  A multi-token write with a live mask (a
    verify pass) keeps every write inside the cache: a paged position
    past the table goes to the trash page, and a dense position past the
    row (a frozen row near the end of its slot; the reference's scatter
    drops it) is not kept."""
    b, s = next(iter(new.values())).shape[:2]
    first = cache[next(iter(new))]
    if page_table is not None:
        if not isinstance(cache_index, torch.Tensor):
            raise ValueError("a paged cache takes (B,) positions (prefill "
                             "fills dense rows)")
        ps, n_slot = first.shape[1], page_table.shape[1]
        rows = cache_index[:, None] + torch.arange(s, device=first.device)
        slot = rows // ps
        bidx = torch.arange(b, device=first.device)[:, None]
        keep = live[:, None] if live is not None else None
        if s > 1:
            # a verify pass may run past the table: clamp the lookup and
            # send the position to the trash page
            keep = slot < n_slot if keep is None else keep & (slot < n_slot)
            slot = slot.clamp(max=n_slot - 1)
        phys = page_table[bidx, slot].long()
        if keep is not None:
            # a row that is not live writes to the trash page: its own
            # pages stay bit-exact and no shared page is touched
            phys = torch.where(keep, phys, TRASH_PAGE)
        off = rows % ps
        for name, val in new.items():
            cache[name][phys, off] = val.to(cache[name].dtype)
        return _settled
    if isinstance(cache_index, int):
        # a host int is checked on the host; a tensor's rows are the
        # caller's to keep inside the cache (reading them would sync)
        if cache_index < 0 or cache_index + s > first.shape[1]:
            raise ValueError(
                f"cache write [{cache_index}, {cache_index + s}) "
                f"outside the {first.shape[1]}-position cache")
        for name, val in new.items():
            cache[name][:, cache_index:cache_index + s] = \
                val.to(cache[name].dtype)
        return _settled
    rows = cache_index[:, None] + torch.arange(s, device=first.device)
    bidx = torch.arange(b, device=first.device)[:, None]
    vals = {name: val.to(cache[name].dtype) for name, val in new.items()}
    keep = live[:, None] if live is not None else None
    if s > 1 and live is not None:
        # a verify pass (a multi-token write with a live mask; a prefill
        # chunk's caller keeps its rows inside) may run past the row:
        # clamp every index into it.  A clamped position writes what its
        # row's last position gets (the same source token), so repeated
        # indices agree; a row that starts past the end keeps its entries
        t_max = first.shape[1]
        clamped = rows.clamp(max=t_max - 1)
        src = (clamped - cache_index[:, None]).clamp(min=0)
        for name, val in vals.items():
            idx = src.reshape(b, s, *(1,) * (val.ndim - 2))
            vals[name] = val.gather(1, idx.expand_as(val))
        keep = keep & (cache_index < t_max)[:, None]
        rows = clamped
    if keep is None:
        for name, val in vals.items():
            cache[name][bidx, rows] = val
        return _settled
    kept = {}
    for name, val in vals.items():
        leaf = cache[name]
        mask = keep.reshape(*keep.shape, *(1,) * (val.ndim - 2))
        kept[name] = torch.where(mask, val, leaf[bidx, rows])
        leaf[bidx, rows] = val

    def settle():
        for name, val in kept.items():
            cache[name][bidx, rows] = val
    return settle


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
    page pools ``(n_pages + 1, page_size, K, D)``: each row's S new
    tokens land in its slot's pages from ``cache_index`` (B,) on, and
    attention reads through the table.  Decode steps (S == 1) and
    speculative verify passes (S = d + 1) take this path; prefill fills
    dense rows, which the serving engine scatters into pages.

    A verify pass (S > 1 at (B,) positions with ``live``) keeps every
    write inside the cache: a paged position past the table goes to the
    trash page, and a dense position past the row (a frozen row near the
    end of its slot; the reference's scatter drops it) is not written."""
    b, s, _ = x.shape
    q = torch.einsum("bsm,mhd->bshd", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsm,mkd->bskd", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsm,mkd->bskd", x, params["wv"].to(x.dtype))
    mrope = cfg.mrope_sections if cfg.pos_embed == "mrope" else None
    if cfg.pos_embed in ("rope", "mrope"):
        q = apply_rope(q, positions, cfg.rope_theta, mrope)
        k = apply_rope(k, positions, cfg.rope_theta, mrope)
    # M-RoPE positions (3, B, S): the masks and the kernels' offsets read
    # the last (w) row, as the reference's do
    qpos = positions[-1] if positions.ndim == 3 else positions
    q = q.contiguous()
    if cache is None:
        y = attend(q, k.contiguous(), v.contiguous(), q_positions=qpos,
                   kv_valid_len=s, window=cfg.sliding_window,
                   use_kernel_hook=use_kernel_hook)
    elif page_table is not None:
        settle = write_rows(cache, {"k": k, "v": v}, cache_index,
                            live=live, page_table=page_table)
        ck, cv = cache["k"], cache["v"]
        kvl = cache_index + s
        if use_kernel_hook:
            y = dispatch.get_paged_attention()(
                q, ck, cv, page_table=page_table, q_positions=qpos,
                kv_valid_len=kvl, window=cfg.sliding_window, softcap=None)
        else:
            y = paged_attention_ref(q, ck, cv, page_table,
                                    offset=qpos[..., 0].reshape(-1),
                                    kv_valid_len=kvl,
                                    window=cfg.sliding_window)
        settle()
    else:
        settle = write_rows(cache, {"k": k, "v": v}, cache_index, live=live)
        ck, cv = cache["k"], cache["v"]
        y = attend(q, ck, cv, q_positions=qpos,
                   kv_valid_len=cache_index + s, window=cfg.sliding_window,
                   use_kernel_hook=use_kernel_hook)
        settle()
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
    x = grad_in_place_of(params["embedding"])[tokens]
    if cfg.embed_scale:
        # the reference rounds sqrt(d_model) to the activation dtype
        # first (45.25 for gemma-2b, not 45.2548)
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
        # veltair: ignore[torch-host-sync] scale is a CPU tensor (no device given): float() reads host memory, nothing waits for the card
        x = x * float(scale)
    return x


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """bf16 product, then cast to fp32 (the reference's rounding)."""
    if cfg.tie_embeddings:
        logits = torch.einsum("bsm,vm->bsv", x, grad_in_place_of(
            params["embedding"]).to(x.dtype))
    else:
        logits = torch.einsum("bsm,mv->bsv", x, params["unembed"].to(x.dtype))
    logits = hint(logits.float(), ("batch", "seq", "vocab"))
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------
def token_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy over the masked tokens: logits fp32 (B, S, V),
    labels (B, S) int, the log-sum-exp in fp32."""
    # (B, S, 1) until the difference: a DTensor gather over a vocab-
    # sharded dim is a masked partial, which cannot change rank before it
    # is reduced (the same values and kernels as a (B, S) difference)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    ll = logits.gather(-1, labels.long()[..., None])
    nll = (lse - ll)[..., 0]
    if mask is not None:
        maskf = mask.float()
        return (nll * maskf).sum() / maskf.sum().clamp(min=1.0)
    return nll.mean()


# the reference's name, bound without a second ``def`` (see ``_rope_angles``)
cross_entropy = token_cross_entropy
