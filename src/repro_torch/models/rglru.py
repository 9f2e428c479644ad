"""RG-LRU recurrent block and the local-attention ring cache of the
PyTorch port (``repro.models.rglru``: RecurrentGemma / Griffin).

Recurrent block:
    y_branch = gelu(x W_y)
    u        = conv1d(x W_x)                      (causal depthwise, width 4)
    r_t      = sigmoid(BlockDiag_a(u_t));  i_t = sigmoid(BlockDiag_x(u_t))
    log a_t  = -c * r_t * softplus(Lambda)        (c = 8)
    h_t      = exp(log a_t) h_{t-1} + sqrt(1 - a_t^2) (i_t * u_t)
    out      = (h * y_branch) W_out

The attention layers of the hybrid keep a *ring* of the last ``window``
keys and values: slot ``pos % window`` holds token ``pos``, and a per-slot
absolute position (-1: never written) makes the mask exact, so decode
state is O(window) whatever the sequence length.

No kernel here, and none is missing: the reference computes the RG-LRU
and the ring attention in plain ``jnp`` outside any Pallas kernel, so
plain PyTorch ops on the card are the faithful counterpart of this
module, not a fallback.  (The hybrid's MLPs run ``block_matmul`` and its
monolithic prefill ``flash_attention``, through ``models.model``.)

Differences of form, not of result:
  * the linear recurrence over S > 1 tokens is a log-step (Hillis-Steele)
    scan in fp32, ceil(log2 S) rounds, where the reference runs
    ``jax.lax.associative_scan``: the same combine, summed in another
    order, so the two agree at fp32 tolerance, not bit for bit;
  * caches are updated in place, and a row that is not ``live`` keeps
    its entries bit for bit (the reference selects the old rows back
    afterwards);
  * the reference routes a chunk's pad tokens to a throwaway slot past
    the ring and drops it.  CUDA scatter with repeated indices is
    undefined, so a chunk's ring update computes, for each slot, which
    real token (if any) lands there, gathers it and selects over the
    whole ring: no scatter, no host read of any position.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, RGLRUConfig
from repro_torch.models.layers import _gelu_tanh
from repro_torch.models.params import ParamSpec
from repro_torch.models.ssm import _per_row_column, _softplus, \
    _write_state, causal_conv1d

C_GATE = 8.0
# the reference's mask value for scores of invisible ring slots
MASK_VALUE = -2.38e38


def rglru_specs(cfg: ModelConfig, rg: RGLRUConfig) -> dict:
    m, w = cfg.d_model, rg.lru_width
    nb = max(cfg.num_heads, 1)
    bw = w // nb
    return {
        "w_x": ParamSpec((m, w), axes=("embed", "inner")),
        "w_y": ParamSpec((m, w), axes=("embed", "inner")),
        "conv_w": ParamSpec((rg.conv_width, w), torch.float32,
                            ("conv", "inner")),
        "conv_b": ParamSpec((w,), torch.float32, ("inner",), init="zeros"),
        "gate_a_w": ParamSpec((nb, bw, bw), torch.float32,
                              ("heads", None, None)),
        "gate_a_b": ParamSpec((nb, bw), torch.float32, ("heads", None),
                              init="zeros"),
        "gate_x_w": ParamSpec((nb, bw, bw), torch.float32,
                              ("heads", None, None)),
        "gate_x_b": ParamSpec((nb, bw), torch.float32, ("heads", None),
                              init="zeros"),
        "lam": ParamSpec((w,), torch.float32, ("inner",), init="normal",
                         init_scale=0.8),
        "w_out": ParamSpec((w, m), axes=("inner", "embed")),
    }


def _block_diag(u: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """u (B,S,W) through the block-diagonal linear w (NB,BW,BW) + b
    (NB,BW), in fp32."""
    bsz, s, width = u.shape
    nb, bw, _ = w.shape
    ub = u.reshape(bsz, s, nb, bw).float()
    out = torch.einsum("bsnw,nwv->bsnv", ub, w) + b
    return out.reshape(bsz, s, width)


def lru_scan(log_a: torch.Tensor, gated_x: torch.Tensor,
             h0: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = exp(log_a_t) h_{t-1} + gated_x_t over dim 1, in fp32.

    log_a, gated_x: (B,S,W); h0: (B,W) or None, folded in as a virtual
    step 0.  A log-step scan of the reference's combine ``(la, h) <-
    (la_prev + la, exp(la) * h_prev + h)``: ceil(log2 S) rounds of a few
    whole-tensor ops.  A step with ``log_a = 0`` and ``gated_x = 0`` is
    an exact identity, so padding leaves the state as of the last real
    token.  -> (h (B,S,W), h_last (B,W))."""
    if h0 is not None:
        log_a = torch.cat([torch.zeros_like(log_a[:, :1]), log_a], dim=1)
        gated_x = torch.cat([h0.to(gated_x.dtype)[:, None], gated_x], dim=1)
    la, h = log_a, gated_x
    s = la.shape[1]
    step = 1
    while step < s:
        h = torch.cat([h[:, :step],
                       torch.exp(la[:, step:]) * h[:, :-step] + h[:, step:]],
                      dim=1)
        la = torch.cat([la[:, :step], la[:, :-step] + la[:, step:]], dim=1)
        step *= 2
    if h0 is not None:
        h = h[:, 1:]
    return h, h[:, -1]


def recurrent_block(params: dict, x: torch.Tensor, *, cfg: ModelConfig,
                    cache: dict | None = None,
                    valid_len: int | torch.Tensor | None = None,
                    live: torch.Tensor | None = None) -> torch.Tensor:
    """The Griffin recurrent block.  cache = {"h": (B,W) fp32, "conv":
    (B,conv_width-1,W) bf16}, updated in place (rows where ``live`` is
    False keep theirs).

    ``valid_len`` (a host int, or a 0-d or (B,) device scalar that is
    never read on the host): tokens past it get ``log a = 0`` and a zero
    input, so h carries the last real token's state, and the conv state
    stops at that token too (chunked-prefill padding, and a verify's
    restore pass)."""
    s = x.shape[1]
    y_branch = torch.einsum("bsm,mw->bsw", x, params["w_y"].to(x.dtype))
    y_branch = _gelu_tanh(y_branch.float()).to(x.dtype)
    u = torch.einsum("bsm,mw->bsw", x, params["w_x"].to(x.dtype))
    conv_state = cache["conv"] if cache is not None else None
    u, new_conv = causal_conv1d(u, params["conv_w"], params["conv_b"],
                                conv_state,
                                valid_len=(valid_len if cache is not None
                                           else None))
    r = torch.sigmoid(_block_diag(u, params["gate_a_w"],
                                  params["gate_a_b"]))
    i = torch.sigmoid(_block_diag(u, params["gate_x_w"],
                                  params["gate_x_b"]))
    log_a = -C_GATE * r * _softplus(params["lam"])          # (B,S,W) fp32
    a_sq = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a_sq, 1e-12)) * (i * u.float())
    if valid_len is not None:
        real = (torch.arange(s, device=x.device)
                < _per_row_column(valid_len))[..., None]
        log_a = torch.where(real, log_a, 0.0)
        gated = torch.where(real, gated, 0.0)

    h0 = cache["h"] if cache is not None else None
    if cache is not None and s == 1:
        h_last = torch.exp(log_a[:, 0]) * h0.float() + gated[:, 0]
        h = h_last[:, None]
    else:
        h, h_last = lru_scan(log_a, gated, h0)
    out = h.to(x.dtype) * y_branch
    out = torch.einsum("bsw,wm->bsm", out, params["w_out"].to(x.dtype))
    if cache is not None:
        _write_state(cache["h"], h_last, live)
        _write_state(cache["conv"], new_conv, live)
    return out


# --------------------------------------------------------------------------
# Ring-buffer window cache of the hybrid's local-attention layers
# --------------------------------------------------------------------------
def ring_specs(cfg: ModelConfig, batch: int) -> dict:
    """The ring's leaves; ``pos`` starts at -1 (``Model.init_cache``
    fills it so: a slot at position 0 would count as a visible key)."""
    w = cfg.rglru.window_size
    axes = ("batch", "window", "kv_heads", "head_dim")
    return {
        "k": ParamSpec((batch, w, cfg.num_kv_heads, cfg.head_dim),
                       cfg.cache_dtype(), axes, init="zeros"),
        "v": ParamSpec((batch, w, cfg.num_kv_heads, cfg.head_dim),
                       cfg.cache_dtype(), axes, init="zeros"),
        "pos": ParamSpec((batch, w), torch.int32, ("batch", "window"),
                         init="zeros"),
    }


def _rows(v, b: int, device) -> torch.Tensor:
    """A host int or a 0-d or (B,) tensor as a (B,) int64 tensor."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64).reshape(-1).expand(b)
    return torch.full((b,), int(v), dtype=torch.int64, device=device)


def _ring_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 visible: torch.Tensor) -> torch.Tensor:
    """q (B,S,H,D) over k/v (B,T,K,D) where ``visible`` (B,S,T) allows,
    in fp32 with the reference's mask value.  -> (B,S,H,D) in q.dtype."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    qf = q.reshape(b, s, kh, h // kh, d).float() * (d ** -0.5)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    scores = torch.where(visible[:, None, None], scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return ctx.reshape(b, s, h, d).to(q.dtype)


def ring_decode(q: torch.Tensor, cache: dict, k_new: torch.Tensor,
                v_new: torch.Tensor, t, window: int,
                live: torch.Tensor | None = None) -> torch.Tensor:
    """One-token attention against the ring, which takes the new key and
    value at slot ``t % window`` in place (rows where ``live`` is False
    keep theirs).

    q (B,1,H,D); k_new/v_new (B,1,K,D); ``t`` the absolute position, an
    int or a (B,) tensor.  Each row writes one slot of its own, so the
    indexed write has no repeated index.  -> context (B,1,H,D)."""
    b = q.shape[0]
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    t = _rows(t, b, q.device)
    slot = t % window
    bidx = torch.arange(b, device=q.device)
    nk, nv = k_new[:, 0].to(ck.dtype), v_new[:, 0].to(cv.dtype)
    npos = t.to(cpos.dtype)
    if live is not None:
        nk = torch.where(live[:, None, None], nk, ck[bidx, slot])
        nv = torch.where(live[:, None, None], nv, cv[bidx, slot])
        npos = torch.where(live, npos, cpos[bidx, slot])
    for leaf, new in ((ck, nk), (cv, nv), (cpos, npos)):
        _ring_write(leaf, bidx, slot, new)
    tcol = t[:, None]
    visible = (cpos >= 0) & (cpos <= tcol) & (cpos > tcol - window)
    return _ring_attend(q, ck, cv, visible[:, None, :])


def _ring_write(leaf: torch.Tensor, bidx: torch.Tensor, slot: torch.Tensor,
                new: torch.Tensor) -> None:
    """``leaf[bidx, slot] = new`` in place.  A DTensor leaf (a cache
    sharded over the batch: the dry-run) has no sharding strategy for the
    indexed write, so there the same values are written as a masked copy
    of the whole ring; a plain tensor (the card, every serve) takes the
    indexed write."""
    if not isinstance(leaf, DTensor):
        leaf[bidx, slot] = new
        return
    hit = torch.arange(leaf.shape[1], device=slot.device)[None] == \
        slot[:, None]
    hit = hit.reshape(hit.shape + (1,) * (leaf.ndim - 2))
    leaf.copy_(torch.where(hit, new[:, None], leaf))


def ring_chunk(q: torch.Tensor, cache: dict, k_new: torch.Tensor,
               v_new: torch.Tensor, t0, valid_len, window: int,
               live: torch.Tensor | None = None) -> torch.Tensor:
    """Chunked-prefill attention against the ring, then the ring update.

    q (B,C,H,D): rotated queries at positions t0..t0+C-1; k_new/v_new
    (B,C,K,D) the chunk's keys and values; ``t0`` and ``valid_len`` ints
    or 0-d or (B,) tensors: only the first ``valid_len`` tokens of a row
    are real.  Queries attend the ring (earlier tokens, per-slot absolute
    positions) and the chunk's real keys under the causal window mask.

    The update writes the last min(C, window) real tokens at their
    ``pos % window`` slots; pads write nothing.  Those tokens have
    consecutive positions, so each slot takes at most one of them: per
    slot j the chunk offset that lands there is computed, gathered and
    selected over the whole ring (rows where ``live`` is False keep
    theirs).  -> context (B,C,H,D)."""
    b, c = q.shape[:2]
    dev = q.device
    t0 = _rows(t0, b, dev)
    vl = _rows(valid_len, b, dev)
    offs = torch.arange(c, device=dev)
    qpos = t0[:, None] + offs                                   # (B,C)
    chunk_pos = torch.where(offs < vl[:, None], qpos, -1)
    kv_pos = torch.cat([cache["pos"].to(torch.int64), chunk_pos], dim=1)
    k_all = torch.cat([cache["k"].to(q.dtype), k_new], dim=1)
    v_all = torch.cat([cache["v"].to(q.dtype), v_new], dim=1)
    kp, qp = kv_pos[:, None, :], qpos[:, :, None]
    visible = (kp >= 0) & (kp <= qp) & (kp > qp - window)
    ctx = _ring_attend(q, k_all, v_all, visible)

    take = min(c, window)
    start = torch.clamp(vl - take, min=0, max=c - take)           # (B,)
    slots = torch.arange(window, device=dev)
    # the offset whose position is congruent to slot j, in [start,
    # start + window); written when it is a real token
    src = start[:, None] + torch.remainder(
        slots[None, :] - t0[:, None] - start[:, None], window)   # (B,W)
    write = src < vl[:, None]
    if live is not None:
        write = write & live[:, None]
    src = src.clamp(max=c - 1)
    idx = src[..., None, None].expand(b, window, *k_new.shape[2:])
    for name, new in (("k", k_new), ("v", v_new)):
        leaf = cache[name]
        leaf.copy_(torch.where(write[..., None, None],
                               new.gather(1, idx).to(leaf.dtype), leaf))
    cpos = cache["pos"]
    cpos.copy_(torch.where(write, (t0[:, None] + src).to(cpos.dtype), cpos))
    return ctx


def fill_ring(cache: dict, k: torch.Tensor, v: torch.Tensor,
              window: int) -> None:
    """After a monolithic prefill of S tokens from position 0, load the
    last min(S, window) into the ring at their ``pos % window`` slots, in
    place (consecutive positions: no slot repeats)."""
    s = k.shape[1]
    take = min(s, window)
    pos = torch.arange(s - take, s, device=k.device)
    slots = pos % window
    cache["k"][:, slots] = k[:, -take:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, -take:].to(cache["v"].dtype)
    cache["pos"][:, slots] = pos.to(cache["pos"].dtype)


# The reference's names, bound without a second ``def``: the repository's
# static analyzer resolves a reference ``from repro.models.rglru import
# f`` by the function name being unique in the corpus.
_lru_scan = lru_scan
window_cache_specs = ring_specs
rglru_block = recurrent_block
window_attention_decode = ring_decode
window_attention_chunk = ring_chunk
fill_window_cache = fill_ring
