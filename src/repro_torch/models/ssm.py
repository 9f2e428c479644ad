"""Mamba-2 block of the PyTorch port (``repro.models.ssm``).

Recurrence (per head, state (P=head_dim, N=state_dim)):
    h_t = exp(dt_t * A) h_{t-1} + dt_t * (x_t  B_t^T)      (outer product)
    y_t = C_t . h_t + D * x_t

A prompt of two or more tokens runs the chunked SSD scan through the
``ssd_scan`` kernel hook (``kernels.dispatch.get_ssd``); one token with a
cache runs :func:`ssd_decode_step` in plain PyTorch, as the reference
does (it has no kernel there).  The in/out projections are plain
``einsum`` products, as in the reference, where they sit outside any
Pallas kernel.  Caches are updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import dispatch
from repro_torch.kernels.ref import ssd_ref
from repro_torch.models.layers import apply_norm, norm_specs
from repro_torch.models.params import ParamSpec


def ssm_specs(cfg: ModelConfig, ssm: SSMConfig) -> dict:
    m = cfg.d_model
    di, g, n, nh = ssm.d_inner, ssm.num_groups, ssm.state_dim, ssm.num_heads
    conv_ch = di + 2 * g * n
    d_in_proj = 2 * di + 2 * g * n + nh
    return {
        "in_proj": ParamSpec((m, d_in_proj), axes=("embed", "inner")),
        "conv_w": ParamSpec((ssm.conv_width, conv_ch), torch.float32,
                            ("conv", "inner")),
        "conv_b": ParamSpec((conv_ch,), torch.float32, ("inner",),
                            init="zeros"),
        "A_log": ParamSpec((nh,), torch.float32, (None,), init="zeros"),
        "dt_bias": ParamSpec((nh,), torch.float32, (None,), init="zeros"),
        "D": ParamSpec((nh,), torch.float32, (None,), init="ones"),
        "norm": norm_specs(cfg, di),
        "out_proj": ParamSpec((di, m), axes=("inner", "embed")),
    }


def _per_row_column(v):
    """A host int as it is, a 0-d or (B,) tensor as a (1 or B, 1) int64
    column: either broadcasts against a row of positions."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64).reshape(-1, 1)
    return v


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: torch.Tensor | None = None,
                  valid_len: int | torch.Tensor | None = None,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x (B,S,C), w (W,C).  state (B,W-1,C) holds
    the trailing context from previous steps.  Returns (y, new_state).

    ``valid_len`` (a host int, or a 0-d or (B,) device scalar that is
    never read on the host): only the first ``valid_len`` tokens of ``x``
    are real, and the returned state is the trailing context as of the
    last of them, so bucket padding never leaks into later chunks or
    decode steps.  (Conv outputs at padded positions are garbage; callers
    discard them.)"""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)          # (B,S+W-1,C)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
            for i in range(width))
    y = y + b.to(x.dtype)
    if width <= 1:
        new_state = state
    elif valid_len is None:
        new_state = xp[:, -(width - 1):, :]
    else:
        # xp index of real token i is (W-1)+i, so the W-1 entries that
        # precede real position valid_len start at xp index valid_len
        idx = (_per_row_column(valid_len)
               + torch.arange(width - 1, device=x.device))
        idx = idx.expand(x.shape[0], width - 1)[..., None]
        new_state = xp.gather(1, idx.expand(-1, -1, xp.shape[2]))
    return y, new_state


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD update.  state (B,H,P,N); x (B,H,P); dt (B,H);
    b,c (B,H,N).  -> (y (B,H,P), new_state fp32)."""
    sf = state.float()
    da = torch.exp(dt.float() * a)                         # (B,H)
    upd = dt.float()[..., None, None] * x.float()[..., None] * \
        b[:, :, None, :]
    new_state = da[..., None, None] * sf + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, c.float())
    return y.to(x.dtype), new_state


def _split_proj(zxbcdt: torch.Tensor, ssm: SSMConfig):
    di, g, n = ssm.d_inner, ssm.num_groups, ssm.state_dim
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n:]
    return z, xbc, dt


def _expand_groups(t: torch.Tensor, nh: int) -> torch.Tensor:
    """(B,S,G,N) -> (B,S,H,N) by repeating each group H/G times (head h
    reads group h // (H/G)); a broadcast and a copy, no host-side count."""
    b, s, g, n = t.shape
    rep = nh // g
    if rep == 1:
        return t
    return t[:, :, :, None, :].expand(b, s, g, rep, n).reshape(b, s, nh, n)


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(v, 0)``): max(v, 0) +
    log1p(exp(-|v|)), with no threshold."""
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-v.abs()))


def _write_state(dst: torch.Tensor, new: torch.Tensor,
                 live: torch.Tensor | None) -> None:
    """Store a new recurrent state in the cache leaf in place; rows that
    are not ``live`` keep their entry bit-exact (the reference selects
    the old rows back, ``Model.select_cache_rows``)."""
    new = new.to(dst.dtype)
    if live is not None:
        new = torch.where(live.reshape(-1, *([1] * (dst.ndim - 1))), new,
                          dst)
    dst.copy_(new)


def mamba2_block(params: dict, x: torch.Tensor, *, cfg: ModelConfig,
                 cache: dict | None = None,
                 valid_len: int | torch.Tensor | None = None,
                 live: torch.Tensor | None = None,
                 use_kernel_hook: bool = True) -> torch.Tensor:
    """Full Mamba-2 mixer.  cache = {"conv": (B,W-1,C), "ssd":
    (B,H,P,N)}, updated in place (rows where ``live`` is False keep
    theirs).

    ``valid_len`` (chunked-prefill padding: a host int, or a 0-d or (B,)
    device scalar that is never read on the host): the tokens past it get
    dt = 0, which makes them exact no-ops for the SSD state (decay
    exp(0*a) = 1, input contribution 0), and the conv state is taken as of
    the last real token."""
    ssm = cfg.ssm
    bsz, s, _ = x.shape
    di, g, n, nh, p = (ssm.d_inner, ssm.num_groups, ssm.state_dim,
                       ssm.num_heads, ssm.head_dim)
    zxbcdt = torch.einsum("bsm,md->bsd", x, params["in_proj"].to(x.dtype))
    z, xbc, dt = _split_proj(zxbcdt, ssm)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = causal_conv1d(xbc, params["conv_w"], params["conv_b"],
                                  conv_state,
                                  valid_len=(valid_len if cache is not None
                                             else None))
    xbc = F.silu(xbc.float()).to(x.dtype)
    x_ssm = xbc[..., :di].reshape(bsz, s, nh, p)
    # B and C per group (B,S,G,N): the scan reads group h // (H/G) itself
    b_mat = xbc[..., di:di + g * n].reshape(bsz, s, g, n)
    c_mat = xbc[..., di + g * n:].reshape(bsz, s, g, n)
    dtv = _softplus(dt.float() + params["dt_bias"])
    if valid_len is not None:
        real = torch.arange(s, device=x.device) < _per_row_column(valid_len)
        dtv = torch.where(real[..., None], dtv, 0.0)
    a = -torch.exp(params["A_log"])

    if cache is not None and s == 1:
        y1, new_ssd = ssd_decode_step(
            cache["ssd"], x_ssm[:, 0], dtv[:, 0], a,
            _expand_groups(b_mat, nh)[:, 0].float(),
            _expand_groups(c_mat, nh)[:, 0].float())
        y = y1[:, None]
    else:
        fn = dispatch.get_ssd() if use_kernel_hook else ssd_ref
        init = cache["ssd"] if cache is not None else None
        # the kernel takes contiguous tensors: x, B and C are views into
        # the conv output
        y, new_ssd = fn(x_ssm.contiguous(), dtv, a, b_mat.contiguous(),
                        c_mat.contiguous(), chunk_size=ssm.chunk_size,
                        initial_state=init)
    y = y + (params["D"][:, None] * x_ssm.float()).to(y.dtype)
    y = y.reshape(bsz, s, di)
    # gated RMSNorm then out-projection
    y = y * F.silu(z.float()).to(y.dtype)
    y = apply_norm(params["norm"], y, cfg.norm_type)
    out = torch.einsum("bsd,dm->bsm", y, params["out_proj"].to(x.dtype))
    if cache is not None:
        _write_state(cache["conv"], new_conv, live)
        _write_state(cache["ssd"], new_ssd, live)
    return out
