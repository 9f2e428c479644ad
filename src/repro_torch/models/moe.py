"""Mixture-of-Experts layer of the PyTorch port: GShard-style top-k routing
with capacity (``repro.models.moe``).

Token-dropping dispatch/combine formulation, as the reference computes it:
tokens are flattened into routing groups of ``sg`` tokens (the largest
divisor of B*S that is <= 512); each expert accepts ``C = ceil(sg * k *
capacity_factor / E)`` tokens per group, given slots in token-major, then
k order; a token whose slot index reaches C is dropped for that expert.
``C`` comes from static shapes on the host, so a captured call needs no
sync.  The routing group is the whole batch of the call: a decode or
verify pass routes every row, live or not, and a chunk routes its pad
tokens after its real ones, so a token's output depends on the tokens
beside it (and on the chunk schedule) whenever capacity binds.

The expert products run over all E experts with C rows each
(``torch.einsum``), reading every expert's weights on every call, as the
reference's do.  Shared experts (DeepSeek-V2) run in the model's block,
through ``layers.apply_mlp``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.dist.placement import hint
from repro_torch.models.params import ParamSpec


def expert_specs(cfg: ModelConfig, moe: MoEConfig) -> dict:
    m, f, e = cfg.d_model, moe.expert_d_ff, moe.num_experts
    return {
        "router": ParamSpec((m, e), torch.float32, ("embed", None)),
        "w_gate": ParamSpec((e, m, f), axes=("expert", "embed", "mlp")),
        "w_up": ParamSpec((e, m, f), axes=("expert", "embed", "mlp")),
        "w_down": ParamSpec((e, f, m), axes=("expert", "mlp", "embed")),
    }


def routing_group_size(total_tokens: int, target: int = 512) -> int:
    """Largest divisor of total_tokens that is <= target."""
    best = 1
    for g in range(1, min(target, total_tokens) + 1):
        if total_tokens % g == 0:
            best = g
    return best


def ordered_top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest entries of the last axis and their indices, equal
    entries in index order (``jax.lax.top_k``'s order; ``torch.topk``
    promises none on CUDA): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def expert_capacity(group: int, moe: MoEConfig) -> int:
    """Slots per expert and routing group (a host int)."""
    return max(1, int(math.ceil(group * moe.top_k * moe.capacity_factor
                                / moe.num_experts)))


def capacity_slots(pos: torch.Tensor, cap: int) -> torch.Tensor:
    """(..., cap) float one-hot of each slot index ``pos`` (float, exact
    integers).  An index >= cap matches no slot, so its row is all zero:
    that is how a token is dropped (the reference's ``one_hot`` of an
    out-of-range index; ``torch.nn.functional.one_hot`` would raise)."""
    slots = torch.arange(cap, dtype=pos.dtype, device=pos.device)
    return (pos[..., None] == slots).float()


def route_tokens(params: dict, xg: torch.Tensor, moe: MoEConfig):
    """Routing of ``xg`` (G, Sg, M) in fp32 -> (probs (G,Sg,E), one-hot
    choices (G,Sg,k,E), dispatch (G,Sg,E,C), combine (G,Sg,E,C)): top-k
    renormalised with a 1e-9 floor, slots token-major then k (an
    exclusive cumulative count per expert)."""
    g, sg, _ = xg.shape
    e, k = moe.num_experts, moe.top_k
    logits = torch.einsum("gsm,me->gse", xg.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)                      # (G,Sg,E)
    gate_vals, gate_idx = ordered_top_k(probs, k)              # (G,Sg,k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    cap = expert_capacity(sg, moe)
    experts = torch.arange(e, device=xg.device)
    onehot = (gate_idx[..., None] == experts).float()          # (G,Sg,k,E)
    flat = onehot.reshape(g, sg * k, e)
    pos = torch.cumsum(flat, dim=1) - flat                     # exclusive
    slot = capacity_slots(pos, cap) * flat[..., None]          # (G,Sg*k,E,C)
    slot = slot.reshape(g, sg, k, e, cap)
    dispatch = slot.sum(dim=2)                                 # (G,Sg,E,C)
    combine = (slot * gate_vals[..., None, None]).sum(dim=2)
    return probs, onehot, dispatch, combine


def capacity_moe(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 moe: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (output (B,S,M), aux load-balance loss scalar fp32)."""
    b, s, m = x.shape
    e, k = moe.num_experts, moe.top_k
    total = b * s
    sg = routing_group_size(total)
    xg = x.reshape(total // sg, sg, m)
    xg = hint(xg, ("groups", None, "embed"))
    probs, onehot, dispatch, combine = route_tokens(params, xg, moe)

    # --- expert compute ------------------------------------------------------
    dsp = dispatch.to(x.dtype)
    expert_in = torch.einsum("gsec,gsm->egcm", dsp, xg)         # (E,G,C,M)
    expert_in = hint(expert_in, ("expert", "groups", None, "embed"))
    gate_h = torch.einsum("egcm,emf->egcf", expert_in,
                          params["w_gate"].to(x.dtype))
    up_h = torch.einsum("egcm,emf->egcf", expert_in,
                        params["w_up"].to(x.dtype))
    if cfg.activation != "geglu":
        act = F.silu(gate_h.float())
    else:
        act = F.gelu(gate_h.float(), approximate="tanh")
    h = act.to(x.dtype) * up_h
    expert_out = torch.einsum("egcf,efm->egcm", h,
                              params["w_down"].to(x.dtype))
    expert_out = hint(expert_out, ("expert", "groups", None, "embed"))
    out = torch.einsum("gsec,egcm->gsm", combine.to(x.dtype), expert_out)

    # --- load-balance auxiliary loss (switch-style) --------------------------
    frac = onehot.sum(dim=2).mean(dim=(0, 1)) / k              # (E,)
    mean_prob = probs.mean(dim=(0, 1))                         # (E,)
    aux = e * (frac * mean_prob).sum()

    return out.reshape(b, s, m), aux.float()


# The reference's names, bound without a second ``def``: the repository's
# static analyzer resolves the reference's ``from repro.models import moe``
# calls by the function name being unique in the corpus.
moe_specs = expert_specs
_group_size = routing_group_size
apply_moe = capacity_moe
