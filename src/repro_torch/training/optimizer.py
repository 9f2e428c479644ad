"""Optimizers (AdamW, Adafactor) and learning-rate schedules (cosine,
WSD, constant) of the port (``repro.training.optimizer``).

State trees mirror the parameter tree (nested dicts keyed by the
parameter paths): AdamW keeps ``mu``, ``nu`` and the fp32 ``master``;
Adafactor keeps the fp32 ``master`` and, per leaf, a factored second
moment (``vr`` over rows, ``vc`` over columns) where both trailing dims
are at least ``min_dim_factored``, else a full ``v``.  The arithmetic is
the reference's, op for op, in fp32, and so is its choice of what decays:
every leaf with two or more dims.

The updates run in place on the state's tensors, leaf by leaf (the
reference's step donates its state), each op rounding as the
reference's does (``mu.mul_(b1).add_((1 - b1) * g)`` is ``b1 * mu + (1 -
b1) * g``): at gemma-2b's width the fp32 master and both moments are 10
GB each, and a second copy of them would not fit beside the step's
gradients on an 80 GB card.  Call them without
grad (the train step does).  The schedule and every metric stay on the
device: nothing here reads a value on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.models.params import tree_leaves_with_path, \
    tree_map_with_path

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TorchOptimizerConfig:
    name: str = "adamw"             # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    min_dim_factored: int = 128
    # schedule
    schedule: str = "cosine"        # cosine | wsd | constant
    warmup_steps: int = 100
    total_steps: int = 10000
    stable_fraction: float = 0.8    # WSD: fraction of steps at peak LR
    min_lr_ratio: float = 0.1


# the class has its own name and the reference's name is an alias, as
# ``TorchModel`` / ``Model`` (the repository's static analyzer keys
# classes by bare name)
OptimizerConfig = TorchOptimizerConfig


# --------------------------------------------------------------------------
# LR schedules
# --------------------------------------------------------------------------
def lr_schedule(cfg: OptimizerConfig) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """step (an int or a 0-d tensor) -> the learning rate, a 0-d fp32
    tensor on the step's device."""
    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        if cfg.warmup_steps > 0:
            warm = torch.clamp((step + 1.0) / cfg.warmup_steps, max=1.0)
        else:
            warm = torch.ones_like(step)
        if cfg.schedule == "constant":
            return cfg.lr * warm
        if cfg.schedule == "wsd":
            # MiniCPM warmup-stable-decay: warmup, a long stable plateau,
            # then a linear decay to min_lr
            stable_end = cfg.total_steps * cfg.stable_fraction
            decay_span = max(cfg.total_steps - stable_end, 1.0)
            frac = torch.clamp((step - stable_end) / decay_span, 0.0, 1.0)
            decay = 1.0 - (1.0 - cfg.min_lr_ratio) * frac
            return cfg.lr * warm * decay
        # cosine
        prog = torch.clamp(
            (step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return cfg.lr * warm * (cfg.min_lr_ratio
                                + (1 - cfg.min_lr_ratio) * cos)
    return fn


# --------------------------------------------------------------------------
# Gradient utilities
# --------------------------------------------------------------------------
def _leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def grad_global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the summed squares of every leaf, in fp32, leaves in path
    order."""
    total = 0
    for leaf in _leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


def clip_grads_by_norm(tree: PyTree, max_norm: float
                       ) -> tuple[PyTree, torch.Tensor]:
    """Scale every leaf, in place, by ``min(1, max_norm / norm)``;
    -> (the tree, the norm before clipping)."""
    norm = grad_global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in _leaves(tree):
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return tree, norm


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
def adamw_state(params: PyTree) -> dict:
    def zeros(_, p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"mu": tree_map_with_path(zeros, params),
            "nu": tree_map_with_path(zeros, params),
            "master": tree_map_with_path(
                lambda _, p: p.detach().to(torch.float32, copy=True),
                params)}


def adamw_step(cfg: OptimizerConfig, grads, state, step) -> dict:
    lr = lr_schedule(cfg)(step)
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    mus, nus = _leaves(state["mu"]), _leaves(state["nu"])
    for g, mu, nu, master in zip(_leaves(grads), mus, nus,
                                 _leaves(state["master"])):
        g = g.float()
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        update = (mu / bc1).div_(torch.sqrt(nu / bc2).add_(cfg.eps))
        if master.ndim >= 2:          # decay matrices only
            update.add_(cfg.weight_decay * master)
        master.sub_(update.mul_(lr))
    return state


# --------------------------------------------------------------------------
# Adafactor (factored second moment; fp32 master, no first moment)
# --------------------------------------------------------------------------
def is_factored(shape, min_dim: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and \
        shape[-2] >= min_dim


def adafactor_state(params: PyTree, cfg: OptimizerConfig) -> dict:
    def stat(_, p):
        shape, dev = tuple(p.shape), p.device
        if is_factored(shape, cfg.min_dim_factored):
            return {"vr": torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=dev),
                    "vc": torch.zeros(shape[:-2] + shape[-1:],
                                      dtype=torch.float32, device=dev)}
        return {"v": torch.zeros(shape, dtype=torch.float32, device=dev)}
    return {"stats": tree_map_with_path(stat, params),
            "master": tree_map_with_path(
                lambda _, p: p.detach().to(torch.float32, copy=True),
                params)}


def adafactor_step(cfg: OptimizerConfig, grads, state, step) -> dict:
    lr = lr_schedule(cfg)(step)
    t = (step + 1).to(torch.float32)
    beta2 = 1.0 - torch.pow(t, -cfg.decay_rate)
    masters = dict(tree_leaves_with_path(state["master"]))
    for path, g in tree_leaves_with_path(grads):
        master = masters[path]
        st = state["stats"]
        for key in path:
            st = st[key]
        g = g.float()
        g2 = torch.square(g) + 1e-30
        if "vr" in st:
            vr, vc = st["vr"], st["vc"]
            vr.mul_(beta2).add_((1 - beta2) * torch.mean(g2, dim=-1))
            vc.mul_(beta2).add_((1 - beta2) * torch.mean(g2, dim=-2))
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                min=1e-30)
            v_est = (vr[..., None] / denom[..., None]) * vc[..., None, :]
        else:
            v = st["v"]
            v.mul_(beta2).add_((1 - beta2) * g2)
            v_est = v
        update = g * torch.rsqrt(v_est + 1e-30)
        # update clipping (RMS <= 1), standard adafactor
        rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-30)
        update.div_(torch.clamp(rms, min=1.0))
        if master.ndim >= 2:
            # out of place, as the reference writes it: on a sharded leaf
            # the update may be a partial sum that DTensor cannot add a
            # shard to in place
            update = update + cfg.weight_decay * master
        master.sub_(update.mul_(lr))
    return state


# --------------------------------------------------------------------------
# Unified interface
# --------------------------------------------------------------------------
def make_opt_state(cfg: OptimizerConfig, params: PyTree) -> dict:
    if cfg.name == "adafactor":
        return adafactor_state(params, cfg)
    return adamw_state(params)


def optimizer_update(cfg: OptimizerConfig, grads: PyTree, state: dict,
                     step: torch.Tensor) -> tuple[dict, dict]:
    """Clip the grads (in place), update the state in place; -> (state,
    {"grad_norm", "lr"} as 0-d device tensors).  The fp32 master inside
    the state is the single source of truth; callers cast it to the
    model's dtypes."""
    grads, gnorm = clip_grads_by_norm(grads, cfg.grad_clip)
    if cfg.name == "adafactor":
        state = adafactor_step(cfg, grads, state, step)
    else:
        state = adamw_step(cfg, grads, state, step)
    return state, {"grad_norm": gnorm, "lr": lr_schedule(cfg)(step)}


# the reference's names, bound without a second ``def``: the repository's
# static analyzer resolves the reference's calls of them by the function
# name being unique in the corpus
schedule_fn = lr_schedule
global_norm = grad_global_norm
clip_by_global_norm = clip_grads_by_norm
adamw_init = adamw_state
adamw_update = adamw_step
_factored = is_factored
adafactor_init = adafactor_state
adafactor_update = adafactor_step
init_opt_state = make_opt_state
apply_updates = optimizer_update
