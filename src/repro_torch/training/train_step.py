"""Train step of the port (``repro.training.train_step``): gradient
accumulation over microbatches, remat, mixed precision with an fp32
master as the only copy of the weights.

The optimizer's fp32 master leaves require grad.  The step casts them to
the specs' dtypes (bf16 weights, fp32 norms) for each microbatch's
forward and backward; backprop runs in bf16 through the port's kernels
(B1's custom op, B2's autograd function), and the cast's backward gives
fp32 grads, which accumulate on the master leaves' ``.grad`` over the
``accum_steps`` microbatches (in ``accum_dtype``: float32 adds in place,
bfloat16 keeps a bf16 sum as the reference's scan does).  The state is
updated in place and returned (the reference donates it).  Metrics stay
on the device: the step reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.model import Model
from repro_torch.models.params import tree_leaves_with_path, \
    tree_map_with_path
from repro_torch.training.optimizer import OptimizerConfig, \
    make_opt_state, optimizer_update

PyTree = Any

ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TorchTrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    accum_steps: int = 1              # microbatches per step
    remat: str = "full"               # none | full | dots
    accum_dtype: str = "float32"      # float32 | bfloat16
    # int8 gradient compression with error feedback: models a compressed
    # cross-replica gradient exchange (per-tensor absmax scale, residual
    # carried in the state so quantization error re-enters the next step)
    grad_compression: str = "none"    # none | int8


TrainConfig = TorchTrainConfig


def make_train_state(model: Model, generator: torch.Generator,
                     cfg: TrainConfig, device) -> dict:
    """Weights drawn from ``generator`` (which lives on ``device``), then
    the optimizer's state around their fp32 master, whose leaves require
    grad; ``step`` 0 (int32) and, under int8 compression, a zero
    error-feedback residual per leaf."""
    opt = make_opt_state(cfg.optimizer, model.init(generator, device))
    for _, leaf in tree_leaves_with_path(opt["master"]):
        leaf.requires_grad_(True)
    state = {"opt": opt,
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.grad_compression == "int8":
        state["ef"] = tree_map_with_path(
            lambda _, m: torch.zeros_like(m, requires_grad=False),
            opt["master"])
    return state


def meta_train_state(model: Model, cfg: TrainConfig) -> dict:
    """The train state as meta tensors (shapes and dtypes, no storage)
    for the dry-run: the optimizer state around the fp32 master, and
    ``step``; no error-feedback residual."""
    return {"opt": make_opt_state(cfg.optimizer, model.abstract()),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def compress_int8(g: torch.Tensor, residual: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 quantization of one gradient tensor:
    -> (dequantized gradient, new residual)."""
    gf = g.float() + residual
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, gf - deq


def cast_to_specs(master: PyTree, specs: PyTree) -> PyTree:
    """fp32 master -> model-dtype params (bf16 weights, fp32 norms); under
    grad the cast's backward carries each grad back to fp32."""
    return tree_map_with_path(lambda _, m, sp: m.to(sp.dtype), master,
                              specs)


def params_from_state(state: dict, model: Model) -> PyTree:
    """The model-dtype params of a train state, detached."""
    with torch.no_grad():
        return cast_to_specs(state["opt"]["master"], model.param_specs())


def split_microbatches(batch: dict, n: int) -> list[dict]:
    """(B, ...) -> n microbatches of (B/n, ...), rows in order, on every
    leaf with a leading batch dim; M-RoPE ``positions`` (3, B, S) split
    on axis 1."""
    def part(name, x, i):
        if name == "positions" and x.ndim == 3:
            b = x.shape[1] // n
            return x[:, i * b:(i + 1) * b]
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]
    return [{k: part(k, v, i) for k, v in batch.items()} for i in range(n)]


def _grad_or_zeros(leaf: torch.Tensor) -> torch.Tensor:
    """A master leaf's gradient; zeros for a leaf the loss does not read
    (a frontend config's token embedding when it takes embeddings and
    unembeds through its own matrix), as the reference's ``jax.grad``
    gives."""
    return leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)


def build_train_step(model: Model, cfg: TrainConfig):
    """Returns ``step(state, batch) -> (state, metrics)``: ``metrics``
    holds ``loss``, ``grad_norm`` and ``lr``, 0-d device tensors."""
    specs = model.param_specs()
    accum_dtype = ACCUM_DTYPES[cfg.accum_dtype]
    n = cfg.accum_steps

    def step(state, batch):
        master = state["opt"]["master"]
        leaves = dict(tree_leaves_with_path(master))
        for leaf in leaves.values():
            leaf.grad = None
        mbs = split_microbatches(batch, n) if n > 1 else [batch]
        sums = None
        lsum = None
        for mb in mbs:
            loss, _ = model.loss(cast_to_specs(master, specs), mb,
                                 remat=cfg.remat)
            loss.backward()
            loss = loss.detach()
            lsum = loss if lsum is None else lsum + loss
            if n > 1 and accum_dtype != torch.float32:
                # a sum in the accumulator's dtype, as the reference's
                # scan keeps it; the fp32 .grad is taken off each time
                parts = {p: _grad_or_zeros(leaf).to(accum_dtype)
                         for p, leaf in leaves.items()}
                sums = parts if sums is None else {
                    p: sums[p] + g for p, g in parts.items()}
                for leaf in leaves.values():
                    leaf.grad = None
        with torch.no_grad():
            grads = sums if sums is not None else \
                {p: _grad_or_zeros(leaf) for p, leaf in leaves.items()}
            for leaf in leaves.values():
                leaf.grad = None
            if n > 1:
                grads = {p: g.div_(n) for p, g in grads.items()}
                loss = lsum / n
            new_state = {}
            if cfg.grad_compression == "int8":
                ef = dict(tree_leaves_with_path(state["ef"]))
                pairs = {p: compress_int8(g, ef[p]) for p, g in grads.items()}
                grads = {p: d for p, (d, _) in pairs.items()}
                new_state["ef"] = tree_map_with_path(
                    lambda p, _: pairs[p][1], master)
            opt, om = optimizer_update(
                cfg.optimizer, tree_map_with_path(lambda p, _: grads[p],
                                                  master),
                state["opt"], state["step"])
            new_state.update(opt=opt, step=state["step"] + 1)
        return new_state, {"loss": loss, **om}

    return step


# the reference's names, bound without a second ``def``: the repository's
# static analyzer resolves the reference's calls of them by the function
# name being unique in the corpus
init_train_state = make_train_state
abstract_train_state = meta_train_state
_compress_int8 = compress_int8
cast_params = cast_to_specs
params_of = params_from_state
_split_microbatches = split_microbatches
make_train_step = build_train_step
