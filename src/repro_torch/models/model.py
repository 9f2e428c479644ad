"""Model assembly of the PyTorch port, dense, ssm, hybrid and moe
families, and the vlm and audio backbones, planned as dense blocks
(``repro.models.model``).

Parameters and caches keep the reference's layer plan and its stacked
leading ``"layers"`` axis (``blocks/dense/...``, ``blocks/ssm/...``; the
hybrid's ``blocks/rec_0``, ``blocks/rec_1``, ``blocks/attn_local_2``
stacked over its groups, then the unstacked ``epi_0``, ``epi_1``;
deepseek's unstacked dense ``pro_0`` before the stacked
``blocks/moe_ds``; arctic's stacked ``blocks/moe_arctic``), so their
path strings and shapes line up with the JAX trees; the layers run as
a Python loop over views of the stacked tensors.  Caches are updated
in place: the decode entry points return the cache they were given, and
a fused decode quantum masks the cache write of every row past its step
budget (KV rows, conv, SSD and RG-LRU state, ring slots) instead of
reverting it afterwards as the reference's ``select_cache_rows`` does.

A paged cache (``init_paged_cache``) keeps the linear KV leaves as
physical page pools addressed through a per-slot ``"page_table"`` that
rides inside the cache dict; decode steps and quanta read and write
through it.

Inputs dict: ``{"tokens": (B,S) int}`` or ``{"embeds": (B,S,M)}`` (the
vlm and audio frontends' patch or frame embeddings), with optional
``"positions"`` (B,S), or (3,B,S) for M-RoPE; decode inputs
``{"tokens": (B,)}`` or ``{"embeds": (B,M)}`` with a position ``t`` — a
Python int (all rows aligned) or a (B,) tensor of per-row positions
(continuous batching).  A sinusoidal config adds its position encoding
to either input.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, \
    create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.placement import hint
from repro_torch.models import layers as L
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.params import ParamSpec, init_params, \
    meta_params, tree_leaves_with_path, tree_map_with_path

PyTree = Any


def cache_batch_axis(path: tuple[str, ...]) -> int:
    """Batch axis of a cache leaf: stacked block caches carry a leading
    layer axis, so batch is axis 1 under ``blocks`` and 0 elsewhere."""
    return 1 if "blocks" in path else 0


def stack_specs(tree: PyTree, n: int) -> PyTree:
    return tree_map_with_path(
        lambda _, s: ParamSpec((n,) + s.shape, s.dtype, ("layers",) + s.axes,
                               init=s.init, init_scale=s.init_scale), tree)


# the families the port serves
FAMILIES = ("dense", "ssm", "hybrid", "moe", "vlm", "audio")


@dataclasses.dataclass
class TorchLayerPlan:
    """How cfg.num_layers decomposes into scanned stacks / unrolled layers
    (the reference's ``LayerPlan``; the port runs every stack as a loop,
    but the layer profiles read the decomposition)."""
    prologue: tuple[str, ...]          # unrolled kinds before the scan
    scan_kinds: tuple[str, ...]        # kinds inside one scanned group
    n_groups: int
    epilogue: tuple[str, ...]          # unrolled kinds after the scan


LayerPlan = TorchLayerPlan


def plan_layers(cfg: ModelConfig) -> LayerPlan:
    """The reference's ``make_plan`` for the families the port serves:
    ssm stacks ``cfg.num_layers`` ``"ssm"`` blocks, and dense, vlm and
    audio as many ``"dense"`` blocks (the frontends feed a dense
    backbone);
    the hybrid repeats its block pattern (``"rec"`` or ``"attn_local"``)
    and unrolls the remainder after the groups; a moe config unrolls its
    first dense layers (``"ds_dense0"``: MLA and a dense MLP) before a
    stack of its MoE kind: ``"moe_arctic"`` (standard attention, a dense
    residual MLP beside the routed experts) when ``dense_residual`` is
    set, else ``"moe_ds"`` (MLA, routed and shared experts)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the port serves the {FAMILIES} families only "
            f"(got {cfg.family!r})")
    if cfg.family == "moe":
        kind = "moe_arctic" if cfg.moe.dense_residual else "moe_ds"
        n = cfg.first_dense_layers
        return LayerPlan(("ds_dense0",) * n, (kind,),
                         cfg.num_layers - n, ())
    if cfg.family == "hybrid":
        pat = tuple("rec" if p == "rec" else "attn_local"
                    for p in cfg.rglru.block_pattern)
        n_groups = cfg.num_layers // len(pat)
        rem = cfg.num_layers - n_groups * len(pat)
        return LayerPlan((), pat, n_groups, pat[:rem])
    if cfg.family == "ssm":
        return LayerPlan((), ("ssm",), cfg.num_layers, ())
    return LayerPlan((), ("dense",), cfg.num_layers, ())


# the reference's name, bound without a second ``def``: the repository's
# static analyzer resolves the reference's ``from repro.models.model import
# make_plan`` by the function name being unique
make_plan = plan_layers


def _kind_specs(cfg: ModelConfig, kind: str) -> dict:
    """One block's parameters (the reference's ``_block_specs``)."""
    if kind == "ssm":
        return {"ln1": L.norm_specs(cfg),
                "mixer": ssm_mod.ssm_specs(cfg, cfg.ssm)}
    if kind == "rec":
        return {"ln1": L.norm_specs(cfg),
                "mixer": rg_mod.rglru_specs(cfg, cfg.rglru),
                "ln2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
    if kind in ("dense", "attn_local"):
        return {"ln1": L.norm_specs(cfg), "attn": L.attention_specs(cfg),
                "ln2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
    if kind == "ds_dense0":
        return {"ln1": L.norm_specs(cfg),
                "attn": mla_mod.latent_attention_params(cfg, cfg.mla),
                "ln2": L.norm_specs(cfg),
                "mlp": L.mlp_specs(cfg, cfg.first_dense_d_ff)}
    if kind == "moe_arctic":
        return {"ln1": L.norm_specs(cfg), "attn": L.attention_specs(cfg),
                "ln2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg),
                "moe": moe_mod.expert_specs(cfg, cfg.moe)}
    if kind == "moe_ds":
        s = {"ln1": L.norm_specs(cfg),
             "attn": mla_mod.latent_attention_params(cfg, cfg.mla),
             "ln2": L.norm_specs(cfg),
             "moe": moe_mod.expert_specs(cfg, cfg.moe)}
        if cfg.moe.num_shared_experts:
            s["shared"] = L.mlp_specs(cfg, cfg.moe.shared_d_ff)
        return s
    raise ValueError(kind)


def _kv_specs(cfg: ModelConfig, batch: int, t_max: int) -> dict:
    k, d = cfg.num_kv_heads, cfg.head_dim
    return {"k": ParamSpec((batch, t_max, k, d), cfg.cache_dtype(),
                           ("batch", "seq", "kv_heads", "head_dim"),
                           init="zeros"),
            "v": ParamSpec((batch, t_max, k, d), cfg.cache_dtype(),
                           ("batch", "seq", "kv_heads", "head_dim"),
                           init="zeros")}


def _ssm_state_specs(cfg: ModelConfig, batch: int) -> dict:
    ssm = cfg.ssm
    conv_ch = ssm.d_inner + 2 * ssm.num_groups * ssm.state_dim
    return {"conv": ParamSpec((batch, ssm.conv_width - 1, conv_ch),
                              cfg.cache_dtype(), ("batch", None, "inner"),
                              init="zeros"),
            "ssd": ParamSpec((batch, ssm.num_heads, ssm.head_dim,
                              ssm.state_dim), torch.float32,
                             ("batch", "inner", None, "state"),
                             init="zeros")}


def _rec_state_specs(cfg: ModelConfig, batch: int) -> dict:
    rg = cfg.rglru
    return {"h": ParamSpec((batch, rg.lru_width), torch.float32,
                           ("batch", "inner"), init="zeros"),
            "conv": ParamSpec((batch, rg.conv_width - 1, rg.lru_width),
                              cfg.cache_dtype(), ("batch", None, "inner"),
                              init="zeros")}


def _kind_cache_leaves(cfg: ModelConfig, kind: str, batch: int,
                      t_max: int) -> dict:
    """One block's cache (the reference's ``_block_cache_specs``)."""
    if kind in ("dense", "moe_arctic"):
        return _kv_specs(cfg, batch, t_max)
    if kind == "ssm":
        return _ssm_state_specs(cfg, batch)
    if kind == "rec":
        return _rec_state_specs(cfg, batch)
    if kind == "attn_local":
        return rg_mod.ring_specs(cfg, batch)
    if kind in ("ds_dense0", "moe_ds"):
        return mla_mod.latent_leaves(cfg, batch, t_max)
    raise ValueError(kind)


def _plan_tree(plan: LayerPlan, one) -> dict:
    """A tree in the reference's layout: ``one(kind)`` per block, the
    prologue as ``pro_i``, the scanned group stacked under ``blocks``
    (keyed by kind, or ``kind_j`` when the group holds several), the
    epilogue as ``epi_i``."""
    out: dict = {f"pro_{i}": one(kind)
                 for i, kind in enumerate(plan.prologue)}
    if plan.n_groups:
        out["blocks"] = stack_specs(
            {_group_key(plan, j): one(k)
             for j, k in enumerate(plan.scan_kinds)}, plan.n_groups)
    for i, kind in enumerate(plan.epilogue):
        out[f"epi_{i}"] = one(kind)
    return out


def _group_key(plan: LayerPlan, j: int) -> str:
    kind = plan.scan_kinds[j]
    return kind if len(plan.scan_kinds) == 1 else f"{kind}_{j}"


def _layer(tree: PyTree, i: int) -> PyTree:
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return tree_map_with_path(lambda _, a: a[i], tree)


def _unstack(tree: PyTree, n: int) -> list:
    """The ``n`` layers of a stacked tree as views, each leaf unbound
    once.  Under autograd a select per layer gives each layer's backward a
    zero tensor the size of the whole stack (for gemma-2b's MLP stacks,
    1.2 GB each); the unbind's backward stacks the layers' grads once."""
    parts = tree_map_with_path(lambda _, a: a.unbind(0), tree)
    return [tree_map_with_path(lambda _, t: t[i], parts) for i in range(n)]


REMATS = ("none", "full", "dots")


def _saves_product(ctx, func, *args, **kwargs):
    """The ``"dots"`` remat policy: keep what a weight product gives (B1,
    and a plain product with no batch dims: ``mm``, or the ``bmm`` of
    batch 1 that ``einsum`` makes of one), recompute the rest, as the
    reference's ``checkpoint_dots_with_no_batch_dims`` does."""
    if func in (torch.ops.repro_torch.block_matmul.default,
                torch.ops.aten.mm.default) or (
            func is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(fn, remat: str):
    """``fn`` recomputed in the backward (``torch.utils.checkpoint``, not
    reentrant): all of it under ``"full"``, all but the weight products
    under ``"dots"``."""
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _saves_product)
    return lambda x: checkpoint(fn, x, use_reentrant=False, **kw)


def _blank_leaf(path: tuple[str, ...], spec: ParamSpec, device):
    """A fresh cache leaf: zeros, except a ring's ``pos``, which starts at
    -1 (never written: a 0 would be a visible key at position 0)."""
    if path[-1] == "pos":
        return torch.full(spec.shape, -1, dtype=spec.dtype, device=device)
    return torch.zeros(spec.shape, dtype=spec.dtype, device=device)


class TorchModel:
    """The dense decoder (``family == "dense"``, and the vlm and audio
    backbones, which take embeddings as well as tokens), the attention-free
    Mamba-2 stack (``family == "ssm"``), the RG-LRU / local-attention
    hybrid (``family == "hybrid"``) and the capacity MoE (``family ==
    "moe"``): deepseek's MLA with routed and shared experts, or arctic's
    standard attention with a dense residual MLP beside the experts."""

    def __init__(self, cfg: ModelConfig, *, use_kernels: bool = True):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the port serves the {FAMILIES} families "
                f"only (got {cfg.family!r})")
        self.cfg = cfg
        self.plan = plan_layers(cfg)
        # False runs every kernel's plain version, on any device (the
        # on-card whole-model check compares the two)
        self.use_kernels = use_kernels

    # -- parameters ------------------------------------------------------
    def param_specs(self) -> dict:
        cfg = self.cfg
        specs = {"embed": L.embed_specs(cfg)}
        specs.update(_plan_tree(self.plan, lambda k: _kind_specs(cfg, k)))
        specs["final_norm"] = L.norm_specs(cfg)
        return specs

    def init(self, generator: torch.Generator, device) -> PyTree:
        return init_params(self.param_specs(), generator, device)

    def shape_only_params(self) -> PyTree:
        """The parameter tree as meta tensors: shapes and dtypes, no
        storage (the reference's ``ShapeDtypeStruct`` tree)."""
        return meta_params(self.param_specs())

    # the reference's name, bound without a second ``def`` (see
    # ``make_plan``)
    abstract = shape_only_params

    # -- caches ------------------------------------------------------------
    # veltair: ignore[paged-leaf-coverage] the rule's anchor is the reference's Model.cache_specs, which this class cannot reach under its own name; paged_leaf_paths below derives the pageable leaves from this method, and tests/test_torch_paging.py holds them equal to the reference's
    def cache_specs(self, batch: int, t_max: int) -> dict:
        return _plan_tree(self.plan, lambda k: _kind_cache_leaves(
            self.cfg, k, batch, t_max))

    def init_cache(self, batch: int, t_max: int, device) -> PyTree:
        return tree_map_with_path(
            lambda p, s: _blank_leaf(p, s, device),
            self.cache_specs(batch, t_max))

    # -- paged caches ------------------------------------------------------
    def paged_leaf_paths(self) -> frozenset:
        """Paths of the cache leaves that page: those whose spec carries a
        ``"seq"`` axis (attention k/v, MLA latents).  Recurrent state
        (conv, SSD and RG-LRU leaves) is O(1) per slot and the hybrid's
        ring O(window): they stay dense."""
        return frozenset(path for path, spec in tree_leaves_with_path(
            self.cache_specs(1, 8)) if "seq" in spec.axes)

    def has_recurrent_leaves(self) -> bool:
        """True when a cache leaf carries recurrent state (no ``"seq"``
        axis: conv, SSD and RG-LRU leaves, the hybrid's ring): those
        leaves need the speculative verify's restore pass."""
        return not self.all_cache_leaves_paged()

    # the reference's name, bound without a second ``def`` (see
    # ``make_plan``)
    _has_nonseq_cache_leaves = has_recurrent_leaves

    def all_cache_leaves_paged(self) -> bool:
        """True when every cache leaf pages (pure-attention families).
        The paged engine takes only such families: skipping the prefill
        of a shared prefix is sound only when no dense recurrent state is
        skipped, and the engine's row scatter and gather handle pools
        only."""
        paged = self.paged_leaf_paths()
        return bool(paged) and all(
            path in paged for path, _ in tree_leaves_with_path(
                self.cache_specs(1, 8)))

    # veltair: ignore[paged-leaf-coverage] connected to this class's cache_specs, which it calls; the rule's anchor is the reference's Model.cache_specs (see cache_specs above)
    def paged_cache_specs(self, batch: int, t_max: int, n_pages: int,
                          page_size: int) -> dict:
        """Cache specs with every ``"seq"``-axis leaf reshaped from dense
        rows ``(batch, t_max, ...)`` to a physical page pool
        ``(n_pages + 1, page_size, ...)`` (index 0 = pinned trash page).
        One logical page uses the same physical index in every layer's
        pool, so one per-slot page table addresses all layers."""
        if t_max % page_size:
            raise ValueError(f"t_max={t_max} must be a multiple of "
                             f"page_size={page_size}")

        def to_pool(_, spec):
            if "seq" not in spec.axes:
                return spec
            si = spec.axes.index("seq")
            shape, axes = list(spec.shape), list(spec.axes)
            shape[si - 1], shape[si] = n_pages + 1, page_size
            axes[si - 1], axes[si] = "pages", None
            return ParamSpec(tuple(shape), spec.dtype, tuple(axes),
                             init="zeros")
        return tree_map_with_path(to_pool, self.cache_specs(batch, t_max))

    def init_paged_cache(self, batch: int, t_max: int, n_pages: int,
                         page_size: int, device) -> PyTree:
        """Paged variant of :meth:`init_cache`, plus a per-slot
        ``"page_table"`` (batch, t_max // page_size) int32 of physical
        page indices; all zeros parks every entry on the trash page.  The
        table rides inside the cache dict, so no entry point changes its
        signature."""
        cache = tree_map_with_path(
            lambda p, s: _blank_leaf(p, s, device),
            self.paged_cache_specs(batch, t_max, n_pages, page_size))
        cache["page_table"] = torch.zeros((batch, t_max // page_size),
                                          dtype=torch.int32, device=device)
        return cache

    # -- stacks ------------------------------------------------------------
    def _default_positions(self, b: int, s: int, t0, device) -> torch.Tensor:
        """Row-contiguous positions from ``t0``: an int (all rows
        aligned) or a (B,) tensor of per-row offsets; an M-RoPE config
        gets them on all three rows, (3, B, S)."""
        ar = torch.arange(s, device=device)
        if isinstance(t0, torch.Tensor):
            pos = t0.to(device=device, dtype=torch.int64)[:, None] + ar
        else:
            pos = (t0 + ar)[None, :].expand(b, s)
        if self.cfg.pos_embed == "mrope":
            pos = pos[None].expand(3, b, s)
        return pos

    def _input_activations(self, params, inputs, positions) -> torch.Tensor:
        """(B, S, M) bf16 activations: ``inputs["embeds"]`` cast to bf16,
        or the token embedding; a sinusoidal config adds its encoding of
        the positions (the w row of M-RoPE positions) in bf16."""
        cfg = self.cfg
        if "embeds" in inputs:
            x = inputs["embeds"].to(torch.bfloat16)
        else:
            x = L.embed(params["embed"], inputs["tokens"], cfg)
        if cfg.pos_embed == "sinusoidal":
            pe = L.sinusoidal_pe(
                positions if positions.ndim == 2 else positions[-1],
                cfg.d_model)
            x = x + pe.to(x.dtype)
        return x

    # the reference's name, bound without a second ``def`` (see
    # ``make_plan``)
    _embed_inputs = _input_activations

    @staticmethod
    def _batch_len(inputs) -> tuple[int, int, torch.device]:
        """(B, S, device) of a prompt's ``tokens`` (B, S) or ``embeds``
        (B, S, M)."""
        x = inputs["tokens"] if "tokens" in inputs else inputs["embeds"]
        return x.shape[0], x.shape[1], x.device

    def _prompt_positions(self, inputs, positions, t0) -> torch.Tensor:
        """``positions`` if given, else ``inputs["positions"]``, else
        row-contiguous from ``t0`` (``_default_positions``)."""
        if positions is None:
            positions = inputs.get("positions")
        if positions is None:
            b, s, device = self._batch_len(inputs)
            positions = self._default_positions(b, s, t0, device)
        return positions

    def _plan_groups(self, params, cache):
        """(scanned, [(kind, block params, block cache or None)]) in layer
        order: each prologue block alone, each group's blocks together
        (``scanned``: the unit the reference's remat wraps), then each
        epilogue block."""
        plan = self.plan
        for i, kind in enumerate(plan.prologue):
            yield False, [(kind, params[f"pro_{i}"], (
                cache[f"pro_{i}"] if cache is not None else None))]
        if plan.n_groups:
            keys = [_group_key(plan, j) for j in range(len(plan.scan_kinds))]
            stacks = {key: _unstack(params["blocks"][key], plan.n_groups)
                      for key in keys}
            for g in range(plan.n_groups):
                yield True, [(kind, stacks[key][g], (
                    _layer(cache["blocks"][key], g) if cache is not None
                    else None)) for kind, key in zip(plan.scan_kinds, keys)]
        for i, kind in enumerate(plan.epilogue):
            yield False, [(kind, params[f"epi_{i}"], (
                cache[f"epi_{i}"] if cache is not None else None))]

    def _plan_blocks(self, params, cache):
        """(kind, block params, block cache or None) in layer order: the
        prologue, each group's blocks, then the epilogue."""
        for _, blocks in self._plan_groups(params, cache):
            yield from blocks

    def _run_blocks(self, params, x, *, positions, cache, t, live=None,
                    valid_len=None, aux=None, remat="none"):
        """``valid_len`` (chunked prefill: a host int or a device scalar;
        a verify: (B,)) reaches the recurrent mixers, for which the tokens
        past it must be exact no-ops, and the hybrid's ring, which takes
        only real tokens and, given it, attends over the ring plus the
        chunk; a padded KV row needs nothing (it stays causally invisible
        until the decode step at its position overwrites it).  A cache
        that holds a ``"page_table"`` routes every layer's KV through
        it.  ``aux``, a list, receives each MoE layer's load-balance loss
        in layer order (the serving paths drop it, as the reference's
        serving does).  ``remat`` (no cache) recomputes each scanned
        group in the backward, as the reference's ``jax.checkpoint`` of
        its group function: ``"full"`` all of it, ``"dots"`` all but the
        weight products (:func:`_saves_product`)."""
        if remat not in REMATS:
            raise ValueError(f"remat {remat!r} is not one of {REMATS}")
        if remat != "none" and cache is not None:
            raise ValueError("remat applies to a forward without a cache")
        page_table = cache.get("page_table") if cache is not None else None
        for scanned, blocks in self._plan_groups(params, cache):
            def run(x, blocks=blocks):
                losses: list = []
                for kind, p, c in blocks:
                    x = self._block(kind, p, c, x, positions=positions, t=t,
                                    live=live, valid_len=valid_len,
                                    page_table=page_table, aux=losses)
                return x, losses
            if scanned and remat != "none":
                run = _checkpointed(run, remat)
            x, losses = run(x)
            if aux is not None:
                aux.extend(losses)
        return x

    def _block(self, kind, p, c, x, *, positions, t, live, valid_len,
               page_table, aux):
        """One block of the plan: the mixer, then the MLP or MoE, each
        after its norm and added to the residual stream."""
        cfg = self.cfg
        xa = L.apply_norm(p["ln1"], x, cfg.norm_type)
        if kind == "ssm":
            return x + ssm_mod.mamba2_block(
                p["mixer"], xa, cfg=cfg, cache=c, valid_len=valid_len,
                live=live, use_kernel_hook=self.use_kernels)
        if kind == "rec":
            x = x + rg_mod.recurrent_block(
                p["mixer"], xa, cfg=cfg, cache=c, valid_len=valid_len,
                live=live)
        else:
            if kind == "attn_local":
                h = self._windowed_attention(
                    p["attn"], xa, positions=positions, cache=c, t=t,
                    live=live, valid_len=valid_len)
            elif kind in ("ds_dense0", "moe_ds"):
                h = mla_mod.latent_attention(
                    p["attn"], xa, cfg=cfg, positions=positions, cache=c,
                    cache_index=t, live=live, page_table=page_table)
            else:
                h = L.attention(p["attn"], xa, cfg=cfg, positions=positions,
                                cache=c, cache_index=t, live=live,
                                page_table=page_table,
                                use_kernel_hook=self.use_kernels)
            x = hint(x + h, ("batch", "seq", "embed"))
        xm = L.apply_norm(p["ln2"], x, cfg.norm_type)
        if kind == "moe_ds":
            # every row of the call routes, live or not: the routing
            # group is the reference's
            out, a = moe_mod.capacity_moe(p["moe"], xm, cfg, cfg.moe)
            aux.append(a)
            if "shared" in p:
                out = out + L.apply_mlp(p["shared"], xm, cfg.activation,
                                        use_kernel_hook=self.use_kernels)
            return x + out
        mlp_out = L.apply_mlp(p["mlp"], xm, cfg.activation,
                              use_kernel_hook=self.use_kernels)
        if kind == "moe_arctic":
            # the dense residual beside the routed experts, added in
            # the reference's order: (x + mlp) + moe, each in bf16
            moe_out, a = moe_mod.capacity_moe(p["moe"], xm, cfg, cfg.moe)
            aux.append(a)
            return x + mlp_out + moe_out
        return x + mlp_out

    def _windowed_attention(self, params, x, *, positions, cache, t,
                            live=None, valid_len=None) -> torch.Tensor:
        """The hybrid's local-attention layer over its ring (the
        reference's ``_local_attention``): one token with a cache attends
        the ring; a chunk with a cache and a ``valid_len`` attends the
        ring plus its own real keys; otherwise (a monolithic prefill from
        position 0) the chunk attends itself through ``flash_attention``
        with the window, and the ring takes its last keys."""
        cfg = self.cfg
        window = cfg.rglru.window_size
        s = x.shape[1]
        q = torch.einsum("bsm,mhd->bshd", x, params["wq"].to(x.dtype))
        k = torch.einsum("bsm,mkd->bskd", x, params["wk"].to(x.dtype))
        v = torch.einsum("bsm,mkd->bskd", x, params["wv"].to(x.dtype))
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        if cache is not None and s == 1:
            y = rg_mod.ring_decode(q, cache, k, v, t, window, live=live)
        elif cache is not None and valid_len is not None:
            y = rg_mod.ring_chunk(q, cache, k, v, t, valid_len, window,
                                  live=live)
        else:
            y = L.attend(q.contiguous(), k.contiguous(), v.contiguous(),
                         q_positions=positions, kv_valid_len=s,
                         window=window, use_kernel_hook=self.use_kernels)
            if cache is not None:
                rg_mod.fill_ring(cache, k, v, window)
        return torch.einsum("bshd,hdm->bsm", y, params["wo"].to(x.dtype))

    def _logits(self, params, x):
        x = L.apply_norm(params["final_norm"], x, self.cfg.norm_type)
        return L.unembed(params["embed"], x, self.cfg)[:, 0]

    # -- entry points --------------------------------------------------------
    def full_logits(self, params, inputs, *, positions=None, remat="none"):
        """Full-sequence forward with no cache: ``inputs["tokens"]`` (B,
        S) or ``inputs["embeds"]`` (B, S, M), positions from
        ``positions``, ``inputs["positions"]`` or position 0 on; ``remat``
        ``"none" | "full" | "dots"`` recomputes each scanned group in the
        backward (``_run_blocks``).
        -> (logits (B, S, V) fp32, the MoE layers' summed load-balance
        loss, a 0-d fp32 tensor: 0 without MoE layers)."""
        cfg = self.cfg
        positions = self._prompt_positions(inputs, positions, 0)
        x = self._input_activations(params, inputs, positions)
        x = hint(x, ("batch", "seq", "embed"))
        losses: list = []
        x = self._run_blocks(params, x, positions=positions, cache=None,
                             t=0, aux=losses, remat=remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for a in losses:
            aux = aux + a
        x = L.apply_norm(params["final_norm"], x, cfg.norm_type)
        return L.unembed(params["embed"], x, cfg), aux

    # the reference's name, bound without a second ``def`` (see
    # ``make_plan``)
    forward = full_logits

    def training_loss(self, params, batch, *, remat="none"):
        """Next-token cross-entropy plus the MoE load-balance term,
        ``aux_loss_weight * aux / num_layers``.  ``batch`` holds
        ``tokens`` (the targets are the tokens shifted by one; a ``mask``
        (B, S) shifts with them) or inputs with ``labels`` (B, S) and an
        optional ``mask``.  -> (loss, {"ce": ..., "aux": ...}), 0-d fp32
        tensors on the device."""
        cfg = self.cfg
        logits, aux = self.full_logits(params, batch, remat=remat)
        if "labels" in batch:
            labels, mask, lg = batch["labels"], batch.get("mask"), logits
        else:
            labels, lg = batch["tokens"][:, 1:], logits[:, :-1]
            mask = batch.get("mask")
            mask = mask[:, 1:] if mask is not None else None
        ce = L.cross_entropy(lg, labels, mask)
        aux_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
        total = ce + aux_w * aux / max(cfg.num_layers, 1)
        return total, {"ce": ce, "aux": aux}

    # the reference's name, bound without a second ``def`` (see
    # ``make_plan``)
    loss = training_loss

    def prefill(self, params, inputs, cache, *, positions=None):
        """Process a prompt from position 0, filling ``cache`` in place:
        ``inputs["tokens"]`` (B, S) or ``inputs["embeds"]`` (B, S, M),
        positions from ``positions``, ``inputs["positions"]`` or
        row-contiguous from 0.  -> (last logits (B,V) fp32, cache)."""
        positions = self._prompt_positions(inputs, positions, 0)
        x = self._input_activations(params, inputs, positions)
        x = self._run_blocks(params, x, positions=positions, cache=cache, t=0)
        return self._logits(params, x[:, -1:]), cache

    def prefill_chunk(self, params, inputs, cache,
                      t0: int | torch.Tensor, valid_len: int | torch.Tensor,
                      *, positions=None):
        """Incremental prefill of one fixed-size chunk at absolute start
        position ``t0``: ``inputs["tokens"]`` (B, C) or ``inputs["embeds"]``
        (B, C, M) with only the first ``valid_len`` entries real, and
        positions from ``positions``, ``inputs["positions"]`` or
        row-contiguous from ``t0``.  The padded tail writes KV rows
        that stay causally invisible until the decode step at their
        position overwrites them, leaves the conv, SSD and RG-LRU state
        as of the last real token, and never enters the hybrid's ring, so
        chaining chunks equals one :meth:`prefill` (for the recurrent
        families up to the scans' fp32 summation order, and for the
        hybrid's attention up to the kernel's rounding against the ring's
        plain ops).

        ``t0`` and ``valid_len`` are host ints or device scalars (0-d or
        (B,) int tensors, as the reference traces them): with tensors
        nothing reads their values on the host, so one captured call
        serves every chunk of its size, and the result is bit-identical
        to the host-int call.  -> (logits (B,V) at the last valid token,
        cache)."""
        b, _, device = self._batch_len(inputs)
        if isinstance(t0, torch.Tensor):
            t0 = t0.to(device=device, dtype=torch.int64).reshape(-1).expand(b)
        positions = self._prompt_positions(inputs, positions, t0)
        x = self._input_activations(params, inputs, positions)
        x = self._run_blocks(params, x, positions=positions, cache=cache,
                             t=t0, valid_len=valid_len)
        if isinstance(valid_len, torch.Tensor):
            last = valid_len.to(device=x.device, dtype=torch.int64) - 1
            x = x.gather(1, last.reshape(-1, 1, 1).expand(b, 1, x.shape[2]))
        else:
            x = x[:, valid_len - 1:valid_len]
        return self._logits(params, x), cache

    def decode_step(self, params, inputs, cache, t, live=None):
        """One-token decode at absolute position ``t`` (an int or a (B,)
        tensor) of ``inputs["tokens"]`` (B,) or ``inputs["embeds"]``
        (B, M).  ``live`` (B,) bool freezes the cache of rows that are
        not live.  A paged cache (one holding a ``"page_table"``, see
        :meth:`init_paged_cache`) reads and writes KV through the table,
        which passes through unchanged (the host owns it).
        -> (logits (B,V) fp32, cache)."""
        if "tokens" in inputs:
            step_in = {"tokens": inputs["tokens"].reshape(-1, 1)}
        else:
            emb = inputs["embeds"]
            step_in = {"embeds": emb.reshape(emb.shape[0], 1, -1)}
        b, _, device = self._batch_len(step_in)
        positions = self._default_positions(b, 1, t, device)
        x = self._input_activations(params, step_in, positions)
        x = self._run_blocks(params, x, positions=positions, cache=cache,
                             t=t, live=live)
        return self._logits(params, x), cache

    def select_cache_rows(self, live: torch.Tensor, new_cache: PyTree,
                          old_cache: PyTree) -> PyTree:
        """Per-row cache select (functional): rows where ``live`` is True
        take ``new_cache``, the others keep ``old_cache`` bit-exact.
        Page-pool leaves and the page table have no per-row batch axis
        and are kept as written (a row that is not live writes to the
        trash page, see ``layers.attention``)."""
        paged = (self.paged_leaf_paths() | {("page_table",)}
                 if "page_table" in new_cache else frozenset())

        def sel(path, n, o):
            if path in paged:
                return n
            shape = [1] * n.ndim
            shape[cache_batch_axis(path)] = live.shape[0]
            return torch.where(live.reshape(shape), n, o).to(o.dtype)
        return tree_map_with_path(sel, new_cache, old_cache)

    def decode_quantum(self, params, tokens, cache, pos, n_left, k: int):
        """Fused decode of up to ``k`` greedy tokens per row with on-device
        argmax sampling and no host sync.

        ``tokens`` (B,) last-sampled token per row; ``pos`` (B,) absolute
        positions; ``n_left`` (B,) per-row step budget (rows past it
        freeze: token, position and cache).  Returns ``(block (k, B),
        cache, pos)``; column ``i`` of ``block`` is valid for its first
        ``n_left[i]`` rows."""
        toks = tokens.to(torch.int64)
        pos = pos.to(torch.int64)
        out = []
        for j in range(int(k)):
            live = n_left > j
            logits, cache = self.decode_step(params, {"tokens": toks}, cache,
                                             pos, live=live)
            toks = torch.where(live, logits.argmax(dim=-1), toks)
            pos = torch.where(live, pos + 1, pos)
            out.append(toks)
        return torch.stack(out), cache, pos

    def verify_drafts(self, params, tokens, drafts, cache, pos, n_left):
        """Speculative decode quantum: score a per-row draft block in ONE
        batched forward and greedily accept the longest matching prefix
        plus one corrected token.

        ``tokens`` (B,) is each row's last sampled token, ``drafts``
        (B, d) the drafter's proposed continuation (``d`` fixes the
        shape: the version cache builds one call per draft depth).  The
        d+1 tokens [token, draft_0, ..., draft_{d-1}] run as one chunk at
        per-row start positions ``pos`` (B,).  Per row, ``accepted`` is
        the length of the longest draft prefix equal to the model's own
        argmax, and the row emits ``n_emit = min(accepted + 1, n_left)``
        tokens (0 where ``n_left`` is 0: such a row is frozen).

        Rollback is per cache family, as in the reference:

        * KV leaves (dense rows or page pools) keep the pass-1 writes of
          live rows: entries past ``pos + n_emit`` stay causally
          invisible until the next quantum overwrites them.  A row that
          is not live writes nothing (dense) or the trash page (paged),
          where the reference writes every row.
        * Recurrent leaves (conv, SSD and RG-LRU state, the hybrid's
          ring) cannot keep the optimistic update.  Pass 1 does not write
          them (no row is live for them), and a restore pass from that
          unchanged state replays the chunk with per-row ``valid_len =
          n_emit``, writing only rows that emit: padded tokens are exact
          no-ops (dt = 0, log a = 0, no ring write), so each row's state
          is the state after ``n_emit`` steps, and a row at 0 keeps its
          state bit for bit.  Families without such leaves skip the
          restore pass (decided here, not on the device).

        Pass 1 runs with ``valid_len = d + 1`` for every row, as the
        reference's does: the hybrid's attention then attends the ring
        plus the chunk's own keys (a chunk with no ``valid_len`` would be
        taken for a monolithic prefill from position 0).

        The cache is updated in place.  Returns ``(block (d+1, B),
        n_emit (B,), accepted (B,), cache, pos + n_emit)``; column ``i``
        of ``block`` holds the row's tokens in its first ``n_emit[i]``
        entries."""
        cfg = self.cfg
        b, d = drafts.shape
        s = d + 1
        pos = pos.to(torch.int64)
        n_left = n_left.to(torch.int64)
        seq = torch.cat([tokens.to(torch.int64)[:, None],
                         drafts.to(torch.int64)], dim=1)       # (B, d+1)
        positions = self._default_positions(b, s, pos, seq.device)
        x = self._input_activations(params, {"tokens": seq}, positions)
        recurrent = self.has_recurrent_leaves()
        live = (torch.zeros_like(n_left, dtype=torch.bool) if recurrent
                else n_left > 0)
        x1 = self._run_blocks(params, x, positions=positions, cache=cache,
                              t=pos, live=live, valid_len=s)
        h = L.apply_norm(params["final_norm"], x1, cfg.norm_type)
        g = L.unembed(params["embed"], h, cfg).argmax(dim=-1)  # (B, d+1)
        match = (g[:, :d] == drafts.to(torch.int64)).to(torch.int64)
        accepted = torch.cumprod(match, dim=1).sum(dim=1)
        n_emit = torch.where(n_left > 0,
                             torch.minimum(accepted + 1, n_left), 0)
        if recurrent:
            self._run_blocks(params, x, positions=positions, cache=cache,
                             t=pos, live=n_emit > 0, valid_len=n_emit)
        return g.T, n_emit, accepted, cache, pos + n_emit

    # the reference's name, bound without a second ``def`` (see
    # ``make_plan``)
    verify_quantum = verify_drafts


# The class has its own name and the reference's name is an alias: the
# repository's static analyzer (repro.analysis.callgraph) keys classes by
# bare name, and a second class named Model would merge with the
# reference's and shrink the reference's audited hot path.
Model = TorchModel


@functools.lru_cache(maxsize=None)
def model_for(cfg: ModelConfig) -> Model:
    """The one :class:`Model` of ``cfg`` in this process (a model holds
    its config and layer plan, never weights)."""
    return Model(cfg)


# the reference's name, bound without a second ``def`` (see ``make_plan``)
build_model = model_for
