"""Modality frontends (stubs, as in the reference) and the input specs
of the PyTorch port (``repro.models.frontends``).

The ``vlm`` and ``audio`` configs specify the transformer backbone only;
the frontend provides precomputed patch or frame embeddings:
  qwen2-vl  -> patch embeddings (B, S, M) + 3D M-RoPE positions (3, B, S)
  musicgen  -> EnCodec frame embeddings (B, S, M) (sum of codebook embeds)

``input_specs(cfg, shape)`` returns a :class:`ParamSpec` tree describing
every model input of an (arch x shape) cell; ``make_sample_inputs``
materializes a small concrete batch from it on an explicit device, with
the reference's draws in the reference's order, so both packages' samples
are equal value for value.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.params import ParamSpec


def frontend_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The inputs of one call: ``{"tokens"}`` for a token config,
    ``{"embeds"}`` (plus ``"positions"`` for M-RoPE and ``"labels"`` for
    training) for a frontend config; a decode step takes one token or
    one embedding a row."""
    b, s, m = shape.global_batch, shape.seq_len, cfg.d_model
    if shape.mode == "decode":
        if cfg.frontend != "none":
            return {"embeds": ParamSpec((b, m), torch.bfloat16,
                                        ("batch", "embed"))}
        return {"tokens": ParamSpec((b,), torch.int32, ("batch",))}

    specs: dict = {}
    if cfg.frontend != "none":
        specs["embeds"] = ParamSpec((b, s, m), torch.bfloat16,
                                    ("batch", "seq", "embed"))
        if cfg.pos_embed == "mrope":
            specs["positions"] = ParamSpec((3, b, s), torch.int32,
                                           (None, "batch", "seq"))
        if shape.mode == "train":
            specs["labels"] = ParamSpec((b, s), torch.int32,
                                        ("batch", "seq"))
    else:
        specs["tokens"] = ParamSpec((b, s), torch.int32, ("batch", "seq"))
    return specs


def sample_inputs(cfg: ModelConfig, shape: ShapeConfig, *, device,
                  seed: int = 0) -> dict:
    """A concrete batch on ``device``: tokens and labels uniform over the
    vocabulary, M-RoPE positions row-contiguous on all three rows,
    embeddings 0.02-scaled normals rounded to bf16, drawn from
    ``np.random.default_rng(seed)`` in the specs' order."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, sp in frontend_input_specs(cfg, shape).items():
        if sp.dtype == torch.int32:
            if name in ("tokens", "labels"):
                val = rng.integers(0, cfg.vocab_size, sp.shape)
                out[name] = torch.from_numpy(val.astype(np.int32)).to(device)
            else:  # positions
                s = sp.shape[-1]
                pos = np.broadcast_to(np.arange(s, dtype=np.int32), sp.shape)
                out[name] = torch.from_numpy(pos.copy()).to(device)
        else:
            val = 0.02 * rng.standard_normal(sp.shape)
            # float64 -> bf16 in one rounding, as the reference casts
            out[name] = torch.from_numpy(val).to(device=device,
                                                 dtype=sp.dtype)
    return out


def meta_inputs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The inputs of one call as tensors on the meta device (shapes and
    dtypes, no storage)."""
    return {name: torch.empty(sp.shape, dtype=sp.dtype, device="meta")
            for name, sp in frontend_input_specs(cfg, shape).items()}


# the reference's names, bound without a second ``def``: the repository's
# static analyzer resolves the reference's ``from repro.models.frontends
# import input_specs`` by the function name being unique in the corpus
input_specs = frontend_input_specs
make_sample_inputs = sample_inputs
abstract_inputs = meta_inputs
