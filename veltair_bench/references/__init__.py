"""Plain PyTorch references of the benchmark's models.

Each module here is one architecture's forward pass in float32 with
TF32 off, written from the published description, with no kernel, no
cache and no batching.  It imports nothing of the program under test:
the harness makes the weights (``weights.py``) from the layout a
module's ``layout(config)`` gives, hands the same tensors to the program
and to the reference, and the reference recasts them to float32 one
layer at a time.

A module exports:

* ``layout(config) -> [(path, shape, dtype, init, std)]``: the weight
  tree, ``path`` a tuple of keys, ``init`` one of ``normal`` (std
  ``std``), ``one_plus`` (1 + a normal draw of std ``std``),
  ``log_uniform`` (the log of a uniform draw in ``std = (lo, hi)``) or
  ``dt_bias`` (the inverse softplus of a step size drawn log-uniformly
  in ``std = (lo, hi)``);
* ``logits(params, tokens, positions, config, mm) -> (len(positions),
  vocab)`` float32 logits at ``positions`` of the token sequence, every
  weight product through ``mm(a, w)``;
* ``port_fields(config)``: the program's config attributes (``attr``
  or ``sub.attr``) the file fixes;
* ``kernel_work(config, step)``, ``token_flops(config, pos)``,
  ``head_flops(config)``: the least work of the port's kernels in one
  decode step or prefill chunk, and the model FLOPs of a token, for the
  roofline and ``mfu`` readers.

``mm`` is :func:`matmul_fp32` for the reference and :func:`matmul_fp8`
for the control, which runs the same forward with every weight product
in fp8 (e4m3), the precision below the configurations' bfloat16.
"""
from __future__ import annotations

import contextlib
import importlib

import torch

FP8_MAX = 448.0        # largest finite float8_e4m3fn


def matmul_fp32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in float32 (TF32 is off inside :func:`exact_fp32`)."""
    return a.float() @ w.float()


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8_e4m3fn with one scale per slice along
    ``dim`` (amax to 448), back in float32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def matmul_fp8(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` with ``a`` rounded to fp8 per row and ``w`` per column,
    accumulated in float32: an fp8 weight-and-activation GEMM."""
    return _fp8(a.float(), -1) @ _fp8(w.float(), 0)


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and convolutions, restored after."""
    mm, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn


def load(name: str):
    """The reference module ``references/<name>.py``."""
    return importlib.import_module(f"veltair_bench.references.{name}")
