"""Plain PyTorch versions of every ported kernel (shape-for-shape
reference, as ``repro.kernels.ref``).  Each is defined beside its kernel;
this module gathers them under the reference package's names for the
tests and the on-card checks."""
from __future__ import annotations

from repro_torch.kernels.block_matmul import matmul_plain as matmul_ref
from repro_torch.kernels.flash_attention import \
    attention_plain as attention_ref
from repro_torch.kernels.flash_attention_paged import \
    paged_attention_plain as paged_attention_ref
from repro_torch.kernels.ssd_scan import ssd_scan_plain as ssd_ref

__all__ = ["matmul_ref", "attention_ref", "paged_attention_ref", "ssd_ref"]
