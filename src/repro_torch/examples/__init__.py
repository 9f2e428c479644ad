"""The JAX package's five examples (``examples/*.py``), ported under the
same file names.  Each runs as ``python -m repro_torch.examples.<name>``
and has a ``main(argv=None)`` that prints what the reference prints and
returns the same numbers as a dict:

* ``quickstart`` — reduced gemma-2b serves eight requests through the
  engine, then again speculatively (token-identical);
* ``adaptive_compilation_demo`` — Alg. 1's frontier and selection for one
  conv layer on ``CPU_3990X`` (host-only);
* ``tpu_pod_serving`` — four LM tenants' plans on the ``TPU_V5E_POD``
  cost model under three policies (host-only);
* ``train_lm`` — a reduced LM trained with WSD and checkpoints;
* ``multi_tenant_serving`` — the six-policy simulator table, then the
  online runtime, the co-location cluster and speculative quanta on real
  engines.

Every example runs on the card (``--device cuda``, the default) unless
``--device cpu`` is passed; asking for the card without one raises.  The
two host-only examples check the device and build no kernel.  The
functions that serve or train take the config and weights as arguments,
so a caller can pass weights of its own or a full-width config.
"""
from __future__ import annotations

import torch


def checked_device(name: str, device) -> torch.device:
    """``device`` as a ``torch.device``; the card without one raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"repro_torch.examples.{name} runs on cuda, "
                           "and torch.cuda.is_available() is False; "
                           "pass --device cpu to run it on the CPU")
    return dev


def example_device(name: str, device) -> torch.device:
    """``checked_device``; on the card the kernels are built first (every
    stale source in parallel), so no example that launches them times a
    build."""
    dev = checked_device(name, device)
    if dev.type == "cuda":
        from repro_torch.kernels import cuda_build
        cuda_build.build(cuda_build.SOURCES)
    return dev


def seeded_params(cfg, dev: torch.device):
    """Random weights of ``cfg`` on ``dev`` from a generator seeded 0 (as
    ``launch/serve`` makes them)."""
    from repro_torch.models import build_model
    return build_model(cfg).init(torch.Generator(dev).manual_seed(0), dev)
