"""repro_torch.analysis — static invariant checking for the port's
serving hot path.

A stdlib-``ast`` analyzer (no runtime imports of the checked code, of
``torch``, of ``jax`` or of the reference package) that turns the
port's dynamic serving invariants — one host sync per quantum, zero
CUDA-graph captures after warmup, paged-leaf coverage, atomic
tile-table swaps — into static rules.  Its framework (``astutil``,
``base``, ``callgraph``, ``runner``) is a copy of the reference
analyzer's, its call graph widened for the names the port binds by
assignment; its rules carry ids of their own (``torch-host-sync``,
``torch-retrace-hazard``, ``torch-paged-leaf-coverage``,
``torch-tile-table-atomicity``, plus ``syntax``).

    python -m repro_torch.analysis [paths] [--json] [--rules ids] \\
        [--list-rules]

scans the port package by default and exits 0 when clean, 1 on a
violation, 2 on a usage error.  Suppress a finding in place with::

    # veltair: ignore[rule-id] one-line justification
"""
from repro_torch.analysis.base import (NO_COUNTERPART, AnalysisContext, Rule,
                                       Violation, all_rules, register)
from repro_torch.analysis.runner import Report, iter_python_files, run

__all__ = ["NO_COUNTERPART", "AnalysisContext", "Rule", "Violation",
           "all_rules", "register", "Report", "iter_python_files", "run"]
