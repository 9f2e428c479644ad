"""Rule 5 — ``torch-tile-table-atomicity``.

The port's dispatch override table (``kernels/dispatch.py``:
``_TILE_OVERRIDES``, ``_CONTEXT_STACK``, ``_LADDER``) is shared mutable
state read by every kernel launch.  ``install_tile_overrides``/``install_ladder`` replace
it wholesale (old ops cleared, new ops installed in one call), so a
level switch can never leave a half-old/half-new table for a
concurrently tracing tenant.  Per-op ``set_tile_overrides`` and direct
pokes at ``_TILE_OVERRIDES``/``_CONTEXT_STACK``/``_LADDER`` do not have
that property — N per-op calls = N-1 observable torn states — which is
exactly the "corrupted shared config" interference VELTAIR's adaptive
compilation must exclude; on the card a torn table is also captured
into a CUDA graph and replayed.  Everything outside
``kernels/dispatch.py`` (the owning module) must go through the atomic
installers.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.base import AnalysisContext, Rule, Violation, register

_GLOBALS = {"_TILE_OVERRIDES", "_CONTEXT_STACK", "_LADDER"}
_MUTATORS = {"clear", "update", "append", "pop", "setdefault", "extend",
             "insert", "remove"}
_OWNER_FILE = "dispatch.py"


def _names_global(node: ast.AST) -> str | None:
    if isinstance(node, ast.Name) and node.id in _GLOBALS:
        return node.id
    if isinstance(node, ast.Attribute) and node.attr in _GLOBALS:
        return node.attr
    return None


class TorchTileAtomicityRule(Rule):
    rule_id = "torch-tile-table-atomicity"
    description = ("dispatch override state changes only via "
                   "install_tile_overrides/install_ladder")

    def check(self, ctx: AnalysisContext) -> list[Violation]:
        out: list[Violation] = []
        for sf in ctx.parsed():
            if sf.path.name == _OWNER_FILE:
                continue
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Call):
                    name = astutil.dotted_name(node.func) or ""
                    if name.split(".")[-1] == "set_tile_overrides":
                        out.append(self.violation(
                            sf, node, "per-op set_tile_overrides() is "
                            "not atomic across ops — a concurrent trace "
                            "can observe a torn tile table; use "
                            "install_tile_overrides({...}) (or "
                            "tile_context for scoped overrides)"))
                        continue
                    # _TILE_OVERRIDES.update(...) style method mutation
                    if isinstance(node.func, ast.Attribute) and \
                            node.func.attr in _MUTATORS:
                        g = _names_global(node.func.value)
                        if g:
                            out.append(self.violation(
                                sf, node, f"direct {g}.{node.func.attr}() "
                                f"mutation outside kernels/dispatch.py — "
                                f"use install_tile_overrides/"
                                f"install_ladder"))
                        continue
                # stores: X = ..., X[k] = ..., del X[k]
                targets: list[ast.AST] = []
                if isinstance(node, ast.Assign):
                    targets = list(node.targets)
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                elif isinstance(node, ast.Delete):
                    targets = list(node.targets)
                for tgt in targets:
                    base = tgt.value if isinstance(
                        tgt, ast.Subscript) else tgt
                    g = _names_global(base)
                    if g:
                        out.append(self.violation(
                            sf, tgt, f"direct write to {g} outside "
                            f"kernels/dispatch.py — use "
                            f"install_tile_overrides/install_ladder"))
        return out


register(TorchTileAtomicityRule())
