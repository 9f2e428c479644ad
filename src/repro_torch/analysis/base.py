"""Rule base class, violation record, and the rule registry.

A rule sees the whole corpus at once (``check(ctx)``) rather than one
file at a time because every interesting invariant here is
cross-module: hot-path slices, donation flows, and paged-leaf coverage
all need the call graph.  File-local rules simply loop over
``ctx.files``.

The port's rules carry ids of their own (``torch-host-sync``, ...): a
``# veltair: ignore[...]`` comment written for the reference's gate
never silences one of them.
"""
from __future__ import annotations

import ast
import dataclasses

from repro_torch.analysis.astutil import SourceFile
from repro_torch.analysis.callgraph import CallGraph


@dataclasses.dataclass(frozen=True)
class Violation:
    rule_id: str
    path: str                # file path as given on the command line
    line: int
    col: int
    message: str
    suppressed: bool = False
    justified: bool = False  # suppression comment carried a justification

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"[{self.rule_id}] {self.message}{tag}")


class AnalysisContext:
    """Everything a rule may consult: parsed files + the call graph."""

    def __init__(self, files: list[SourceFile]):
        self.files = files
        self.graph = CallGraph(files)

    def parsed(self) -> list[SourceFile]:
        return [f for f in self.files if f.tree is not None]


class Rule:
    """Subclass, set ``rule_id``/``description``, implement ``check``."""

    rule_id: str = ""
    description: str = ""

    def check(self, ctx: AnalysisContext) -> list[Violation]:
        raise NotImplementedError

    # helper: build a violation, folding in suppression state
    def violation(self, sf: SourceFile, node: ast.AST | None,
                  message: str, line: int | None = None,
                  col: int | None = None) -> Violation:
        ln = line if line is not None else getattr(node, "lineno", 1)
        cl = col if col is not None else getattr(node, "col_offset", 0)
        suppressed = sf.suppressed(ln, self.rule_id)
        justified = False
        if suppressed:
            justified = _has_justification(sf, ln, self.rule_id)
        return Violation(rule_id=self.rule_id, path=str(sf.path),
                         line=ln, col=cl, message=message,
                         suppressed=suppressed, justified=justified)


def _has_justification(sf: SourceFile, line: int, rule_id: str) -> bool:
    """True when the suppression comment carries trailing text after
    the closing bracket (the one-line justification convention)."""
    from repro_torch.analysis.astutil import SUPPRESS_RE
    lines = sf.text.splitlines()
    for ln in (line, line - 1):
        if 1 <= ln <= len(lines):
            m = SUPPRESS_RE.search(lines[ln - 1])
            ids = {s.strip() for s in m.group(1).split(",")} if m else ()
            if rule_id in ids or "*" in ids:
                return bool(lines[ln - 1][m.end():].strip())
    return False


_REGISTRY: dict[str, Rule] = {}


def register(rule: Rule) -> Rule:
    if not rule.rule_id:
        raise ValueError("rule_id must be set")
    _REGISTRY[rule.rule_id] = rule
    return rule


def all_rules() -> dict[str, Rule]:
    # import rule modules lazily so registration happens exactly once
    from repro_torch.analysis import (  # noqa: F401
        rules_syntax, rules_hotpath, rules_retrace, rules_paging,
        rules_tiles)
    return dict(_REGISTRY)


# Reference rules with no counterpart in the port, and why.
NO_COUNTERPART = {
    "use-after-donation": "the port updates caches in place and donates "
                          "nothing: there is no donated buffer to reuse",
}
