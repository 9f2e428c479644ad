"""Rule 0 — ``syntax``: every scanned file must parse.

Replaces the bare ``python -m compileall`` CI step: a file that fails
``ast.parse`` is reported as a violation at the error's position.  This
rule ignores suppression comments (an unparseable file cannot be
trusted to carry them).
"""
from __future__ import annotations

from repro_torch.analysis.base import AnalysisContext, Rule, Violation, register


class SyntaxRule(Rule):
    rule_id = "syntax"
    description = "file must parse with ast.parse (replaces compileall)"

    def check(self, ctx: AnalysisContext) -> list[Violation]:
        out: list[Violation] = []
        for sf in ctx.files:
            if sf.error is not None:
                out.append(Violation(
                    rule_id=self.rule_id, path=str(sf.path),
                    line=sf.error.lineno or 1,
                    col=(sf.error.offset or 1) - 1,
                    message=f"syntax error: {sf.error.msg}"))
        return out


register(SyntaxRule())
