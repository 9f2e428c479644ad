"""File discovery and the entry point that runs the rules.

``run(paths)`` loads every ``.py`` under the given paths, builds one
:class:`AnalysisContext` (so cross-file rules see the whole corpus at
once), executes the registered rules, and splits results into active
violations and suppressed ones (for ``--json`` and the summary line).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

from repro_torch.analysis import astutil
from repro_torch.analysis.base import AnalysisContext, Violation, all_rules

_SKIP_DIRS = {".git", "__pycache__", ".pytest_cache", "build", "dist",
              ".eggs", "node_modules"}


def module_name(path: pathlib.Path) -> str:
    """Dotted module name derived from the package structure on disk:
    walk up while ``__init__.py`` exists; loose scripts get
    ``<parentdir>.<stem>``."""
    parts = [path.stem] if path.stem != "__init__" else []
    cur = path.parent
    seen_pkg = False
    while (cur / "__init__.py").exists():
        parts.insert(0, cur.name)
        seen_pkg = True
        cur = cur.parent
    if not seen_pkg:
        parts.insert(0, path.parent.name)
    return ".".join(p for p in parts if p) or path.stem


def iter_python_files(paths: list[str]) -> list[pathlib.Path]:
    out: list[pathlib.Path] = []
    for raw in paths:
        p = pathlib.Path(raw)
        if p.is_file() and p.suffix == ".py":
            out.append(p)
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not any(part in _SKIP_DIRS for part in f.parts):
                    out.append(f)
    return out


@dataclasses.dataclass
class Report:
    violations: list[Violation]      # active (fail the run)
    suppressed: list[Violation]
    files_scanned: int
    rules_run: list[str]

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> str:
        def rec(v: Violation) -> dict:
            return {"file": v.path, "line": v.line, "col": v.col,
                    "rule": v.rule_id, "message": v.message,
                    "suppressed": v.suppressed,
                    "justified": v.justified}
        return json.dumps({
            "ok": self.ok,
            "files_scanned": self.files_scanned,
            "rules": self.rules_run,
            "violations": [rec(v) for v in self.violations],
            "suppressed": [rec(v) for v in self.suppressed],
        }, indent=2)

    def summary(self) -> str:
        return (f"repro_torch.analysis: {self.files_scanned} files, "
                f"{len(self.rules_run)} rules, "
                f"{len(self.violations)} violation(s), "
                f"{len(self.suppressed)} suppressed")


def run_rules(paths: list[str],
              rule_ids: list[str] | None = None) -> Report:
    files = [astutil.load_file(p, module_name(p))
             for p in iter_python_files(paths)]
    ctx = AnalysisContext(files)
    rules = all_rules()
    if rule_ids:
        unknown = set(rule_ids) - set(rules)
        if unknown:
            raise KeyError(
                f"unknown rule id(s): {', '.join(sorted(unknown))}; "
                f"known: {', '.join(sorted(rules))}")
        rules = {rid: rules[rid] for rid in rule_ids}
    active: list[Violation] = []
    suppressed: list[Violation] = []
    for rid in sorted(rules):
        for v in rules[rid].check(ctx):
            (suppressed if v.suppressed else active).append(v)
    key = (lambda v: (v.path, v.line, v.col, v.rule_id))
    return Report(violations=sorted(active, key=key),
                  suppressed=sorted(suppressed, key=key),
                  files_scanned=len(files),
                  rules_run=sorted(rules))


# the reference's name, bound by assignment: a second ``def run`` would be
# what every bare ``run(...)`` call in the corpus resolves to
run = run_rules
