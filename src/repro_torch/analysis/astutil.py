"""AST plumbing for the port's static analyzer: file loading, parent
links, qualified names, dotted-name helpers, and suppression-comment
scanning (a copy of the reference analyzer's, importing nothing of it).

Everything here is stdlib-``ast`` based (no new dependencies) and purely
syntactic: the analyzer never imports the code it checks, so it can run
over a broken tree (that is rule 0's whole point) and over fixture
snippets that are not importable packages.

Suppressions: a violation is suppressed by a comment on the violating
line or the line directly above it::

    x = int(logits.max())   # veltair: ignore[torch-host-sync] why

The bracket list may name several rules (comma-separated) or ``*`` for
all rules; text after the bracket is the (required by convention)
one-line justification.  The ``syntax`` rule cannot be suppressed — a
file that does not parse cannot be trusted to carry comments.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

SUPPRESS_RE = re.compile(
    r"#\s*veltair:\s*ignore\[([A-Za-z0-9_\-*,\s]+)\]")


@dataclasses.dataclass
class SourceFile:
    """One parsed source file plus the side tables rules consume."""
    path: pathlib.Path
    module: str                          # dotted module name ("repro_torch.x.y")
    text: str
    tree: ast.Module | None              # None when the file does not parse
    error: SyntaxError | None = None
    # line -> set of rule ids suppressed there ("*" = every rule)
    suppressions: dict[int, set[str]] = dataclasses.field(
        default_factory=dict)

    def suppressed(self, line: int, rule_id: str) -> bool:
        """Is ``rule_id`` suppressed at ``line`` (same line or the line
        directly above)?  ``syntax`` is never suppressible."""
        if rule_id == "syntax":
            return False
        for ln in (line, line - 1):
            ids = self.suppressions.get(ln)
            if ids and ("*" in ids or rule_id in ids):
                return True
        return False


def scan_suppressions(text: str) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = SUPPRESS_RE.search(line)
        if m:
            ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
            if ids:
                out[i] = ids
    return out


def load_file(path: pathlib.Path, module: str) -> SourceFile:
    text = path.read_text(encoding="utf-8", errors="replace")
    try:
        tree = ast.parse(text, filename=str(path))
        err = None
    except SyntaxError as e:
        tree, err = None, e
    sf = SourceFile(path=path, module=module, text=text, tree=tree,
                    error=err, suppressions=scan_suppressions(text))
    if tree is not None:
        attach_parents(tree)
    return sf


def attach_parents(tree: ast.AST) -> None:
    """Store a ``_vl_parent`` backlink on every node (rules walk up to
    find the enclosing statement / function / class)."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._vl_parent = node  # type: ignore[attr-defined]


def parent(node: ast.AST) -> ast.AST | None:
    return getattr(node, "_vl_parent", None)


def enclosing(node: ast.AST, *types) -> ast.AST | None:
    """Nearest ancestor of one of ``types`` (the node itself excluded)."""
    cur = parent(node)
    while cur is not None and not isinstance(cur, types):
        cur = parent(cur)
    return cur


def enclosing_statement(node: ast.AST) -> ast.stmt | None:
    cur: ast.AST | None = node
    while cur is not None and not isinstance(cur, ast.stmt):
        cur = parent(cur)
    return cur  # type: ignore[return-value]


def enclosing_function(node: ast.AST) -> ast.AST | None:
    """Nearest enclosing *top-level* function or method: nested ``def``s
    (jit closures, local helpers) are attributed to the outermost
    function that owns them, which is what the call graph indexes."""
    fn = None
    cur = parent(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = cur
        cur = parent(cur)
    return fn


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None (calls,
    subscripts and literals break the chain)."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def func_qualname(fn: ast.AST) -> str:
    """``Class.method`` or ``func`` for a top-level def (nested defs get
    their outermost owner's name — see :func:`enclosing_function`)."""
    names = [fn.name]  # type: ignore[union-attr]
    cur = parent(fn)
    while cur is not None:
        if isinstance(cur, (ast.ClassDef, ast.FunctionDef,
                            ast.AsyncFunctionDef)):
            names.append(cur.name)
        cur = parent(cur)
    return ".".join(reversed(names))


def const_str_tuple(node: ast.AST) -> tuple | None:
    """A tuple/list display of constants as a python tuple, else None."""
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for el in node.elts:
            if isinstance(el, ast.Constant):
                out.append(el.value)
            else:
                out.append(None)
        return tuple(out)
    return None


def int_const(node: ast.AST) -> int | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    return None
