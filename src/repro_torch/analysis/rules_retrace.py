"""Rule 3 — ``torch-retrace-hazard``.

On the card every ``VersionCache`` call is a CUDA graph captured at its
first use and replayed after, one graph per (version, K-bucket): a K
that no bucket names means a fresh capture in the middle of a serve,
which synchronizes the whole card.  Every compiled-shape knob is
therefore quantized to power-of-two buckets through sanctioned helpers.
This rule flags the two ways fresh code reintroduces captures:

* a **K argument** to ``VersionCache.quantum``/``verify_call`` (called
  through its reference name ``spec_quantum`` too) that is not visibly
  bucketed — sanctioned forms are int literals, values drawn from a
  ``*bucket*``-named collection (loop var, ``next(...)`` over it,
  subscript of it, ``min``/``max`` of sanctioned values), or a call to
  ``_next_pow2``/``pages_for``;
* ``len(...)`` flowing into the **shape argument** of a ``torch``
  tensor constructor (``zeros``, ``empty``, ``full``, ``ones``,
  ``arange``) without a bucketing wrapper — per-request lengths mean
  one buffer shape, and one capture, per distinct length.

The reference's ``static_argnums`` clause has no counterpart: a CUDA
graph has no static arguments, only the tensors of its first use.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.base import AnalysisContext, Rule, Violation, register

SANCTIONED_HELPERS = {"_next_pow2", "next_pow2", "pages_for"}
K_METHODS = {"quantum", "spec_quantum", "verify_call"}
_SHAPE_CTORS = {"zeros", "empty", "full", "ones", "arange"}


def _bucketish(expr: ast.AST) -> bool:
    """Does the expression mention a ``*bucket*``-named binding?"""
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and "bucket" in node.id.lower():
            return True
        if isinstance(node, ast.Attribute) and "bucket" in node.attr.lower():
            return True
    return False


def _helper_call(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Call):
        name = astutil.dotted_name(expr.func) or ""
        if name.split(".")[-1] in SANCTIONED_HELPERS:
            return True
    return False


class _Sanction:
    """Per-function set of names known to hold bucketed values."""

    def __init__(self, fn: ast.AST):
        self.names: set[str] = set()
        for _ in range(2):      # two passes: alias-of-alias stabilizes
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and len(
                        node.targets) == 1 and isinstance(
                        node.targets[0], ast.Name):
                    if self.expr_ok(node.value):
                        self.names.add(node.targets[0].id)
                elif isinstance(node, ast.For) and isinstance(
                        node.target, ast.Name):
                    if _bucketish(node.iter):
                        self.names.add(node.target.id)

    def expr_ok(self, expr: ast.AST) -> bool:
        if astutil.int_const(expr) is not None:
            return True
        if _helper_call(expr) or _bucketish(expr):
            return True
        if isinstance(expr, ast.Name):
            return expr.id in self.names
        if isinstance(expr, ast.Call):
            name = astutil.dotted_name(expr.func) or ""
            if name in {"min", "max"} and expr.args:
                return all(self.expr_ok(a) or _bucketish(a)
                           for a in expr.args)
            if name == "next" and expr.args and _bucketish(expr.args[0]):
                return True
        if isinstance(expr, ast.Subscript):
            return _bucketish(expr.value)
        return False


class TorchRetraceRule(Rule):
    rule_id = "torch-retrace-hazard"
    description = ("K-buckets and tensor shapes must flow through pow2-"
                   "bucket helpers (a fresh K is a fresh CUDA-graph capture)")

    def check(self, ctx: AnalysisContext) -> list[Violation]:
        out: list[Violation] = []
        for qual, info in sorted(ctx.graph.functions.items()):
            sanction = _Sanction(info.node)
            for node in ast.walk(info.node):
                if not isinstance(node, ast.Call):
                    continue
                out.extend(self._check_k_arg(info.sf, node, sanction))
                out.extend(self._check_shape_len(info.sf, node))
        return out

    def _check_k_arg(self, sf, call: ast.Call,
                     sanction: _Sanction) -> list[Violation]:
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr in K_METHODS):
            return []
        if len(call.args) < 2 or isinstance(call.args[1], ast.Starred):
            return []
        k = call.args[1]
        if sanction.expr_ok(k):
            return []
        return [self.violation(
            sf, k, f"K argument `{ast.unparse(k)}` to .{call.func.attr}() "
            f"is not visibly bucketed (use a *_buckets collection or "
            f"_next_pow2/pages_for) — every distinct value is a fresh "
            f"CUDA-graph capture")]

    def _check_shape_len(self, sf, call: ast.Call) -> list[Violation]:
        name = astutil.dotted_name(call.func) or ""
        parts = name.split(".")
        if len(parts) != 2 or parts[0] != "torch" or \
                parts[1] not in _SHAPE_CTORS:
            return []
        # the shape: every positional size of zeros/empty/ones/arange
        # (``torch.zeros(n, d)`` or ``torch.zeros((n, d))``), the first
        # argument of full (its second is the fill value)
        stack = list(call.args[:1] if parts[1] == "full" else call.args)
        out = []
        while stack:
            node = stack.pop()
            if _helper_call(node):
                continue        # _next_pow2(len(x)) is the sanctioned form
            if isinstance(node, ast.Call):
                n = astutil.dotted_name(node.func) or ""
                if n == "len":
                    out.append(self.violation(
                        sf, node, f"len() flows into a {name}() shape — "
                        f"per-request lengths give a buffer shape (and a "
                        f"capture) per distinct value; bucket with "
                        f"_next_pow2/pages_for"))
                    continue
            stack.extend(ast.iter_child_nodes(node))
        return out


register(TorchRetraceRule())
