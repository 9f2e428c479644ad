"""Rule 4 — ``torch-paged-leaf-coverage``.

The paging contract: ``TorchModel.paged_leaf_paths`` derives the set of
pageable leaves from ``TorchModel.cache_specs`` by looking for a
``"seq"`` axis in each leaf's ``ParamSpec``.  That derivation only sees specs
that ``cache_specs`` actually returns — a new cache family whose spec
helper isn't wired into ``cache_specs`` would allocate dense
``max_len`` rows, silently bypass paging, and reintroduce the memory
wall the paged cache removed.

The rule therefore checks, over the scanned corpus:

* every function that (a) has ``cache`` in its name and (b) constructs
  a ``ParamSpec`` with a literal ``"seq"`` axis must be **reachable
  from** the ``TorchModel.cache_specs`` anchor in the call graph;
* every function named ``*cache_spec*`` must be **connected** to the
  anchor (reachable from it, or a transitive caller of it — e.g.
  ``paged_cache_specs`` *calls* ``cache_specs``).

When no ``TorchModel.cache_specs`` anchor exists in the scanned set
(single file runs, unrelated fixtures) the rule is inert — coverage is
only checkable against the anchor.  The id differs from the
reference's ``paged-leaf-coverage``, so a suppression written for the
reference's gate (whose anchor is ``Model.cache_specs``) never
silences this check.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.base import AnalysisContext, Rule, Violation, register

ANCHOR_SUFFIX = "TorchModel.cache_specs"


def _seq_paramspec_calls(fn: ast.AST) -> list[ast.Call]:
    """ParamSpec(...) calls inside ``fn`` whose axes literal has "seq"."""
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = astutil.dotted_name(node.func) or ""
        if name.split(".")[-1] != "ParamSpec":
            continue
        axes = None
        for kw in node.keywords:
            if kw.arg == "axes":
                axes = kw.value
        if axes is None and len(node.args) >= 3:
            axes = node.args[2]
        if axes is None:
            continue
        tup = astutil.const_str_tuple(axes)
        if tup and "seq" in tup:
            out.append(node)
    return out


class TorchPagedLeafRule(Rule):
    rule_id = "torch-paged-leaf-coverage"
    description = ("every 'seq'-axis cache ParamSpec must be reachable "
                   "from TorchModel.cache_specs (paged_leaf_paths)")

    def check(self, ctx: AnalysisContext) -> list[Violation]:
        anchors = ctx.graph.find(ANCHOR_SUFFIX)
        if not anchors:
            return []
        reachable = ctx.graph.reachable(anchors)
        connected = ctx.graph.connected(anchors)
        out: list[Violation] = []
        for qual, info in sorted(ctx.graph.functions.items()):
            fname = info.node.name  # type: ignore[union-attr]
            if "cache" in fname and qual not in reachable:
                calls = _seq_paramspec_calls(info.node)
                if calls:
                    out.append(self.violation(
                        info.sf, calls[0],
                        f"{fname}() constructs a \"seq\"-axis cache "
                        f"ParamSpec but is not reachable from "
                        f"TorchModel.cache_specs — its leaves bypass "
                        f"paged_leaf_paths and stay dense"))
                    continue
            if "cache_spec" in fname and qual not in connected and \
                    qual not in set(anchors):
                out.append(self.violation(
                    info.sf, info.node,
                    f"{fname}() looks like a cache-spec helper but is "
                    f"disconnected from TorchModel.cache_specs — wire it "
                    f"into "
                    f"the cache_specs dispatch so paging sees its leaves"))
        return out


register(TorchPagedLeafRule())
