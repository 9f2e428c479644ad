"""Rule 1 — ``torch-host-sync``.

The serving contract is *one* host sync per quantum: the single
``handle.block.cpu()`` in ``finish_quantum``.  Anything else that makes
the host wait for the card inside the quantum hot path — ``.item()``,
``.cpu()``, ``.tolist()``, ``.numpy()``, ``.to("cpu")``,
``int()/float()/bool()`` or ``np.asarray`` of a device tensor, a truth
test of one (``if``/``while``/``not``/``and``/``or``/``assert``), or a
``torch.cuda.synchronize()`` / event or stream ``.synchronize()`` —
serializes the launch queue, and one stray sync costs the host's whole
lead over the card.

The hot path is the call-graph slice rooted at the port's serving
entry points below.  Calls inside nested ``def``s (the graphed closures
in ``VersionCache``) are attributed to their outer function, so the
model code a quantum runs is audited too.  Sanctioned syncs carry
``# veltair: ignore[torch-host-sync] <why>`` at the site.

A value is on the device when it is the result of a ``torch.*`` call
(other than the host-only calls in ``HOST_CALLS``), a parameter or
class attribute annotated ``torch.Tensor`` (``QuantumHandle.block``),
an attribute ``self.x`` that a method of the same class binds to such
a value (``self.dev = torch.zeros(...)``), or the result of a method
call on such a value.  Metadata reads (``.shape``, ``.numel()``, ...)
never sync.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.base import AnalysisContext, Rule, Violation, register

# Call-graph roots: matched by qualname suffix so fixture-sized repros
# (a mini TorchServingEngine in one file) slice the same way the port does.
HOT_ROOTS = (
    "TorchServingEngine.begin_quantum",
    "TorchServingEngine.step_quantum",
    "TorchServingEngine.finish_quantum",
    "TorchServingEngine.prefill_step",
    "TorchServingEngine.admit_request",
    "TorchVersionCache.get",
    "TorchVersionCache.quantum",
    "TorchVersionCache.verify_call",
    "TorchOnlineRuntime.serve",
    "TorchClusterRuntime.serve",
)

# torch calls whose results live on the host.
HOST_CALLS = {"torch.device", "torch.Generator", "torch.cuda.current_stream",
              "torch.is_grad_enabled", "torch.cuda.is_available",
              "torch.is_tensor", "torch.cuda.Event", "torch.cuda.Stream",
              "torch.cuda.stream", "torch.no_grad", "torch.inference_mode",
              "torch.cuda.get_device_name", "torch.cuda.device_count"}

# Attribute reads and method calls that give metadata, never a sync.
METADATA_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda",
                  "requires_grad"}
METADATA_METHODS = {"numel", "dim", "size", "stride", "data_ptr",
                    "is_contiguous", "element_size"}

# Methods whose result is on the host (the sinks among them are flagged).
_HOST_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}

_NP_HEADS = {"np", "numpy"}


def _is_tensor_annotation(ann: ast.AST | None) -> bool:
    """Does the annotation mention ``torch.Tensor`` (possibly in a union)?"""
    if ann is None:
        return False
    for node in ast.walk(ann):
        if astutil.dotted_name(node) == "torch.Tensor":
            return True
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "torch.Tensor" in node.value:
            return True
    return False


def _to_cpu(call: ast.Call) -> bool:
    """``.to("cpu")``, ``.to(device="cpu")`` or ``.to(torch.device("cpu"))``."""
    args = list(call.args) + [kw.value for kw in call.keywords
                              if kw.arg == "device"]
    for a in args:
        if isinstance(a, ast.Call) and astutil.dotted_name(a.func) == \
                "torch.device" and a.args:
            a = a.args[0]
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
    return False


def device_attr_names(ctx: AnalysisContext) -> set[str]:
    """Attribute names annotated ``torch.Tensor`` anywhere in the corpus
    (e.g. ``QuantumHandle.block``): reading them yields device values."""
    out: set[str] = set()
    for sf in ctx.parsed():
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.AnnAssign) and \
                    _is_tensor_annotation(node.annotation):
                tgt = node.target
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
                elif isinstance(tgt, ast.Attribute) and isinstance(
                        tgt.value, ast.Name) and tgt.value.id == "self":
                    out.add(tgt.attr)
    return out


class TaintScan:
    """Forward may-taint pass over one function body, in source order.
    ``tainted`` holds the local names bound to device values at the
    statement being visited; the rule's ``visit`` sees every node with
    the taint that holds there, so ``first = torch.argmax(x)`` followed
    by ``first = int(first)`` is seen as the coercion of a device value.
    Branches merge by union; loop bodies are visited twice so that
    loop-carried taint reaches the top of the body."""

    def __init__(self, device_attrs: set[str],
                 self_attrs: set[str] = frozenset()):
        self.device_attrs = device_attrs
        self.self_attrs = self_attrs   # device attributes of this class
        self.tainted: set[str] = set()
        self._visit = None

    def expr_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in METADATA_ATTRS:
                return False
            if node.attr in self.device_attrs:
                return True
            if isinstance(node.value, ast.Name) and \
                    node.value.id == "self" and node.attr in self.self_attrs:
                return True
            return self.expr_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.expr_tainted(node.value)
        if isinstance(node, ast.Call):
            return self._call_tainted(node)
        if isinstance(node, ast.BinOp):
            return self.expr_tainted(node.left) or self.expr_tainted(
                node.right)
        if isinstance(node, ast.UnaryOp):
            return not isinstance(node.op, ast.Not) and \
                self.expr_tainted(node.operand)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False           # identity tests stay on the host
            return self.expr_tainted(node.left) or any(
                self.expr_tainted(c) for c in node.comparators)
        if isinstance(node, ast.IfExp):
            return self.expr_tainted(node.body) or self.expr_tainted(
                node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.expr_tainted(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.expr_tainted(node.value)
        if isinstance(node, ast.NamedExpr):
            return self.expr_tainted(node.value)
        return False

    def _call_tainted(self, node: ast.Call) -> bool:
        name = astutil.dotted_name(node.func) or ""
        head = name.split(".")[0]
        if head in _NP_HEADS:
            return False               # numpy results live on the host
        if head == "torch":
            return name not in HOST_CALLS
        if name in {"int", "float", "bool", "len", "range", "str",
                    "isinstance"}:
            return False               # host coercions (the sinks)
        if isinstance(node.func, ast.Attribute):
            meth = node.func.attr
            if meth in METADATA_METHODS or meth in _HOST_METHODS:
                return False
            if meth == "to" and _to_cpu(node):
                return False
            if self.expr_tainted(node.func.value):
                return True            # logits.argmax(-1), x.view(...)
        return any(self.expr_tainted(a) for a in node.args)

    def _bind(self, target: ast.AST, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind(el, tainted)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tainted)

    def seed_params(self, fn: ast.AST) -> None:
        args = fn.args  # type: ignore[union-attr]
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            if _is_tensor_annotation(a.annotation):
                self.tainted.add(a.arg)

    def run(self, fn: ast.AST, visit) -> None:
        """Walk ``fn`` in source order, calling ``visit(node)`` for every
        statement and expression node under the taint that holds there."""
        self._visit = visit
        self.seed_params(fn)
        self._body(fn.body)  # type: ignore[union-attr]

    # -- the ordered walk ----------------------------------------------
    def _expr(self, node: ast.AST | None) -> None:
        if node is None:
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.comprehension):
                self._bind(sub.target, self.expr_tainted(sub.iter))
        for sub in ast.walk(node):
            self._visit(sub)

    def _body(self, stmts: list) -> None:
        for s in stmts:
            self._stmt(s)

    def _branches(self, *bodies: list) -> None:
        before, merged = set(self.tainted), set()
        for body in bodies:
            self.tainted = set(before)
            self._body(body)
            merged |= self.tainted
        self.tainted = merged

    def _stmt(self, s: ast.stmt) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.seed_params(s)        # a closure: same walk, its params
            self._body(s.body)
        elif isinstance(s, ast.ClassDef):
            self._body(s.body)
        elif isinstance(s, ast.If):
            self._visit(s)
            self._expr(s.test)
            self._branches(s.body, s.orelse)
        elif isinstance(s, (ast.For, ast.AsyncFor)):
            self._expr(s.iter)
            for _ in range(2):
                self._bind(s.target, self.expr_tainted(s.iter))
                self._branches(s.body, [])
            self._body(s.orelse)
        elif isinstance(s, ast.While):
            for _ in range(2):
                self._visit(s)
                self._expr(s.test)
                self._branches(s.body, [])
            self._body(s.orelse)
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                self._expr(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars,
                               self.expr_tainted(item.context_expr))
            self._body(s.body)
        elif isinstance(s, ast.Try):
            self._body(s.body)
            self._branches(*[h.body for h in s.handlers], s.orelse)
            self._body(s.finalbody)
        elif isinstance(s, ast.Assign):
            self._expr(s.value)
            for tgt in s.targets:
                self._expr(tgt)
                self._bind(tgt, self.expr_tainted(s.value))
        elif isinstance(s, ast.AnnAssign):
            self._expr(s.value)
            if s.value is not None:
                self._bind(s.target, self.expr_tainted(s.value)
                           or _is_tensor_annotation(s.annotation))
        elif isinstance(s, ast.AugAssign):
            self._expr(s.value)
            self._expr(s.target)
            if self.expr_tainted(s.value):
                self._bind(s.target, True)
        else:                          # return, expr, assert, raise, ...
            self._visit(s)
            for child in ast.iter_child_nodes(s):
                if isinstance(child, ast.expr):
                    self._expr(child)


class TorchHostSyncRule(Rule):
    rule_id = "torch-host-sync"
    description = ("no host wait on the card inside the quantum hot path "
                   "(one sanctioned sync per quantum)")

    def check(self, ctx: AnalysisContext) -> list[Violation]:
        device_attrs = device_attr_names(ctx)
        self_attrs = class_device_attrs(ctx, device_attrs)
        out: list[Violation] = []
        for qual in sorted(hot_slice(ctx)):
            info = ctx.graph.functions[qual]
            found: dict[tuple, Violation] = {}
            scan = TaintScan(device_attrs, self_attrs.get(info.cls, set()))
            where = f"in hot path ({qual.split(':', 1)[1]})"

            def visit(node, sf=info.sf, scan=scan, where=where,
                      found=found):
                for v in self._sinks(sf, node, scan, where):
                    found.setdefault((v.line, v.col, v.message), v)

            scan.run(info.node, visit)
            out.extend(found.values())
        return out

    def _sinks(self, sf, node: ast.AST, scan: TaintScan,
               where: str) -> list[Violation]:
        """The violations at one node, under the scan's current taint."""
        def flag(message, at=node):
            return [self.violation(sf, node, f"{message} {where}",
                                   line=at.lineno, col=at.col_offset)]

        def truth(test, what):
            if scan.expr_tainted(test):
                return flag(f"{what} of a device tensor implicitly syncs",
                            test)
            return []

        if isinstance(node, ast.Call):
            name = astutil.dotted_name(node.func) or ""
            if name == "torch.cuda.synchronize":
                return flag("torch.cuda.synchronize() waits for the whole "
                            "card")
            if isinstance(node.func, ast.Attribute):
                meth = node.func.attr
                if meth == "synchronize":
                    return flag(f"{name or meth}() blocks the host on an "
                                f"event or stream")
                on_device = scan.expr_tainted(node.func.value)
                if meth in {"item", "cpu", "tolist", "numpy"} and on_device:
                    return flag(f".{meth}() copies a device tensor to the "
                                f"host and waits for it")
                if meth == "to" and on_device and _to_cpu(node):
                    return flag(".to('cpu') copies a device tensor to the "
                                "host and waits for it")
            if name in {"int", "float", "bool"} and node.args and \
                    scan.expr_tainted(node.args[0]):
                return flag(f"{name}() of a device tensor forces a host "
                            f"sync")
            if name in {"np.asarray", "np.array", "numpy.asarray",
                        "numpy.array"} and node.args and \
                    scan.expr_tainted(node.args[0]):
                return flag(f"{name}() of a device tensor forces a "
                            f"device→host copy")
        elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
            return truth(node.test, "truth test")
        elif isinstance(node, ast.Assert):
            return truth(node.test, "assert")
        elif isinstance(node, ast.BoolOp):
            return [v for val in node.values
                    for v in truth(val, "and/or")]
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            return truth(node.operand, "`not`")
        return []


def class_device_attrs(ctx: AnalysisContext,
                       device_attrs: set[str]) -> dict[str, set[str]]:
    """Class name -> the ``self.x`` attributes some method of the class
    binds to a device value (two passes: ``self.t0 = self.dev[0]``)."""
    out: dict[str, set[str]] = {}
    for _ in range(2):
        for info in ctx.graph.functions.values():
            if info.cls is None:
                continue
            attrs = out.setdefault(info.cls, set())
            scan = TaintScan(device_attrs, attrs)
            for node in ast.walk(info.node):
                if isinstance(node, ast.Assign) and \
                        scan.expr_tainted(node.value):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Attribute) and isinstance(
                                tgt.value, ast.Name) and \
                                tgt.value.id == "self":
                            attrs.add(tgt.attr)
    return out


def hot_slice(ctx: AnalysisContext) -> set[str]:
    """Quals of the functions reachable from the port's hot roots."""
    roots: list[str] = []
    for suffix in HOT_ROOTS:
        roots.extend(ctx.graph.find(suffix))
    return ctx.graph.reachable(roots)


register(TorchHostSyncRule())
