"""A heuristic, whole-corpus call graph over the scanned files (the
port's copy of the reference analyzer's, widened for the port's names).

The graph is deliberately approximate — this is a linter, not a type
checker.  Names are resolved in four passes of decreasing confidence:

1. ``self.method(...)`` → a method on the same class.
2. A local/imported name (``from repro.x import y``; ``import m as z``)
   → the function/class it binds in the corpus.
3. ``self.attr.meth(...)`` → ``Class.meth`` when ``attr``'s class is
   known from a ``self.attr = ClassName(...)`` assignment or a class
   annotation anywhere in the corpus.
4. A unique bare method name across the whole corpus (skipped when the
   name is defined in more than one class — ambiguity beats noise).

Calls inside nested ``def``s (graphed closures such as the quantum body
in ``VersionCache.quantum``) are attributed to the outermost enclosing
function, so the model code a quantum runs is pulled into hot-path
slices.

The port binds names by assignment rather than by a second ``def``
(so that the reference's unique-name pass keeps resolving when both
packages are scanned together).  Every call is therefore resolved
twice: once by the four passes above over ``def``s alone, exactly as
the reference's graph does, and once over tables widened by

* class-attribute aliases: ``step = step_once`` in a class body makes
  ``obj.step(...)`` a call of ``step_once``;
* module-level aliases: ``ServingEngine = TorchServingEngine`` makes
  ``ServingEngine(...)`` a call of ``TorchServingEngine.__init__``, and
  ``apply_moe = capacity_moe`` makes ``apply_moe(...)`` one of
  ``capacity_moe``;
* attribute types built through a class alias:
  ``self.book = DeadlineBook(tiers)`` types ``book`` as the class
  ``DeadlineBook`` names.

The widened pass also lets a name bound inside the caller (a parameter,
a local, a nested ``def``) shadow the corpus's functions of that name.

A call's edges are the union of both answers, so the graph holds every
edge the reference's graph holds over the same files.
"""
from __future__ import annotations

import ast
import dataclasses

from repro_torch.analysis import astutil
from repro_torch.analysis.astutil import SourceFile


@dataclasses.dataclass
class FunctionInfo:
    """One top-level function or method in the corpus."""
    qual: str                      # "module:Class.method" or "module:func"
    sf: SourceFile
    node: ast.AST                  # FunctionDef / AsyncFunctionDef
    cls: str | None                # owning class name, if a method


class CallGraph:
    def __init__(self, files: list[SourceFile]):
        self.files = [f for f in files if f.tree is not None]
        self.functions: dict[str, FunctionInfo] = {}
        # method name -> list of quals that define it (for passes 1 & 4)
        self.by_method: dict[str, list[str]] = {}
        # bare function name -> list of quals (for pass 2 resolution)
        self.by_name: dict[str, list[str]] = {}
        # class name -> {method name -> qual}
        self.classes: dict[str, dict[str, str]] = {}
        # attr name -> class name, learned from `self.attr = Class(...)`
        # and `attr: Class` annotations, corpus-wide
        self.attr_types: dict[str, str] = {}
        self.edges: dict[str, set[str]] = {}
        self._local_cache: dict[str, set[str]] = {}
        # alias name -> {module -> class name} (module-level class aliases)
        self.class_aliases: dict[str, dict[str, str]] = {}
        self._index()
        self._infer_attr_types()
        # the widened tables: defs plus the names bound by assignment
        self.wide_classes = {c: dict(m) for c, m in self.classes.items()}
        self.wide_by_method = {n: list(q) for n, q in self.by_method.items()}
        self.wide_by_name = {n: list(q) for n, q in self.by_name.items()}
        self._index_aliases()
        self.wide_attr_types = dict(self.attr_types)
        self._infer_alias_attr_types()
        self._build_edges()

    # -- indexing -----------------------------------------------------
    def _index(self) -> None:
        for sf in self.files:
            for node in ast.walk(sf.tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if astutil.enclosing_function(node) is not None:
                    continue  # nested def: owned by its outer function
                qualname = astutil.func_qualname(node)
                cls = None
                owner = astutil.enclosing(node, ast.ClassDef)
                if isinstance(owner, ast.ClassDef):
                    cls = owner.name
                qual = f"{sf.module}:{qualname}"
                info = FunctionInfo(qual=qual, sf=sf, node=node, cls=cls)
                self.functions[qual] = info
                self.by_name.setdefault(node.name, []).append(qual)
                if cls is not None:
                    self.by_method.setdefault(node.name, []).append(qual)
                    self.classes.setdefault(cls, {})[node.name] = qual

    def _infer_attr_types(self) -> None:
        class_names = set(self.classes)
        for sf in self.files:
            for node in ast.walk(sf.tree):
                # self.attr = ClassName(...)
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    tgt = node.targets[0]
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"
                            and isinstance(node.value, ast.Call)):
                        cname = astutil.dotted_name(node.value.func)
                        if cname:
                            tail = cname.split(".")[-1]
                            if tail in class_names:
                                self.attr_types[tgt.attr] = tail
                # attr: ClassName  (class-level or self.attr annotation)
                if isinstance(node, ast.AnnAssign):
                    tgt = node.target
                    attr = None
                    if isinstance(tgt, ast.Name):
                        attr = tgt.id
                    elif (isinstance(tgt, ast.Attribute)
                          and isinstance(tgt.value, ast.Name)
                          and tgt.value.id == "self"):
                        attr = tgt.attr
                    if attr is not None:
                        ann = astutil.dotted_name(node.annotation)
                        if ann:
                            tail = ann.split(".")[-1]
                            if tail in class_names:
                                self.attr_types[attr] = tail
        # constructor-style "engine = ServingEngine(...)" locals too:
        for sf in self.files:
            for node in ast.walk(sf.tree):
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and isinstance(node.value, ast.Call)):
                    cname = astutil.dotted_name(node.value.func)
                    if cname and cname.split(".")[-1] in class_names:
                        self.attr_types.setdefault(
                            node.targets[0].id, cname.split(".")[-1])

    def _index_aliases(self) -> None:
        for sf in self.files:
            classes_here = {n.name for n in sf.tree.body
                            if isinstance(n, ast.ClassDef)}
            for node in sf.tree.body:
                pair = _alias_pair(node)
                if pair and pair[1] in classes_here:
                    self.class_aliases.setdefault(pair[0], {})[
                        sf.module] = pair[1]
                elif pair:
                    qual = f"{sf.module}:{pair[1]}"
                    if qual in self.functions:
                        self.wide_by_name.setdefault(pair[0], []).append(
                            qual)
                elif isinstance(node, ast.ClassDef):
                    methods = self.wide_classes.setdefault(node.name, {})
                    for stmt in node.body:
                        pair = _alias_pair(stmt)
                        if pair and pair[1] in methods:
                            qual = methods[pair[1]]
                            methods[pair[0]] = qual
                            self.wide_by_method.setdefault(
                                pair[0], []).append(qual)

    def _alias_class(self, name: str, mod: str, own: str) -> str | None:
        """The class a module-level alias ``name`` binds: the one in the
        module it was imported from, else in the caller's own module,
        else the only one."""
        where = self.class_aliases.get(name)
        if not where:
            return None
        if mod in where:
            return where[mod]
        if own in where:
            return where[own]
        if len(where) == 1:
            return next(iter(where.values()))
        return None

    def _infer_alias_attr_types(self) -> None:
        """``attr_types`` for classes built or annotated through a class
        alias; a type learned from a ``def``'d class name keeps priority."""
        for sf in self.files:
            imports = self._imports_of(sf)
            for node in ast.walk(sf.tree):
                attr, cname = None, None
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.value, ast.Call):
                    tgt = node.targets[0]
                    if isinstance(tgt, ast.Name):
                        attr = tgt.id
                    elif (isinstance(tgt, ast.Attribute)
                          and isinstance(tgt.value, ast.Name)
                          and tgt.value.id == "self"):
                        attr = tgt.attr
                    cname = astutil.dotted_name(node.value.func)
                elif isinstance(node, ast.AnnAssign):
                    tgt = node.target
                    if isinstance(tgt, ast.Name):
                        attr = tgt.id
                    elif (isinstance(tgt, ast.Attribute)
                          and isinstance(tgt.value, ast.Name)
                          and tgt.value.id == "self"):
                        attr = tgt.attr
                    cname = astutil.dotted_name(node.annotation)
                if not (attr and cname):
                    continue
                tail = cname.split(".")[-1]
                target = imports.get(tail, tail)
                mod = ".".join(target.split(".")[:-1])
                cls = self._alias_class(tail, mod, sf.module)
                if cls in self.classes:
                    self.wide_attr_types.setdefault(attr, cls)

    # -- name resolution ----------------------------------------------
    def _imports_of(self, sf: SourceFile) -> dict[str, str]:
        """local alias -> dotted module or module.symbol target."""
        out: dict[str, str] = {}
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for al in node.names:
                    out[al.asname or al.name.split(".")[0]] = al.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for al in node.names:
                    out[al.asname or al.name] = f"{node.module}.{al.name}"
        return out

    def _resolve_call(self, sf: SourceFile, imports: dict[str, str],
                      caller: FunctionInfo, call: ast.Call,
                      wide: bool = False) -> str | None:
        """Resolve ``call`` over the ``def`` tables (the reference's
        answer) or, with ``wide``, over the tables widened by aliases."""
        if wide:
            classes, by_method = self.wide_classes, self.wide_by_method
            by_name, attr_types = self.wide_by_name, self.wide_attr_types
        else:
            classes, by_method = self.classes, self.by_method
            by_name, attr_types = self.by_name, self.attr_types
        fn = call.func
        # self.method(...)
        if (isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
                and fn.value.id == "self" and caller.cls is not None):
            hit = classes.get(caller.cls, {}).get(fn.attr)
            if hit:
                return hit
            # inherited / mixin method: fall through to unique-name pass
        name = astutil.dotted_name(fn)
        if name is None and isinstance(fn, ast.Attribute):
            name = fn.attr  # x().meth / x[0].meth → bare method name
        if name is None:
            return None
        parts = name.split(".")
        # bare local or imported function name
        if len(parts) == 1:
            if wide and parts[0] not in imports and \
                    parts[0] in self._locals_of(caller):
                return None    # a parameter, local or nested def shadows it
            target = imports.get(parts[0], parts[0])
            tail = target.split(".")[-1]
            mod = ".".join(target.split(".")[:-1])
            for qual in by_name.get(tail, []):
                info = self.functions[qual]
                if info.cls is None and (not mod
                                         or info.sf.module == mod
                                         or qual.startswith(mod + ":")):
                    return qual
            # class constructor → __init__ (through an alias when wide)
            aliased = self._alias_class(tail, mod, sf.module) \
                if wide else None
            if aliased:
                return classes.get(aliased, {}).get("__init__")
            if tail in classes:
                return classes[tail].get("__init__")
            cand = by_name.get(parts[0], [])
            if len(cand) == 1:
                return cand[0]
            return None
        # obj.meth(...) or module.func(...) or self.attr.meth(...)
        head, meth = parts[0], parts[-1]
        if head == "self" and len(parts) >= 3:
            head = parts[1]  # self.attr.meth → attr's class
        cls = attr_types.get(head)
        if cls:
            hit = classes.get(cls, {}).get(meth)
            if hit:
                return hit
        # module alias: mod.func
        target = imports.get(head)
        if target:
            for qual in by_name.get(meth, []):
                info = self.functions[qual]
                if info.sf.module == target or info.sf.module.endswith(
                        "." + target.split(".")[-1]):
                    if info.cls is None:
                        return qual
            aliased = self._alias_class(meth, target, "") if wide else None
            if aliased:                # mod.Alias(...)
                return classes.get(aliased, {}).get("__init__")
            if meth in classes:  # mod.ClassName(...)
                return classes[meth].get("__init__")
        # unique method name across corpus (last resort; skip ambiguous)
        cand = by_method.get(meth, [])
        if len(cand) == 1:
            return cand[0]
        return None

    def _locals_of(self, caller: FunctionInfo) -> set[str]:
        """Names bound inside ``caller``: parameters, assignment and loop
        targets, nested ``def``s (``run`` in ``Model._run_blocks``)."""
        out = self._local_cache.get(caller.qual)
        if out is None:
            out = set()
            for node in ast.walk(caller.node):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if node is not caller.node:
                        out.add(node.name)
                elif isinstance(node, ast.arg):
                    out.add(node.arg)
                elif isinstance(node, ast.Name) and isinstance(
                        node.ctx, ast.Store):
                    out.add(node.id)
            self._local_cache[caller.qual] = out
        return out

    def _build_edges(self) -> None:
        for qual, info in self.functions.items():
            imports = self._imports_of(info.sf)
            callees: set[str] = set()
            for node in ast.walk(info.node):
                if isinstance(node, ast.Call):
                    for wide in (False, True):
                        tgt = self._resolve_call(info.sf, imports, info,
                                                 node, wide)
                        if tgt and tgt != qual:
                            callees.add(tgt)
            self.edges[qual] = callees

    # -- queries ------------------------------------------------------
    def find(self, suffix: str) -> list[str]:
        """All quals whose ``module:Qual.name`` ends with ``suffix``
        (match on Class.method or function-name boundaries)."""
        out = []
        for qual in self.functions:
            tail = qual.split(":", 1)[1]
            if tail == suffix or tail.endswith("." + suffix):
                out.append(qual)
        return out

    def reachable(self, roots: list[str]) -> set[str]:
        seen: set[str] = set()
        stack = [r for r in roots if r in self.functions]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(self.edges.get(cur, ()))
        return seen

    def callers_of(self, qual: str) -> set[str]:
        return {src for src, dsts in self.edges.items() if qual in dsts}

    def connected(self, roots: list[str]) -> set[str]:
        """Reachable-from-roots plus transitive callers of roots (used
        for the paged-leaf rule, where helpers both call and are called
        by the ``cache_specs`` anchor)."""
        seen = self.reachable(roots)
        frontier = [r for r in roots if r in self.functions]
        back: set[str] = set(frontier)
        while frontier:
            cur = frontier.pop()
            for caller in self.callers_of(cur):
                if caller not in back:
                    back.add(caller)
                    frontier.append(caller)
        return seen | back


def _alias_pair(node: ast.AST) -> tuple[str, str] | None:
    """``(alias, target)`` for a statement ``alias = target`` binding
    one bare name to another, else None."""
    if (isinstance(node, ast.Assign) and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Name)):
        return node.targets[0].id, node.value.id
    return None
