"""Whole-program index: symbol table + call graph across modules.

A per-file closure goes blind exactly where the port keeps its hazards:
a helper in ``core/hdb.py`` called from ``data/pipeline.dedup_corpus``
(which opens the ``dedup.*`` ranges) is on the hot path at runtime but
invisible to a closure of ``hdb.py`` alone. This module is the phase-1
*index* of the two-phase run: parse every file, resolve imports into a
project-wide symbol table, build the call graph, and close hot-path
reachability over it; the phase-2 *check* then runs the per-module rule
pack with each module's ``hot_reachable`` set extended by the
cross-module closure.

Eager PyTorch has no jit, so the roots are the functions a profiler
trace already names as hot: every function that opens a
``torch.profiler.record_function(...)`` range, and every function that
launches a ``_build.Kernel`` instance (the kernel wrappers).

What the index resolves (and what it deliberately does not):

- absolute imports (``import repro.core.hdb``, ``from repro.core.hdb
  import intersect_keys``) and relative imports at any level
  (``from . import routing``, ``from ..kernels import pairs``);
- package re-exports: ``from ..kernels import pairs as pk`` followed by
  ``pk.pack_sort_words(...)`` follows ``kernels/pairs/__init__.py``'s
  own ``from .ops import pack_sort_words`` chain (bounded depth), and
  ``import *`` falls back to searching the star-imported module;
- methods bound by class: ``self.m(...)`` resolves inside the enclosing
  ``ClassDef`` only (no inheritance walk, no duck typing);
- ``functools.partial(fn, ...)`` targets count as called.

Known imprecision (documented in ``RULES.md``): dynamic dispatch
(``getattr``, dict-of-functions), reflection, monkey-patching, and
``obj.method()`` on values of unknown type are not resolved — the graph
under-approximates there and rules stay quiet rather than guess.

The index also collects the project's *mesh-axis universe* for the R006
collective-contract rule: dim names (and literal sizes) declared by
``init_device_mesh("cuda", (2, 4), mesh_dim_names=("pod", "data"))`` /
``DeviceMesh(..., mesh_dim_names=...)`` constructions plus literal
``axis_names=("data",)`` parameter defaults.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .engine import ModuleContext, dotted_name

# names whose literal defaults declare mesh axes (see module docstring)
_AXIS_PARAM_NAMES = {"axis_name", "axis_names", "axes", "mesh_dim_names"}
_RESOLVE_DEPTH = 8  # re-export chains are short; bound against cycles

Symbol = Tuple[str, str]  # (module name, bare function/method name)


def module_name_for(path: str) -> str:
    """Dotted module name from the file's package-root-relative path.

    Walks up through directories containing ``__init__.py`` (the package
    chain); files outside any package get their bare stem, so standalone
    scripts (benchmarks, tests) still index and cross-resolve by name.
    """
    path = os.path.abspath(path)
    d, base = os.path.split(path)
    stem = base[:-3] if base.endswith(".py") else base
    parts: List[str] = [] if stem == "__init__" else [stem]
    while os.path.isfile(os.path.join(d, "__init__.py")):
        d, pkg = os.path.split(d)
        parts.append(pkg)
    return ".".join(reversed(parts)) or stem


class ModuleInfo:
    """Import bindings + class table of one parsed module."""

    def __init__(self, ctx: ModuleContext, name: str):
        self.ctx = ctx
        self.path = ctx.path
        self.name = name
        self.is_package = ctx.path.endswith("__init__.py")
        # the package relative imports resolve against
        self.package = name if self.is_package else name.rpartition(".")[0]
        # local name -> ("mod", module) | ("sym", module, symbol)
        self.bindings: Dict[str, Tuple[str, ...]] = {}
        # full dotted module names bound by plain `import a.b.c`
        self.imported_modules: Set[str] = set()
        self.star_imports: List[str] = []
        # class name -> {method name -> def node}
        self.classes: Dict[str, Dict[str, ast.AST]] = {}
        # def bare name -> enclosing class name (methods only)
        self.method_class: Dict[str, str] = {}
        self._collect_imports()
        self._collect_classes()

    def _rel_base(self, level: int) -> Optional[str]:
        """Package that a level-``level`` relative import resolves in."""
        base = self.package
        for _ in range(level - 1):
            if not base:
                return None
            base = base.rpartition(".")[0]
        return base if base else None

    def _collect_imports(self) -> None:
        for node in ast.walk(self.ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.imported_modules.add(alias.name)
                    if alias.asname:
                        self.bindings[alias.asname] = ("mod", alias.name)
            elif isinstance(node, ast.ImportFrom):
                if node.level > 0:
                    base = self._rel_base(node.level)
                    if base is None:
                        continue
                    mod = f"{base}.{node.module}" if node.module else base
                else:
                    mod = node.module or ""
                for alias in node.names:
                    if alias.name == "*":
                        self.star_imports.append(mod)
                        continue
                    bound = alias.asname or alias.name
                    self.bindings[bound] = ("sym", mod, alias.name)

    def _collect_classes(self) -> None:
        for node in ast.walk(self.ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            methods = {
                ch.name: ch for ch in node.body
                if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            self.classes[node.name] = methods
            for m in methods:
                self.method_class.setdefault(m, node.name)


class Project:
    """Phase-1 index over a set of modules; closes hot-path reachability.

    Construction runs the whole index: per-module import/class tables,
    the global call graph, hot-root discovery, the cross-module
    reachability closure (injected into each ``ModuleContext`` via
    ``extend_hot_reachable``), and the R006 mesh-axis universe. Every
    ``ModuleContext`` gets ``ctx.project = self`` so rules can consult
    project-wide facts.
    """

    def __init__(self, contexts: Iterable[ModuleContext]):
        self.modules: Dict[str, ModuleInfo] = {}
        self.by_path: Dict[str, ModuleInfo] = {}
        for ctx in contexts:
            mi = ModuleInfo(ctx, module_name_for(ctx.path))
            self.modules[mi.name] = mi
            self.by_path[ctx.path] = mi
        # mesh-axis universe (R006)
        self.declared_axes: Set[str] = set()
        # axis name -> literal size, or None when declarations disagree
        self.axis_sizes: Dict[str, Optional[int]] = {}
        self._collect_axis_universe()
        # call graph + reachability
        self.edges: Dict[Symbol, Set[Symbol]] = {}
        self.hot_roots: Set[Symbol] = set()
        self.hot_reachable: Set[Symbol] = set()
        self._build_call_graph()
        self._close_reachability()
        for mi in self.modules.values():
            local = {s for (m, s) in self.hot_reachable if m == mi.name}
            mi.ctx.extend_hot_reachable(local)
            mi.ctx.project = self

    # -- symbol resolution ---------------------------------------------

    def _resolve_symbol(self, mod: str, sym: str,
                        depth: int = 0) -> Optional[Symbol]:
        """(module, symbol) of the def ``mod.sym`` names, following
        re-export chains through indexed modules."""
        if depth > _RESOLVE_DEPTH:
            return None
        mi = self.modules.get(mod)
        if mi is None:
            return None
        if sym in mi.ctx.functions:
            return (mod, sym)
        b = mi.bindings.get(sym)
        if b is not None:
            if b[0] == "sym":
                return self._resolve_symbol(b[1], b[2], depth + 1)
            return None  # a submodule, not a callable symbol
        for star in mi.star_imports:
            got = self._resolve_symbol(star, sym, depth + 1)
            if got is not None:
                return got
        return None

    def _resolve_dotted(self, mi: ModuleInfo, d: str) -> Optional[Symbol]:
        """Resolve a dotted reference ``a.b.c`` in module ``mi``."""
        head, _, rest = d.partition(".")
        if not rest:
            # bare name: local def wins, then from-imports, then stars
            if head in mi.ctx.functions:
                return (mi.name, head)
            b = mi.bindings.get(head)
            if b is not None and b[0] == "sym":
                return self._resolve_symbol(b[1], b[2])
            for star in mi.star_imports:
                got = self._resolve_symbol(star, head)
                if got is not None:
                    return got
            return None
        b = mi.bindings.get(head)
        base: Optional[str] = None
        if b is not None:
            if b[0] == "mod":
                base = b[1]
            elif b[0] == "sym":
                # `from ..kernels import pairs` binds the submodule
                cand = f"{b[1]}.{b[2]}"
                base = cand if cand in self.modules else None
        elif any(m == head or m.startswith(head + ".")
                 for m in mi.imported_modules):
            base = head
        if base is None:
            return None
        parts = rest.split(".")
        for i, part in enumerate(parts):
            if i == len(parts) - 1:
                return self._resolve_symbol(base, part)
            nxt = f"{base}.{part}"
            if nxt not in self.modules:
                # not an indexed submodule; try it as a re-exported one
                got = self.modules.get(base)
                if got is not None:
                    b2 = got.bindings.get(part)
                    if b2 is not None and b2[0] == "sym" \
                            and f"{b2[1]}.{b2[2]}" in self.modules:
                        nxt = f"{b2[1]}.{b2[2]}"
                    else:
                        return None
                else:
                    return None
            base = nxt
        return None

    def resolve_call(self, ctx: ModuleContext, node: ast.AST,
                     encl_class: Optional[str] = None) -> Optional[Symbol]:
        """Symbol a call/reference expression targets, or None."""
        mi = self.by_path.get(ctx.path)
        if mi is None:
            return None
        if isinstance(node, ast.Name):
            return self._resolve_dotted(mi, node.id)
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            cls = encl_class
            if cls is not None and node.attr in mi.classes.get(cls, {}):
                return (mi.name, node.attr)
            return None
        d = dotted_name(node)
        if d is not None:
            return self._resolve_dotted(mi, d)
        return None

    # -- call graph ----------------------------------------------------

    def _enclosing_class(self, mi: ModuleInfo, fn_name: str) -> Optional[str]:
        return mi.method_class.get(fn_name)

    def _callees(self, mi: ModuleInfo, fn_name: str,
                 fn: ast.AST) -> Set[Symbol]:
        ctx = mi.ctx
        encl_class = self._enclosing_class(mi, fn_name)
        out: Set[Symbol] = set()
        for node in ast.walk(fn):
            target: Optional[ast.AST] = None
            if isinstance(node, ast.Call):
                target = node.func
                # functools.partial(fn, ...): the wrapped fn is "called"
                if ctx.is_partial_expr(node.func) and node.args:
                    got = self.resolve_call(ctx, node.args[0], encl_class)
                    if got is not None:
                        out.add(got)
            elif isinstance(node, (ast.Name, ast.Attribute)):
                # bare reference: fn passed as a value (callbacks, thread
                # targets); Attribute covers `mod.fn` references
                target = node
            if target is None:
                continue
            got = self.resolve_call(ctx, target, encl_class)
            if got is not None:
                out.add(got)
        return out

    def _build_call_graph(self) -> None:
        for mi in self.modules.values():
            ctx = mi.ctx
            for name, fn in ctx.functions.items():
                self.edges[(mi.name, name)] = self._callees(mi, name, fn)
            # hot roots found by the per-file pass (ranges, kernel launches)
            for name in ctx.hot_roots:
                self.hot_roots.add((mi.name, name))

    def _close_reachability(self) -> None:
        reach = set(self.hot_roots)
        frontier = list(reach)
        while frontier:
            sym = frontier.pop()
            for callee in self.edges.get(sym, ()):
                if callee not in reach:
                    reach.add(callee)
                    frontier.append(callee)
        self.hot_reachable = reach

    # -- mesh-axis universe (R006) --------------------------------------

    @staticmethod
    def _literal_strs(node: ast.AST) -> Optional[List[str]]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return [node.value]
        if isinstance(node, (ast.Tuple, ast.List)):
            out = []
            for el in node.elts:
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    out.append(el.value)
                else:
                    return None
            return out
        return None

    @staticmethod
    def _literal_ints(node: ast.AST) -> Optional[List[int]]:
        if isinstance(node, (ast.Tuple, ast.List)):
            out = []
            for el in node.elts:
                if isinstance(el, ast.Constant) and isinstance(el.value, int):
                    out.append(el.value)
                else:
                    return None
            return out
        return None

    def _declare_axes(self, names: Sequence[str],
                      sizes: Optional[Sequence[int]] = None) -> None:
        for i, name in enumerate(names):
            self.declared_axes.add(name)
            size = sizes[i] if sizes is not None and i < len(sizes) else None
            if size is None:
                self.axis_sizes.setdefault(name, None)
            elif name not in self.axis_sizes:
                self.axis_sizes[name] = size
            elif self.axis_sizes[name] != size:
                self.axis_sizes[name] = None  # ambiguous across decls

    @staticmethod
    def _axis_arg_variants(ctx: ModuleContext, use_site: ast.AST,
                           node: Optional[ast.AST],
                           depth: int = 0) -> List[ast.AST]:
        """Literal candidates a mesh-constructor argument can denote.

        Follows local names to their assignments and splits conditional
        expressions into both branches (``dims = (...) if multi else
        (...)``), in source order so names/sizes variants zip branchwise.
        """
        if node is None or depth > 4:
            return []
        if isinstance(node, ast.IfExp):
            return (Project._axis_arg_variants(ctx, use_site, node.body,
                                               depth + 1)
                    + Project._axis_arg_variants(ctx, use_site, node.orelse,
                                                 depth + 1))
        if isinstance(node, ast.Name):
            fn = ctx.enclosing_function(use_site)
            scopes = [fn] if fn is not None else []
            scopes.append(ctx.tree)
            for scope in scopes:
                for n in ast.walk(scope):
                    if isinstance(n, ast.Assign) and any(
                            isinstance(t, ast.Name) and t.id == node.id
                            for t in n.targets):
                        return Project._axis_arg_variants(
                            ctx, use_site, n.value, depth + 1)
            return []
        return [node]

    def _collect_axis_universe(self) -> None:
        for mi in self.modules.values():
            for node in ast.walk(mi.ctx.tree):
                if isinstance(node, ast.Call):
                    tail = (dotted_name(node.func) or "").rpartition(".")[2]
                    if tail not in ("DeviceMesh", "init_device_mesh"):
                        continue
                    names_node: Optional[ast.AST] = None
                    sizes_node: Optional[ast.AST] = None
                    for kw in node.keywords:
                        if kw.arg == "mesh_dim_names":
                            names_node = kw.value
                        elif kw.arg == "mesh_shape":
                            sizes_node = kw.value
                    # init_device_mesh(device_type, mesh_shape, ...); a
                    # DeviceMesh's sizes are those of its rank tensor
                    if tail == "init_device_mesh" and len(node.args) >= 2:
                        sizes_node = node.args[1]
                    name_vars = [
                        got for v in self._axis_arg_variants(
                            mi.ctx, node, names_node)
                        if (got := self._literal_strs(v))
                    ]
                    size_vars = [
                        self._literal_ints(v)
                        for v in self._axis_arg_variants(
                            mi.ctx, node, sizes_node)
                    ]
                    branchwise = len(size_vars) == len(name_vars)
                    for i, names in enumerate(name_vars):
                        self._declare_axes(
                            names, size_vars[i] if branchwise else None)
                elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    # axis_names=("data",) parameter defaults declare the
                    # dims a library module is written against
                    args = node.args
                    pos = list(args.posonlyargs) + list(args.args)
                    defaults = list(args.defaults)
                    pairs = list(zip(pos[len(pos) - len(defaults):], defaults))
                    pairs += [(a, d) for a, d in
                              zip(args.kwonlyargs, args.kw_defaults)
                              if d is not None]
                    for a, dflt in pairs:
                        if a.arg in _AXIS_PARAM_NAMES:
                            names = self._literal_strs(dflt)
                            if names:
                                self._declare_axes(names)

    # -- cache support ---------------------------------------------------

    def reach_digest_parts(self, ctx: ModuleContext) -> List[str]:
        """Project-state inputs a module's findings depend on, for the
        on-disk cache key: the cross-module reachability injected into
        this module and the R006 axis universe."""
        mi = self.by_path.get(ctx.path)
        injected = sorted(
            s for (m, s) in self.hot_reachable
            if mi is not None and m == mi.name)
        axes = sorted(f"{a}={self.axis_sizes.get(a)}"
                      for a in self.declared_axes)
        return injected + ["|"] + axes
