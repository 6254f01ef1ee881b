"""AST lint engine for the port's PyTorch/CUDA correctness contracts.

The port's correctness rests on exact bit-level contracts (a u64 held as
the bits of one int64, packed 62-bit sort words, ctypes kernel launches
with fixed argument lists) and its speed on hot paths that do not stop
to wait for the card. The parity tests and the runtime census
(``sync_census``) enforce them dynamically; this module enforces them
statically, before the code runs:

- ``ModuleContext`` parses one file and resolves the import aliases
  (torch, numpy, time), the function table, the hot-path roots (a
  function that opens a ``record_function`` range or launches a
  ``_build.Kernel``) and the hot-path call closure every rule keys off.
- ``analyze_paths`` runs in two phases: phase 1 parses every file and
  builds the whole-program index (``project.Project``: cross-module
  symbol table, call graph, hot-path closure, mesh-axis universe);
  phase 2 runs the rule pack per module, so R001/R003 reachability
  follows calls across module boundaries.
- Rules live in ``rules.py`` / ``rules_contracts.py`` and register
  themselves via ``register``; each is a pure function
  ``ModuleContext -> list[Finding]``, or ``None`` for a rule of the
  reference pack with no counterpart here (R005).
- ``# repro: noqa[R001]`` (or bare ``# repro: noqa``) on the finding's
  line, or on the FIRST line of the multi-line statement containing it,
  suppresses it; suppressed findings are counted, not fatal.
- Phase-2 results are cached on disk keyed by (mtime, size) of the file
  plus a digest of the engine version, the rule selection, and the
  cross-module facts the file's findings depend on (``AnalysisCache``).
- ``python -m repro_torch.analysis PATH...`` walks files/trees and exits
  nonzero on any unsuppressed finding; ``--format github`` emits workflow
  annotations and ``--warn-only`` reports without failing.

Type inference is a local-dataflow heuristic and call resolution skips
dynamic dispatch: rules aim to be precise on this codebase's idioms and
suppressible where intent is explicit, not sound in general (see
``RULES.md`` beside this file).
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
import sys
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

NOQA_RE = re.compile(r"#\s*repro:\s*noqa(?:\[(?P<rules>[A-Za-z0-9_,\s]*)\])?")

# bump when rules/engine change enough to invalidate cached findings
ANALYSIS_VERSION = "torch-1"
DEFAULT_CACHE = ".repro-torch-analysis.cache.json"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False

    def format(self) -> str:
        mark = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col + 1}: {self.rule} {self.message}{mark}"


@dataclasses.dataclass(frozen=True)
class Rule:
    """A rule of the pack: ``mirrors`` names the reference rule it is the
    counterpart of; ``check`` is None where it has no counterpart, and
    ``description`` then gives the reason."""

    id: str
    name: str
    description: str
    check: Optional[Callable[["ModuleContext"], List[Finding]]]
    mirrors: str


_REGISTRY: Dict[str, Rule] = {}


def register(rule_id: str, name: str, description: str, mirrors: str):
    """Decorator: add a ``ModuleContext -> [Finding]`` function to the registry."""

    def deco(fn):
        _REGISTRY[rule_id] = Rule(rule_id, name, description, fn, mirrors)
        return fn

    return deco


def register_without_counterpart(rule_id: str, mirrors: str, reason: str) -> None:
    """List a reference rule that has nothing to check in the port."""
    _REGISTRY[rule_id] = Rule(rule_id, "no-counterpart", reason, None, mirrors)


def all_rules() -> Dict[str, Rule]:
    # import for side effect: rules register on first use
    from . import rules, rules_contracts  # noqa: F401

    return dict(sorted(_REGISTRY.items()))


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` attribute chain -> "a.b.c", else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_tail(node: ast.AST) -> Optional[str]:
    """Last name of a call's target: ``f`` for ``f(...)`` and ``a.b.f(...)``."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


class ModuleContext:
    """Everything the rules need to know about one parsed source file."""

    def __init__(self, path: str, src: str, tree: ast.Module):
        self.path = path
        self.src = src
        self.lines = src.splitlines()
        self.tree = tree

        # import alias tables (alias name -> stands for module X)
        self.numpy_aliases: Set[str] = set()
        self.torch_aliases: Set[str] = set()
        self.functional_aliases: Set[str] = set()  # torch.nn.functional
        self.time_aliases: Set[str] = set()
        self.functools_aliases: Set[str] = set()
        # names bound by from-imports
        self.partial_names: Set[str] = set()       # from functools import partial
        self.perf_counter_names: Set[str] = set()
        self.record_function_names: Set[str] = set()
        self.imports_torchlike = False             # torch or the port imported

        # function table: name -> def node (module functions + methods;
        # later definitions win, matching runtime rebinding)
        self.functions: Dict[str, ast.AST] = {}
        # module-level names bound to a ``Kernel(...)`` launch handle
        self.kernel_names: Set[str] = set()
        self.hot_roots: Set[str] = set()
        self.hot_reachable: Set[str] = set()
        # set by project.Project after the phase-1 index is built; rules
        # may consult it for project-wide facts (None in single-file use)
        self.project = None
        # parent links for ancestry queries (loops, enclosing defs)
        self.parents: Dict[ast.AST, ast.AST] = {}

        self._collect_imports()
        self._collect_functions()
        self._collect_parents()
        self._collect_kernel_names()
        self._collect_hot_roots()
        self._close_reachability()

    # -- construction --------------------------------------------------

    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    bound = alias.asname or alias.name.split(".")[0]
                    top = alias.name.split(".")[0]
                    if alias.name == "numpy":
                        self.numpy_aliases.add(bound)
                    elif alias.name == "torch.nn.functional" and alias.asname:
                        self.functional_aliases.add(alias.asname)
                        self.imports_torchlike = True
                    elif top == "torch":
                        # `import torch.distributed as dist` binds no torch
                        if alias.name == "torch" or not alias.asname:
                            self.torch_aliases.add(bound)
                        self.imports_torchlike = True
                    elif alias.name == "time":
                        self.time_aliases.add(bound)
                    elif alias.name == "functools":
                        self.functools_aliases.add(bound)
                    elif top == "repro_torch":
                        self.imports_torchlike = True
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if node.level > 0 or mod.split(".")[0] in ("torch", "repro_torch"):
                    self.imports_torchlike = True
                for alias in node.names:
                    bound = alias.asname or alias.name
                    if mod == "torch.nn" and alias.name == "functional":
                        self.functional_aliases.add(bound)
                    elif (mod in ("torch.profiler", "torch.autograd.profiler")
                          and alias.name == "record_function"):
                        self.record_function_names.add(bound)
                    elif mod == "functools" and alias.name == "partial":
                        self.partial_names.add(bound)
                    elif mod == "time" and alias.name == "perf_counter":
                        self.perf_counter_names.add(bound)

    def _collect_functions(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node

    def _collect_parents(self) -> None:
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    # -- hot-path root discovery ---------------------------------------

    def is_torch_attr(self, node: ast.AST, *paths: str) -> bool:
        """Is ``node`` ``torch.<path>`` (through any torch alias) for one of
        ``paths``, e.g. ``is_torch_attr(n, "cuda.synchronize")``?"""
        d = dotted_name(node)
        if not d or "." not in d:
            return False
        root, _, rest = d.partition(".")
        return root in self.torch_aliases and rest in paths

    def is_partial_expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name) and node.id in self.partial_names:
            return True
        d = dotted_name(node)
        return bool(d) and any(d == f"{a}.partial" for a in self.functools_aliases)

    def is_record_function(self, node: ast.AST) -> bool:
        """``record_function(...)`` / ``torch.profiler.record_function(...)``."""
        if not isinstance(node, ast.Call):
            return False
        if isinstance(node.func, ast.Name):
            return node.func.id in self.record_function_names
        return self.is_torch_attr(node.func, "profiler.record_function",
                                  "autograd.profiler.record_function")

    def _collect_kernel_names(self) -> None:
        for node in self.tree.body:
            if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                    and call_tail(node.value.func) == "Kernel"):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.kernel_names.add(t.id)

    def enclosing_function(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None

    def _collect_hot_roots(self) -> None:
        for node in ast.walk(self.tree):
            root = None
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    self.is_record_function(i.context_expr) for i in node.items):
                root = self.enclosing_function(node)
            elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                  and node.func.id in self.kernel_names):
                root = self.enclosing_function(node)
            if root is not None and self.functions.get(root.name) is root:
                self.hot_roots.add(root.name)

    def _called_local_names(self, fn) -> Set[str]:
        called: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Name):
                    called.add(node.func.id)
                elif (
                    isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"
                ):
                    called.add(node.func.attr)
            # bare references (fn passed as a value)
            elif isinstance(node, ast.Name) and node.id in self.functions:
                called.add(node.id)
        return called

    def _close_reachability(self) -> None:
        reach = set(self.hot_roots)
        frontier = list(reach)
        while frontier:
            fn_name = frontier.pop()
            fn = self.functions.get(fn_name)
            if fn is None:
                continue
            for callee in self._called_local_names(fn):
                if callee in self.functions and callee not in reach:
                    reach.add(callee)
                    frontier.append(callee)
        self.hot_reachable = reach

    def extend_hot_reachable(self, names: Iterable[str]) -> None:
        """Inject cross-module reachability facts (phase-1 index).

        ``names`` are bare local def names proven hot-path-reachable
        through the project call graph; R001/R003 pick them up exactly
        like locally-discovered reachability.
        """
        self.hot_reachable |= {n for n in names if n in self.functions}

    def finding(self, rule_id: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule_id, self.path, node.lineno, node.col_offset, message)


def _noqa_rules_on(ctx: ModuleContext, lineno: int) -> Optional[Set[str]]:
    """Rule ids a noqa comment on ``lineno`` names (empty set = all)."""
    line = ctx.lines[lineno - 1] if 0 < lineno <= len(ctx.lines) else ""
    m = NOQA_RE.search(line)
    if m is None:
        return None
    rules = m.group("rules")
    if rules is None:
        return set()
    return {r.strip() for r in rules.split(",") if r.strip()}


def _statement_spans(ctx: ModuleContext) -> List[tuple]:
    """(first_line, last_line) spans a first-line noqa covers.

    A simple statement (a multi-line call, assignment, return, ...)
    covers its full ``lineno..end_lineno`` span. A compound statement
    (if/for/while/with/def/try) covers only its HEADER, up to the line
    before its first body statement, so a noqa on ``if (...):`` cannot
    blanket-suppress the whole block under it.
    """
    spans = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.stmt):
            continue
        end = getattr(node, "end_lineno", None) or node.lineno
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.stmt):
            end = max(node.lineno, body[0].lineno - 1)
        if end > node.lineno:
            spans.append((node.lineno, end))
    return spans


def noqa_map(ctx: ModuleContext) -> Dict[int, Set[str]]:
    """Line -> the rules a noqa suppresses there (empty set = all rules):
    the line's own comment, and a comment on the first line of a
    multi-line statement for every line of that statement."""
    span_rules: Dict[int, Set[str]] = {}
    for start, end in _statement_spans(ctx):
        rules = _noqa_rules_on(ctx, start)
        if rules is None:
            continue
        for line in range(start, end + 1):
            got = span_rules.get(line)
            if got is None:
                span_rules[line] = set(rules)
            elif rules and got:
                got |= rules
            else:
                span_rules[line] = set()  # bare noqa wins: all rules
    for lineno in range(1, len(ctx.lines) + 1):
        rules = _noqa_rules_on(ctx, lineno)
        if rules is None:
            continue
        got = span_rules.get(lineno)
        if got is None:
            span_rules[lineno] = set(rules)
        elif rules and got:
            got |= rules
        else:
            span_rules[lineno] = set()
    return span_rules


def _apply_suppressions(ctx: ModuleContext, findings: List[Finding]) -> List[Finding]:
    noqa = noqa_map(ctx)
    out = []
    for f in findings:
        rules = noqa.get(f.line)
        if rules is not None and (not rules or f.rule in rules):
            f = dataclasses.replace(f, suppressed=True)
        out.append(f)
    return out


def _run_rules(ctx: ModuleContext,
               select: Optional[Sequence[str]] = None) -> List[Finding]:
    """Phase 2 for one module: run the (selected) rule pack."""
    rules = all_rules()
    wanted = list(rules) if select is None else [r for r in rules if r in set(select)]
    findings: List[Finding] = []
    for rule_id in wanted:
        if rules[rule_id].check is not None:
            findings.extend(rules[rule_id].check(ctx))
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return _apply_suppressions(ctx, findings)


def parse_context(src: str, path: str):
    """(ModuleContext, None) or (None, [E999 finding])."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return None, [Finding("E999", path, e.lineno or 1,
                              (e.offset or 1) - 1, f"syntax error: {e.msg}")]
    return ModuleContext(path, src, tree), None


def analyze_source(
    src: str, path: str = "<string>", select: Optional[Sequence[str]] = None
) -> List[Finding]:
    """Run the (selected) rule pack over one source string.

    Single-module entry point: the whole-program index degenerates to a
    one-module project.
    """
    from .project import Project

    ctx, errors = parse_context(src, path)
    if ctx is None:
        return errors
    Project([ctx])
    return _run_rules(ctx, select)


def analyze_file(path: str, select: Optional[Sequence[str]] = None) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    return analyze_source(src, path, select)


def iter_python_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d != "__pycache__")
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)
        elif p.endswith(".py"):
            yield p


class AnalysisCache:
    """On-disk findings cache for the phase-2 check.

    One JSON file; per analyzed file an entry keyed by the file's
    ``(mtime, size)`` plus a digest of everything else its findings
    depend on: the engine version, the rule selection, and the
    cross-module facts the phase-1 index injected (reachability, axis
    universe). Phase 1 always re-parses, so the cache only skips phase-2
    rule execution. Its version tag differs from the reference pass's,
    so the two never read each other's entries.
    """

    def __init__(self, path: str):
        self.path = path
        self.dirty = False
        self.data: Dict[str, dict] = {}
        try:
            with open(path, "r", encoding="utf-8") as f:
                raw = json.load(f)
            if raw.get("version") == ANALYSIS_VERSION:
                self.data = raw.get("files", {})
        except (OSError, ValueError):
            pass

    @staticmethod
    def _stat_key(path: str):
        st = os.stat(path)
        return st.st_mtime, st.st_size

    def lookup(self, path: str, digest: str) -> Optional[List[Finding]]:
        ent = self.data.get(os.path.abspath(path))
        if ent is None or ent.get("digest") != digest:
            return None
        try:
            mtime, size = self._stat_key(path)
        except OSError:
            return None
        if ent.get("mtime") != mtime or ent.get("size") != size:
            return None
        return [Finding(**f) for f in ent.get("findings", [])]

    def store(self, path: str, digest: str, findings: List[Finding]) -> None:
        try:
            mtime, size = self._stat_key(path)
        except OSError:
            return
        self.data[os.path.abspath(path)] = {
            "mtime": mtime, "size": size, "digest": digest,
            "findings": [dataclasses.asdict(f) for f in findings],
        }
        self.dirty = True

    def save(self) -> None:
        if not self.dirty:
            return
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"version": ANALYSIS_VERSION, "files": self.data}, f)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _module_digest(project, ctx: ModuleContext,
                   select: Optional[Sequence[str]]) -> str:
    parts = [ANALYSIS_VERSION,
             ",".join(sorted(select)) if select else "*"]
    parts += project.reach_digest_parts(ctx)
    return hashlib.sha1("\x00".join(parts).encode()).hexdigest()


def analyze_paths(
    paths: Sequence[str], select: Optional[Sequence[str]] = None,
    cache_path: Optional[str] = None,
) -> List[Finding]:
    """Two-phase whole-program run over files/trees.

    Phase 1 parses every file and builds the cross-module index
    (``project.Project``); phase 2 runs the rule pack per module,
    consulting the on-disk cache when ``cache_path`` is given.
    """
    from .project import Project

    findings: List[Finding] = []
    contexts: List[ModuleContext] = []
    for path in iter_python_files(paths):
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
        ctx, errors = parse_context(src, path)
        if ctx is None:
            findings.extend(errors)
        else:
            contexts.append(ctx)
    project = Project(contexts)
    cache = AnalysisCache(cache_path) if cache_path else None
    for ctx in contexts:
        if cache is not None:
            digest = _module_digest(project, ctx, select)
            got = cache.lookup(ctx.path, digest)
            if got is None:
                got = _run_rules(ctx, select)
                cache.store(ctx.path, digest, got)
            findings.extend(got)
        else:
            findings.extend(_run_rules(ctx, select))
    if cache is not None:
        cache.save()
    return findings


def _github_escape(s: str) -> str:
    return s.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")


def format_github(f: Finding, warn_only: bool = False) -> str:
    """One GitHub Actions workflow-command annotation per finding."""
    level = "notice" if f.suppressed else ("warning" if warn_only else "error")
    rule = all_rules().get(f.rule)
    title = f"{f.rule} {rule.name}" if rule else f.rule
    msg = f.message + (" (suppressed)" if f.suppressed else "")
    return (f"::{level} file={f.path},line={f.line},col={f.col + 1},"
            f"title={_github_escape(title)}::{_github_escape(msg)}")


def format_rule(rule: Rule) -> str:
    """``--list-rules`` entry: the rule, the reference rule it mirrors (or
    that it has no counterpart, and why)."""
    if rule.check is None:
        head = f"{rule.id}  no counterpart of repro.analysis {rule.mirrors}"
    else:
        head = (f"{rule.id}  {rule.name}  (counterpart of repro.analysis "
                f"{rule.mirrors})")
    return f"{head}\n    {rule.description}"


def run_cli(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Whole-program PyTorch/CUDA static-analysis pass over the "
        "port: host syncs on hot paths, u64-as-int64 dtype contract, tensor "
        "control flow, unsynced CUDA timing, collective/padding/concurrency/"
        "kernel-launch contracts. Exits 1 on unsuppressed findings.",
    )
    ap.add_argument("paths", nargs="*", help="files or directories to analyze")
    ap.add_argument("--select", default=None, help="comma-separated rule ids (default: all)")
    ap.add_argument("--format", choices=("text", "json", "github"),
                    default="text",
                    help="github emits workflow-command annotations")
    ap.add_argument("--warn-only", action="store_true",
                    help="report findings but exit 0 (advisory lanes)")
    ap.add_argument("--cache", default=DEFAULT_CACHE, metavar="FILE",
                    help="on-disk findings cache (default: %(default)s)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the findings cache")
    ap.add_argument("--report", default=None, metavar="FILE",
                    help="also write the full JSON findings report to FILE")
    ap.add_argument("--list-rules", action="store_true", help="print the rule pack and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in all_rules().values():
            print(format_rule(rule))
        return 0
    if not args.paths:
        ap.error("no paths given (or use --list-rules)")
    select = [s.strip() for s in args.select.split(",")] if args.select else None
    cache_path = None if args.no_cache else args.cache
    findings = analyze_paths(args.paths, select, cache_path=cache_path)
    live = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]
    if args.report:
        with open(args.report, "w", encoding="utf-8") as fh:
            json.dump([dataclasses.asdict(f) for f in findings], fh, indent=2)
    if args.format == "json":
        print(json.dumps([dataclasses.asdict(f) for f in findings], indent=2))
    else:
        for f in findings:
            print(format_github(f, args.warn_only) if args.format == "github"
                  else f.format())
        by_rule: Dict[str, int] = {}
        for f in live:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        stats = ", ".join(f"{k}={v}" for k, v in sorted(by_rule.items())) or "none"
        print(
            f"repro_torch.analysis: {len(live)} finding(s) ({stats}), "
            f"{len(suppressed)} suppressed",
            file=sys.stderr,
        )
    return 0 if args.warn_only else (1 if live else 0)
