"""The R006-R009 contract rule families over ``ModuleContext``.

These rules guard the cross-rank and kernel contracts the R001-R005 pack
cannot see, each the counterpart of the reference pack's rule with the
same id (``RULES.md`` gives the contracts and their imprecision):

- R006 collective-contract: literal mesh-dim names used by
  ``mesh["name"]``, ``mesh.get_group("name")``, ``mesh.size("name")`` and
  ``get_local_rank("name")`` must exist in the project's declared
  mesh-dim universe; ``dist.all_to_all_single`` with a static extent or
  literal split sizes must split evenly over the declared shard count.
- R007 padding/sentinel-contract: values built by ``np.pad``/``F.pad``
  or ``pad_*`` helpers carry dead lanes and must be masked, sliced, or
  ``where``-guarded before reductions/compactions; sentinel-filled word
  buffers (``np.full(.., SENT)``, ``torch.full(.., -1)``,
  ``u64.full(.., SENTINEL)``) must be filtered before ``unpack_*`` calls.
- R008 serving-concurrency: no blocking call (a device synchronize
  included) while holding a lock, and no attribute mutated both under a
  lock and bare (outside ``__init__``) in the same class.
- R009 kernel-launch-contract: a ctypes launch of a module-level
  ``Kernel(...)`` must pass as many arguments as its ``argtypes`` list
  (``Kernel.__call__`` adds the stream), and every ``ptr(x)`` must point
  at a tensor that ``check_cuda`` checked or that the scope allocated.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .engine import ModuleContext, Finding, call_tail, dotted_name, register
from .rules import _scope_nodes

# -- shared expression helpers ---------------------------------------------

# DeviceMesh methods that take one mesh-dim name
_MESH_DIM_METHODS = {"get_group", "size", "get_local_rank"}
_REDUCERS = {
    "sum", "mean", "prod", "min", "max", "amin", "amax", "all", "any",
    "median", "average", "argmin", "argmax", "count_nonzero", "nonzero",
    "flatnonzero", "unique", "bincount", "cumsum", "cumprod",
}
_MASKISH = ("valid", "mask", "live", "keep", "real")
_SENTINEL_INTS = {0xFFFFFFFF, 0xFFFFFFFFFFFFFFFF, -1}
_BLOCKING_ATTRS = {"sleep", "join", "wait", "acquire", "block_until_ready",
                   "synchronize"}
_QUEUEISH = ("q", "queue")
_MUTATORS = {
    "append", "extend", "insert", "add", "remove", "discard", "pop",
    "popleft", "appendleft", "clear", "update", "inc", "dec", "record",
    "put", "push", "setdefault",
}


def _enclosing_scopes(ctx: ModuleContext, node: ast.AST) -> List[ast.AST]:
    """Function scopes containing ``node``, innermost first, then module."""
    out: List[ast.AST] = []
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(cur)
        cur = ctx.parents.get(cur)
    out.append(ctx.tree)
    return out


def _literal_str_list(node: ast.AST) -> Optional[List[str]]:
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


def _param_default(fn, name: str) -> Optional[ast.AST]:
    args = fn.args
    pos = list(args.posonlyargs) + list(args.args)
    defaults = list(args.defaults)
    for a, d in zip(pos[len(pos) - len(defaults):], defaults):
        if a.arg == name:
            return d
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        if a.arg == name and d is not None:
            return d
    return None


def _resolve_axis_literals(ctx: ModuleContext, node: ast.AST,
                           use_site: ast.AST,
                           depth: int = 0) -> Optional[List[str]]:
    """Literal axis names an axis argument denotes, or None (dynamic)."""
    if depth > 4:
        return None
    got = _literal_str_list(node)
    if got is not None:
        return got
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("tuple", "list") and len(node.args) == 1:
        return _resolve_axis_literals(ctx, node.args[0], use_site, depth + 1)
    if isinstance(node, ast.Name):
        for scope in _enclosing_scopes(ctx, use_site):
            if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
                dflt = _param_default(scope, node.id)
                if dflt is not None:
                    return _resolve_axis_literals(ctx, dflt, use_site,
                                                  depth + 1)
            for n in _scope_nodes(scope):
                if isinstance(n, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == node.id
                        for t in n.targets):
                    return _resolve_axis_literals(ctx, n.value, use_site,
                                                  depth + 1)
    return None


def _find_local_assign(ctx: ModuleContext, use_site: ast.AST,
                       name: str) -> Optional[ast.AST]:
    """RHS of a ``name = ...`` assignment visible at ``use_site``."""
    for scope in _enclosing_scopes(ctx, use_site):
        for n in _scope_nodes(scope):
            if isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == name
                    for t in n.targets):
                return n.value
    return None


# -- R006: collective contracts --------------------------------------------


def _literal_ints(node: ast.AST) -> Optional[List[int]]:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for el in node.elts:
            if not (isinstance(el, ast.Constant) and isinstance(el.value, int)):
                return None
            out.append(el.value)
        return out
    return None


def _leading_extent(ctx: ModuleContext, x: ast.AST,
                    use_site: ast.AST) -> Optional[int]:
    """Static dim-0 extent of an ``all_to_all_single`` input: a literal
    ``x.reshape(k, ...)`` / ``x.view(k, ...)`` or ``torch.empty((k, ...))``."""
    if isinstance(x, ast.Name):
        x = _find_local_assign(ctx, use_site, x.id) or x
    if isinstance(x, ast.Call) and isinstance(x.func, ast.Attribute) \
            and x.func.attr == "contiguous":
        return _leading_extent(ctx, x.func.value, use_site)
    if not isinstance(x, ast.Call):
        return None
    tail = call_tail(x.func)
    dim = None
    if tail in ("reshape", "view") and isinstance(x.func, ast.Attribute) and x.args:
        dim = x.args[0]
        if isinstance(dim, (ast.Tuple, ast.List)) and dim.elts:
            dim = dim.elts[0]
    elif tail in ("empty", "zeros", "ones", "full") and x.args:
        shape = x.args[0]
        dim = shape.elts[0] if isinstance(shape, (ast.Tuple, ast.List)) \
            and shape.elts else shape
    if isinstance(dim, ast.Constant) and isinstance(dim.value, int):
        return dim.value
    return None


def _group_dim(ctx: ModuleContext, call: ast.Call) -> Optional[List[str]]:
    """Dim names of a ``group=mesh.get_group("dim")`` argument."""
    for kw in call.keywords:
        if kw.arg == "group":
            g = kw.value
            if isinstance(g, ast.Name):
                g = _find_local_assign(ctx, call, g.id) or g
            if isinstance(g, ast.Call) and call_tail(g.func) == "get_group" \
                    and g.args:
                return _resolve_axis_literals(ctx, g.args[0], call)
    return None


@register(
    "R006",
    "collective-contract",
    "mesh-dim names used by mesh[...], mesh.get_group/size/get_local_rank "
    "must exist in a DeviceMesh/init_device_mesh declaration, and "
    "dist.all_to_all_single with a static extent or literal split sizes "
    "must split evenly over the declared shard count",
    mirrors="R006 collective-contract",
)
def check_collective_contract(ctx: ModuleContext) -> List[Finding]:
    project = ctx.project
    if project is None or not project.declared_axes:
        return []  # no mesh declaration in scope: no universe to check
    findings: List[Finding] = []
    declared = project.declared_axes
    for node in ast.walk(ctx.tree):
        # mesh["dim"] subscripts
        if isinstance(node, ast.Subscript):
            d = dotted_name(node.value)
            sl = node.slice
            if d and d.rpartition(".")[2].endswith("mesh") \
                    and isinstance(sl, ast.Constant) \
                    and isinstance(sl.value, str) and sl.value not in declared:
                findings.append(ctx.finding(
                    "R006", node,
                    f"mesh dim `{sl.value}` in `{d}[...]` is not declared "
                    f"by any mesh in the project (known: "
                    f"{sorted(declared)})"))
            continue
        if not isinstance(node, ast.Call):
            continue
        tail = call_tail(node.func)
        if tail in _MESH_DIM_METHODS and isinstance(node.func, ast.Attribute) \
                and node.args:
            dims = _resolve_axis_literals(ctx, node.args[0], node)
            for a in [a for a in (dims or []) if a not in declared]:
                findings.append(ctx.finding(
                    "R006", node,
                    f"`{tail}` over mesh dim `{a}` which no mesh declares "
                    f"(known dims: {sorted(declared)}) — DeviceMesh raises "
                    "KeyError at run time"))
        elif tail == "all_to_all_single":
            dims = _group_dim(ctx, node)
            if not dims or any(a not in declared for a in dims):
                continue
            sizes = [project.axis_sizes.get(a) for a in dims]
            if not all(isinstance(s, int) for s in sizes):
                continue
            n_shards = 1
            for s in sizes:
                n_shards *= s
            splits = [kw.value for kw in node.keywords
                      if kw.arg in ("output_split_sizes", "input_split_sizes")]
            for sp in splits:
                got = _literal_ints(sp)
                if got is not None and len(got) != n_shards:
                    findings.append(ctx.finding(
                        "R006", node,
                        f"`all_to_all_single` split sizes {got} name "
                        f"{len(got)} shards, the group {tuple(dims)} has "
                        f"{n_shards}"))
            if not splits and len(node.args) > 1:
                extent = _leading_extent(ctx, node.args[1], node)
                if extent is not None and extent % n_shards:
                    findings.append(ctx.finding(
                        "R006", node,
                        f"`all_to_all_single` extent {extent} is not "
                        f"divisible by the {n_shards}-shard group "
                        f"{tuple(dims)} — the exchange needs equal "
                        "per-shard tiles"))
    return findings


# -- R007: padding / sentinel contracts ------------------------------------


def _is_pad_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    tail = None
    if isinstance(node.func, ast.Name):
        tail = node.func.id
    elif isinstance(node.func, ast.Attribute):
        tail = node.func.attr
    return bool(tail) and "pad" in tail.lower()


def _is_sentinel_const(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value in _SENTINEL_INTS
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub) \
            and isinstance(node.operand, ast.Constant):
        return node.operand.value == 1
    if isinstance(node, ast.Name) and "sent" in node.id.lower():
        return True
    if isinstance(node, ast.Attribute) and "sent" in node.attr.lower():
        return True
    if isinstance(node, ast.Call) and node.args:
        # np.uint32(0xFFFFFFFF)-style wrappers
        return _is_sentinel_const(node.args[0])
    return False


def _is_sentinel_fill(node: ast.AST) -> bool:
    """np.full(shape, SENT) / torch.full(shape, -1) / u64.full(shape, SENTINEL)
    / np.pad(x, ..., constant_values=SENT) / F.pad(x, ..., value=-1)."""
    if not isinstance(node, ast.Call):
        return False
    tail = node.func.attr if isinstance(node.func, ast.Attribute) else (
        node.func.id if isinstance(node.func, ast.Name) else None)
    if tail == "full" and len(node.args) >= 2:
        return _is_sentinel_const(node.args[1])
    if tail == "pad":
        for kw in node.keywords:
            if kw.arg in ("constant_values", "value"):
                return _is_sentinel_const(kw.value)
    return False


def _has_guard(node: ast.AST) -> bool:
    """Mask/slice/where evidence inside an expression: the dead lanes
    are being filtered, so the padded/sentinel value is used safely."""
    for n in ast.walk(node):
        if isinstance(n, ast.Subscript):
            return True
        if isinstance(n, ast.Call):
            tail = n.func.attr if isinstance(n.func, ast.Attribute) else (
                n.func.id if isinstance(n.func, ast.Name) else None)
            if tail in ("where", "compress", "is_sentinel", "take"):
                return True
        if isinstance(n, ast.Name) and any(m in n.id.lower()
                                           for m in _MASKISH):
            return True
        if isinstance(n, ast.Attribute) and any(m in n.attr.lower()
                                                for m in _MASKISH):
            return True
        if isinstance(n, ast.Compare):
            return True
    return False


_PRESERVING_METHODS = {
    "reshape", "astype", "ravel", "flatten", "copy", "view", "squeeze",
    "transpose",
}


def _taint_flows(node: ast.AST, names: Set[str]) -> bool:
    """Does taint in ``names`` flow through this value expression?

    Deliberately narrow: taint crosses arithmetic, tuples, subscripts,
    pad calls, and shape-preserving methods (``x.reshape(...)``), but
    NOT arbitrary function calls — a callee may consume the padding
    internally (e.g. a kernel launch whose outputs are per-lane ranks),
    and propagating through it drowns the rule in false positives.
    """
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Name):
            if n.id in names:
                return True
            continue
        if isinstance(n, ast.Call):
            if _is_pad_call(n):
                stack.extend(n.args)
            elif isinstance(n.func, ast.Attribute) \
                    and n.func.attr in _PRESERVING_METHODS:
                stack.append(n.func.value)
            continue
        stack.extend(ast.iter_child_nodes(n))
    return False


class _TaintScope:
    """Local-dataflow tracking of padded / sentinel-filled names."""

    def __init__(self, ctx: ModuleContext, scope: ast.AST):
        self.ctx = ctx
        self.padded: Set[str] = set()
        self.sentinel: Set[str] = set()
        assigns = [
            n for n in _scope_nodes(scope, keep_lambdas=True)
            if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))
        ]
        for _ in range(2):  # fixpoint on straight-line chains
            for a in assigns:
                value = a.value
                if value is None:
                    continue
                targets = a.targets if isinstance(a, ast.Assign) else [a.target]
                names = [el.id for t in targets
                         for el in (t.elts if isinstance(t, ast.Tuple) else [t])
                         if isinstance(el, ast.Name)]
                if not names:
                    continue
                guarded = _has_guard(value)
                pad_src = (_is_pad_call(value)
                           or _taint_flows(value, self.padded))
                sent_src = (_is_sentinel_fill(value)
                            or _taint_flows(value, self.sentinel))
                for name in names:
                    if pad_src and not guarded:
                        self.padded.add(name)
                    else:
                        self.padded.discard(name)
                    if sent_src and not guarded:
                        self.sentinel.add(name)
                    else:
                        self.sentinel.discard(name)


@register(
    "R007",
    "padding-sentinel-contract",
    "padded arrays (np.pad/F.pad/pad_rows/pad_probe_rows and other pad_* "
    "helpers) must be masked/sliced before reductions (sum/any/unique/"
    "bincount/cumsum/...) or compactions, and sentinel-filled word buffers "
    "must be filtered before unpack_*",
    mirrors="R007 padding-sentinel-contract",
)
def check_padding_sentinel(ctx: ModuleContext) -> List[Finding]:
    findings: List[Finding] = []
    scopes: List[ast.AST] = [ctx.tree] + list(ctx.functions.values())
    for scope in scopes:
        taint = _TaintScope(ctx, scope)
        if not taint.padded and not taint.sentinel:
            continue
        for node in _scope_nodes(scope, keep_lambdas=True):
            if not isinstance(node, ast.Call):
                continue
            # (a) reduction over a padded value with no mask/slice/where
            data = None
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _REDUCERS:
                mod = node.func.value
                root = dotted_name(mod)
                if root in ctx.numpy_aliases or root in ctx.torch_aliases:
                    data = node.args[0] if node.args else None
                else:
                    data = mod  # x.sum() method form
            if data is not None and _taint_flows(data, taint.padded) \
                    and not _has_guard(data):
                findings.append(ctx.finding(
                    "R007", node,
                    f"reduction `{node.func.attr}` over a padded array — "
                    "dead pad lanes count into the result; slice by the "
                    "real-row count (x[:n_real]) or mask first"))
                continue
            # (b) unpack of sentinel-filled words with no filter
            tail = node.func.attr if isinstance(node.func, ast.Attribute) \
                else (node.func.id if isinstance(node.func, ast.Name) else None)
            if tail and tail.startswith("unpack"):
                for arg in node.args:
                    if _taint_flows(arg, taint.sentinel) \
                            and not _has_guard(arg):
                        findings.append(ctx.finding(
                            "R007", node,
                            f"`{tail}` on a sentinel-filled word buffer — "
                            "all-ones sentinel lanes decode as garbage "
                            "pairs; filter (words != SENTINEL / winner "
                            "mask) before unpacking"))
                        break
    return findings


# -- R008: serving concurrency ---------------------------------------------


def _lock_item_name(item: ast.withitem) -> Optional[str]:
    d = dotted_name(item.context_expr)
    if d and "lock" in d.rpartition(".")[2].lower():
        return d
    return None


def _with_lock_names(node: ast.With) -> List[str]:
    return [n for n in (_lock_item_name(i) for i in node.items) if n]


def _is_blocking_call(node: ast.Call) -> bool:
    if isinstance(node.func, ast.Name):
        return node.func.id == "sleep"
    if not isinstance(node.func, ast.Attribute):
        return False
    attr = node.func.attr
    if attr in _BLOCKING_ATTRS:
        return True
    if attr in ("get", "put"):
        recv = dotted_name(node.func.value)
        tail = (recv or "").rpartition(".")[2].lower()
        return any(tail == q or tail.endswith("_" + q) or tail.endswith(q)
                   for q in _QUEUEISH)
    return False


def _under_lock(ctx: ModuleContext, node: ast.AST,
                stop_at: Optional[ast.AST] = None) -> bool:
    cur = ctx.parents.get(node)
    while cur is not None and cur is not stop_at:
        if isinstance(cur, ast.With) and _with_lock_names(cur):
            return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        cur = ctx.parents.get(cur)
    return False


def _self_attr_writes(ctx: ModuleContext, fn) -> List[Tuple[str, ast.AST]]:
    """(attr, node) per mutation of ``self.<attr>`` in the method."""
    out: List[Tuple[str, ast.AST]] = []

    def self_attr(node: ast.AST) -> Optional[str]:
        # self.X, self.X[i], self.X.anything -> "X"
        while isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) and node.value.id == "self":
            return node.attr
        return None

    for node in _scope_nodes(fn, keep_lambdas=True):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for el in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    attr = self_attr(el)
                    if attr is not None:
                        out.append((attr, node))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            attr = self_attr(node.func.value)
            if attr is not None:
                out.append((attr, node))
    return out


@register(
    "R008",
    "serving-concurrency",
    "blocking calls (sleep/join/wait/acquire/queue get-put/"
    "synchronize) while holding a lock, and attributes mutated "
    "both under a lock and bare outside __init__ in the same class",
    mirrors="R008 serving-concurrency",
)
def check_serving_concurrency(ctx: ModuleContext) -> List[Finding]:
    findings: List[Finding] = []
    # (a) blocking call while a lock is held
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.With) and _with_lock_names(node)):
            continue
        locks = ", ".join(_with_lock_names(node))
        for inner in _scope_nodes(node, keep_lambdas=True):
            if isinstance(inner, ast.Call) and _is_blocking_call(inner):
                findings.append(ctx.finding(
                    "R008", inner,
                    f"blocking call while holding `{locks}` — every other "
                    "lane stalls behind this request; move the wait "
                    "outside the critical section"))
    # (b) inconsistently-guarded attribute mutations per class
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        locked: Dict[str, List[ast.AST]] = {}
        bare: Dict[str, List[Tuple[str, ast.AST]]] = {}
        for fn in node.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for attr, site in _self_attr_writes(ctx, fn):
                if _under_lock(ctx, site, stop_at=fn):
                    locked.setdefault(attr, []).append(site)
                elif fn.name != "__init__":
                    bare.setdefault(attr, []).append((fn.name, site))
        for attr, sites in sorted(bare.items()):
            if attr not in locked:
                continue
            for fn_name, site in sites:
                findings.append(ctx.finding(
                    "R008", site,
                    f"`self.{attr}` is mutated under a lock elsewhere in "
                    f"`{node.name}` but bare in `{fn_name}` — a concurrent "
                    "lane can observe torn state; hold the same lock (or "
                    "confine the attribute to one lane)"))
    return findings


# -- R009: kernel launch contract ---------------------------------------------

# allocations whose result is a fresh contiguous tensor of a known dtype
_ALLOCATORS = {"empty", "zeros", "ones", "full", "tensor", "empty_like",
               "zeros_like", "ones_like", "full_like"}


def _static_len(node: ast.AST) -> Optional[int]:
    """Length of a statically evaluable argtypes expression:
    ``[a, b] + [c] * 3`` and the like."""
    if isinstance(node, (ast.List, ast.Tuple)):
        return len(node.elts)
    if isinstance(node, ast.BinOp):
        left, right = _static_len(node.left), _static_len(node.right)
        if isinstance(node.op, ast.Add) and left is not None and right is not None:
            return left + right
        if isinstance(node.op, ast.Mult):
            if left is not None and isinstance(node.right, ast.Constant) \
                    and isinstance(node.right.value, int):
                return left * node.right.value
            if right is not None and isinstance(node.left, ast.Constant) \
                    and isinstance(node.left.value, int):
                return right * node.left.value
    return None


def _kernel_arity(ctx: ModuleContext) -> Dict[str, Optional[int]]:
    """Module-level ``NAME = Kernel(name, source, symbol, argtypes)`` ->
    the argtypes count when static."""
    out: Dict[str, Optional[int]] = {}
    for node in ctx.tree.body:
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and call_tail(node.value.func) == "Kernel"):
            continue
        call = node.value
        argtypes = call.args[3] if len(call.args) > 3 else next(
            (kw.value for kw in call.keywords if kw.arg == "argtypes"), None)
        for t in node.targets:
            if isinstance(t, ast.Name):
                out[t.id] = _static_len(argtypes) if argtypes is not None else None
    return out


def _checking_helpers(ctx: ModuleContext) -> Dict[str, Set[int]]:
    """Local defs that run ``check_cuda`` on one of their parameters:
    def name -> the positions of the checked parameters."""
    out: Dict[str, Set[int]] = {}
    for name, fn in ctx.functions.items():
        params = [a.arg for a in list(fn.args.posonlyargs) + list(fn.args.args)]
        checked = _checked_names(fn, {})
        pos = {i for i, p in enumerate(params) if p in checked}
        if pos:
            out[name] = pos
    return out


def _checked_names(scope: ast.AST, helpers: Dict[str, Set[int]]) -> Set[str]:
    """Names a scope validates: ``check_cuda(name, x, dtype)``, a call of
    a local checking helper, and the tensors of a ``for name, t, dtype
    in ((..., x, ...), ...)`` loop around ``check_cuda``."""
    out: Set[str] = set()
    for n in _scope_nodes(scope, keep_lambdas=True):
        if isinstance(n, ast.Call) and call_tail(n.func) == "check_cuda" \
                and len(n.args) > 1 and isinstance(n.args[1], ast.Name):
            out.add(n.args[1].id)
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id in helpers:
            for i in helpers[n.func.id]:
                if i < len(n.args) and isinstance(n.args[i], ast.Name):
                    out.add(n.args[i].id)
    for n in _scope_nodes(scope, keep_lambdas=True):
        if not (isinstance(n, ast.For) and isinstance(n.target, ast.Tuple)
                and isinstance(n.iter, (ast.Tuple, ast.List))):
            continue
        loop_vars = [e.id if isinstance(e, ast.Name) else None
                     for e in n.target.elts]
        for i, var in enumerate(loop_vars):
            if var is None or var not in out:
                continue
            for row in n.iter.elts:
                if isinstance(row, (ast.Tuple, ast.List)) and i < len(row.elts) \
                        and isinstance(row.elts[i], ast.Name):
                    out.add(row.elts[i].id)
    return out


def _allocated_names(ctx: ModuleContext, scope: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in _scope_nodes(scope, keep_lambdas=True):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                and call_tail(n.value.func) in _ALLOCATORS \
                and (dotted_name(n.value.func) or "").partition(".")[0] \
                in ctx.torch_aliases:
            for t in n.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


@register(
    "R009",
    "kernel-launch-contract",
    "a launch of a module-level Kernel(...) must pass as many arguments as "
    "its static argtypes list (the stream is added by Kernel.__call__), and "
    "every ptr(x) must point at a tensor check_cuda(name, x, dtype) checked "
    "or torch.empty/zeros/full/*_like allocated earlier in the scope",
    mirrors="R009 pallas-kernel-shape",
)
def check_kernel_launch(ctx: ModuleContext) -> List[Finding]:
    arity = _kernel_arity(ctx)
    if not arity:
        return []
    findings: List[Finding] = []
    helpers = _checking_helpers(ctx)
    for fn in ctx.functions.values():
        launches = [n for n in _scope_nodes(fn, keep_lambdas=True)
                    if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                    and n.func.id in arity]
        if not launches:
            continue
        known = _checked_names(fn, helpers) | _allocated_names(ctx, fn)
        for call in launches:
            want = arity[call.func.id]
            if want is not None and (len(call.args) != want or call.keywords):
                findings.append(ctx.finding(
                    "R009", call,
                    f"`{call.func.id}` launched with {len(call.args)} "
                    f"arguments, its argtypes declare {want} — a ctypes "
                    "mismatch is a crash or garbage, not an exception"))
            for arg in call.args:
                if not (isinstance(arg, ast.Call) and call_tail(arg.func) == "ptr"
                        and arg.args):
                    continue
                x = arg.args[0]
                if not (isinstance(x, ast.Name) and x.id in known):
                    findings.append(ctx.finding(
                        "R009", arg,
                        f"`ptr({ast.unparse(x)})` in a launch of "
                        f"`{call.func.id}`: the tensor was neither checked by "
                        "check_cuda (device, dtype, contiguity) nor allocated "
                        "in this scope"))
    return findings
