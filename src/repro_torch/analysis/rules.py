"""The R001-R005 rule pack over ``ModuleContext``.

Each rule is a registered ``ModuleContext -> [Finding]`` function, the
counterpart of the reference pack's rule with the same id. Detection is
a static approximation tuned to the port's idioms (``RULES.md`` gives
each rule's contract, its known imprecision, and how to suppress with
``# repro: noqa[RULE]``). Hot-path reachability is whole-program: the
phase-1 index (``project.Project``) injects the cross-module closure
into each ``ModuleContext``.

- R001 host-sync-in-hot-path: calls that make the host wait for the card
  (downloads, Python scalars of tensors, explicit synchronisation,
  size-dependent ops, masked indexing, uploads from pageable memory)
  inside hot-path-reachable functions.
- R002 dtype-contract-drift: the numpy half of the reference rule (the
  port's host store keeps u64 keys as numpy ``uint64``), plus the torch
  half for the port's u64-as-int64 contract (``core/u64.py``): signed
  ``>>``, signed order, narrowing casts and ``torch.uint64``/``uint32``
  outside ``core/u64.py``.
- R003 tensor-control-flow: ``if``/``while``/``assert``/conditional
  expressions and comprehension filters testing a tensor in a hot-path
  function (each an implicit sync).
- R004 unsynced-cuda-timing: ``time.perf_counter()`` windows that run real
  work with no synchronisation or host download inside them.
- R005 has no counterpart: eager PyTorch has no trace cache to hit.
"""
from __future__ import annotations

import ast
import re
from typing import List, Optional, Set

from .engine import (
    Finding,
    ModuleContext,
    call_tail,
    dotted_name,
    register,
    register_without_counterpart,
)

# -- shared expression helpers ---------------------------------------------

_U64_DTYPES = {"uint64"}
_I64_DTYPES = {"int64"}
_NARROW_DTYPES = {
    "int32", "uint32", "int16", "uint16", "int8", "uint8",
    "float32", "float16", "bfloat16",
}
# calls whose cost/semantics are irrelevant to a timing window
_TRIVIAL_CALLS = {
    "perf_counter", "time", "print", "len", "range", "min", "max", "int",
    "float", "str", "format", "append", "emit", "flush", "sum", "abs",
    "round", "enumerate", "zip", "dict", "list", "tuple", "set", "sorted",
    "isinstance", "getattr", "items", "keys", "values", "join", "split",
}
# tensor methods whose result is a host value (no device tensor)
_HOST_METHODS = {
    "item", "tolist", "numpy", "cpu", "size", "dim", "numel", "nelement",
    "data_ptr", "is_contiguous", "element_size", "stride", "storage_offset",
    "get_device", "is_floating_point", "is_complex", "untyped_storage",
}
# torch.<name> calls that return no device tensor
_TORCH_NON_TENSOR = {
    "device", "dtype", "Size", "Generator", "no_grad", "enable_grad",
    "inference_mode", "set_grad_enabled", "is_tensor", "is_grad_enabled",
    "manual_seed", "iinfo", "finfo", "get_default_dtype", "set_default_dtype",
    "use_deterministic_algorithms", "are_deterministic_algorithms_enabled",
    "is_floating_point", "is_complex", "numel", "equal", "allclose",
    "is_nonzero", "typename", "get_rng_state", "set_rng_state", "compile",
    "from_numpy", "save", "load", "broadcast_shapes", "promote_types",
    "result_type", "can_cast", "is_storage",
}
# factories that make a CPU tensor unless given a device
_FACTORIES = {
    "zeros", "ones", "empty", "full", "arange", "tensor", "as_tensor",
    "rand", "randn", "randint", "randperm", "linspace", "logspace", "eye",
    "empty_strided", "scalar_tensor",
}
# torch.<sub>.<name> namespaces of tensor ops
_TORCH_OP_NAMESPACES = {"linalg", "fft", "special", "nn"}
# ops whose output size depends on the data: the host reads it back
_SIZE_DEPENDENT = {"nonzero", "argwhere", "unique", "unique_consecutive",
                   "masked_select", "bincount"}
_BOOL_METHODS = {"bool", "isfinite", "isnan", "isinf", "logical_not",
                 "logical_and", "logical_or", "logical_xor", "isin", "eq",
                 "ne", "lt", "le", "gt", "ge"}


def _scope_nodes(scope: ast.AST, *, keep_lambdas: bool = False) -> List[ast.AST]:
    """All nodes in ``scope`` excluding nested function/class bodies."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if isinstance(n, ast.Lambda) and not keep_lambdas:
            continue
        out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return sorted(out, key=lambda n: (getattr(n, "lineno", 0), getattr(n, "col_offset", 0)))


def _np_attr(ctx: ModuleContext, node: ast.AST, attrs: Set[str]) -> bool:
    """Is ``node`` the attribute ``np.<attr>`` for a numpy alias?"""
    d = dotted_name(node)
    if not d or "." not in d:
        return False
    root, _, attr = d.partition(".")
    return root in ctx.numpy_aliases and attr in attrs


def _is_dtype_ref(ctx: ModuleContext, node: ast.AST, dtypes: Set[str]) -> bool:
    """np.uint64 / "uint64" style dtype references."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in dtypes
    return _np_attr(ctx, node, dtypes)


def _assign_targets(a: ast.AST) -> List[ast.AST]:
    return a.targets if isinstance(a, ast.Assign) else [a.target]


def _target_names(t: ast.AST) -> List[str]:
    elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
    return [el.id for el in elts if isinstance(el, ast.Name)]


class _U64Scope:
    """Local-dataflow numpy uint64 typing for one scope (module or function)."""

    def __init__(self, ctx: ModuleContext, scope: ast.AST,
                 inherited: Optional[Set[str]] = None):
        self.ctx = ctx
        self.names: Set[str] = set(inherited or ())
        assigns = [
            n for n in _scope_nodes(scope)
            if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign))
        ]
        for _ in range(2):  # 2 passes reach fixpoint on straight-line chains
            for a in assigns:
                value = a.value
                if value is None or not self.is_u64(value):
                    continue
                for t in _assign_targets(a):
                    self.names.update(_target_names(t))

    def is_u64(self, node: ast.AST) -> bool:
        ctx = self.ctx
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Subscript):
            return self.is_u64(node.value)
        if isinstance(node, (ast.UnaryOp,)):
            return self.is_u64(node.operand)
        if isinstance(node, ast.BinOp):
            return self.is_u64(node.left) or self.is_u64(node.right)
        if isinstance(node, ast.IfExp):
            return self.is_u64(node.body) or self.is_u64(node.orelse)
        if isinstance(node, ast.Call):
            # np.uint64(x) constructor
            if _np_attr(ctx, node.func, _U64_DTYPES):
                return True
            # x.astype(np.uint64)
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in ("astype", "view")
                and node.args
                and _is_dtype_ref(ctx, node.args[0], _U64_DTYPES)
            ):
                return True
            # u64-preserving numpy transforms: np.sort(w), np.concatenate(...)
            if _np_attr(ctx, node.func, {
                "sort", "concatenate", "unique", "where", "pad", "minimum",
                "maximum", "copy", "ascontiguousarray", "flip", "roll",
            }):
                for arg in node.args:
                    elts = arg.elts if isinstance(arg, (ast.List, ast.Tuple)) else [arg]
                    if any(self.is_u64(e) for e in elts):
                        return True
        return False


def _is_tensor_annotation(ann: Optional[ast.AST]) -> bool:
    """``torch.Tensor``, ``Tensor``, ``Optional[torch.Tensor]``, and tuples
    of tensors (``Tuple[torch.Tensor, torch.Tensor]``)."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    if isinstance(ann, ast.Subscript):
        base = (dotted_name(ann.value) or "").rpartition(".")[2]
        if base not in ("Optional", "Tuple", "tuple"):
            return False
        sl = ann.slice
        elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        return any(_is_tensor_annotation(e) for e in elts)
    return (dotted_name(ann) or "").rpartition(".")[2] == "Tensor"


def _encl_class(ctx: ModuleContext, fn) -> Optional[str]:
    cur = ctx.parents.get(fn)
    return cur.name if isinstance(cur, ast.ClassDef) else None


# function scopes being typed: a call back into one of them is unknown
_IN_PROGRESS: Set[int] = set()
# callee typing follows calls this many defs deep, then types calls unknown
_CALL_DEPTH = 3
# defs whose returns are being unpacked (a recursive unpack is unknown)
_UNPACKING: Set[int] = set()


def tensor_scope(ctx: ModuleContext, fn) -> "_TensorScope":
    """The (cached) tensor typing of ``fn``, a def of ``ctx``."""
    cache = ctx.__dict__.setdefault("_tensor_scopes", {})
    key = (id(fn), len(_IN_PROGRESS) < _CALL_DEPTH)
    if key not in cache:
        _IN_PROGRESS.add(id(fn))
        try:
            cache[key] = _TensorScope(ctx, fn, follow_calls=key[1])
        finally:
            _IN_PROGRESS.discard(id(fn))
    return cache[key]


class _TensorScope:
    """Local-dataflow tensor typing for one function.

    A value is a (device) tensor when it is a parameter annotated
    ``torch.Tensor``, the result of a ``torch.*`` call (a factory only with
    a ``device=``), of ``F.*``, of a tensor method other than the host
    ones (``.item()``, ``.cpu()``, ``.numel()``, ...), of a call to a def
    that is annotated to return a tensor or returns one, or arithmetic,
    comparison or indexing of such a value; names bound from one carry it.
    A name rebound to a host value (numpy, ``.cpu()``, a Python scalar)
    drops it.
    """

    def __init__(self, ctx: ModuleContext, fn, follow_calls: bool = True):
        self.ctx = ctx
        self.fn = fn
        self.follow_calls = follow_calls
        self.cls = _encl_class(ctx, fn)
        args = fn.args
        self.names: Set[str] = {
            a.arg for a in list(args.posonlyargs) + list(args.args)
            + list(args.kwonlyargs) if _is_tensor_annotation(a.annotation)}
        self.bools: Set[str] = set()
        self.hosts: Set[str] = set()
        nodes = _scope_nodes(fn, keep_lambdas=True)
        self.returns = [n.value for n in nodes
                        if isinstance(n, ast.Return) and n.value is not None]
        assigns = [
            n for n in nodes
            if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign))
        ]
        loops = [n for n in nodes if isinstance(n, (ast.For, ast.comprehension))
                 and isinstance(n.target, ast.Name)]
        for _ in range(2):
            # a loop over a tensor, or over a literal of tensors, binds tensors
            for loop in loops:
                it = loop.iter
                elts = it.elts if isinstance(it, (ast.Tuple, ast.List)) else [it]
                if any(self.is_tensor(e) for e in elts):
                    self.names.add(loop.target.id)
            for a in assigns:
                if a.value is None:
                    continue
                for t in _assign_targets(a):
                    for el, is_t, is_b in self._bindings(t, a.value):
                        if not isinstance(el, ast.Name):
                            continue
                        if isinstance(a, ast.AugAssign):
                            if is_t:
                                self.names.add(el.id)
                            continue
                        (self.names.add if is_t else self.names.discard)(el.id)
                        (self.bools.add if is_b else self.bools.discard)(el.id)
                        is_h = not isinstance(t, (ast.Tuple, ast.List)) \
                            and self.is_host(a.value)
                        (self.hosts.add if is_h else self.hosts.discard)(el.id)

    def _bindings(self, target: ast.AST, value: ast.AST):
        """(target element, is tensor, is bool tensor) of one assignment,
        element-wise through tuple literals and tuple-returning calls."""
        if not isinstance(target, (ast.Tuple, ast.List)):
            return [(target, self.is_tensor(value), self.is_bool_tensor(value))]
        n = len(target.elts)
        if isinstance(value, (ast.Tuple, ast.List)) and len(value.elts) == n:
            return [(el, self.is_tensor(v), self.is_bool_tensor(v))
                    for el, v in zip(target.elts, value.elts)]
        if isinstance(value, ast.Call) and self._torch_call_kind(value) is None:
            rets = self._callee_returns(value)
            if rets is not None and _is_tensor_annotation(
                    getattr(rets[0].fn, "returns", None)):
                return [(el, True, False) for el in target.elts]
            if rets is not None and id(rets[0].fn) not in _UNPACKING:
                scope, values = rets
                _UNPACKING.add(id(scope.fn))
                try:
                    # each return: a tuple literal element-wise, or a call
                    # whose own returns unpack the same way
                    per_return = [
                        [(el, scope.is_tensor(v), scope.is_bool_tensor(v))
                         for el, v in zip(target.elts, ret.elts)]
                        if isinstance(ret, (ast.Tuple, ast.List))
                        else scope._bindings(target, ret)
                        for ret in values
                        if isinstance(ret, ast.Call)
                        or (isinstance(ret, (ast.Tuple, ast.List)) and len(ret.elts) == n)]
                finally:
                    _UNPACKING.discard(id(scope.fn))
                if per_return:
                    return [(el, any(r[i][1] for r in per_return),
                             any(r[i][2] for r in per_return))
                            for i, el in enumerate(target.elts)]
        is_t = self.is_tensor(value)
        return [(el, is_t, False) for el in target.elts]

    def _callee_returns(self, call: ast.Call):
        """(callee's scope, its returned expressions) for a call of a def
        the project resolves, or None."""
        ctx = self.ctx
        callee_ctx, fn = ctx, None
        if not self.follow_calls:
            return None
        if isinstance(call.func, ast.Name) and call.func.id in ctx.functions:
            fn = ctx.functions[call.func.id]
        elif ctx.project is not None:
            sym = ctx.project.resolve_call(ctx, call.func, self.cls)
            mi = ctx.project.modules.get(sym[0]) if sym else None
            if mi is not None:
                callee_ctx, fn = mi.ctx, mi.ctx.functions.get(sym[1])
        if fn is None or id(fn) in _IN_PROGRESS:
            return None
        return tensor_scope(callee_ctx, fn), tensor_scope(callee_ctx, fn).returns

    def _returns_tensor(self, call: ast.Call, bools: bool = False) -> bool:
        rets = self._callee_returns(call)
        if rets is None:
            return False
        scope, values = rets
        if not bools and _is_tensor_annotation(getattr(scope.fn, "returns", None)):
            return True
        # memoised on the callee's module: (def, bools) -> the answer
        memo = scope.ctx.__dict__.setdefault("_returns_tensor", {})
        key = (id(scope.fn), bools)
        if key not in memo:
            memo[key] = False  # a recursive call back here: unknown
            test = scope.is_bool_tensor if bools else scope.is_tensor
            memo[key] = any(test(v) for v in values)
        return memo[key]

    def _torch_call_kind(self, call: ast.Call) -> Optional[bool]:
        """True/False for a ``torch.*`` / ``F.*`` call (device tensor or
        not), None when the call is not one."""
        ctx = self.ctx
        d = dotted_name(call.func)
        if not d or "." not in d:
            return None
        root, _, rest = d.partition(".")
        if root in ctx.functional_aliases:
            return True
        if root not in ctx.torch_aliases:
            return None
        if "." in rest:
            return rest.split(".")[0] in _TORCH_OP_NAMESPACES
        if rest in _TORCH_NON_TENSOR:
            return False
        if rest.endswith("_like"):
            return bool(call.args) and self.is_tensor(call.args[0])
        if rest in _FACTORIES:
            return _device_kw(call) is not None and not _is_cpu(_device_kw(call))
        return True

    def is_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if node.attr in ("T", "mT", "data", "grad", "real", "imag"):
                return self.is_tensor(node.value)
            return False
        if isinstance(node, (ast.Subscript, ast.Starred)):
            return self.is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return not isinstance(node.op, ast.Not) and self.is_tensor(node.operand)
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return any(self.is_tensor(x) for x in [node.left] + node.comparators)
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body) or self.is_tensor(node.orelse)
        if isinstance(node, ast.Call):
            kind = self._torch_call_kind(node)
            if kind is not None:
                return kind
            if isinstance(node.func, ast.Attribute):
                recv = node.func.value
                attr = node.func.attr
                if attr in ("to", "cuda"):
                    if attr == "cuda" or _to_device_target(node) is not None:
                        target = _to_device_target(node)
                        return target is None or not _is_cpu(target)
                    return self.is_tensor(recv)
                if self.is_tensor(recv):
                    return attr not in _HOST_METHODS
            return self._returns_tensor(node)
        return False

    def is_bool_tensor(self, node: ast.AST) -> bool:
        """A tensor of booleans: a comparison of tensors, ``~``/``&``/``|``
        of boolean tensors, ``.bool()``, ``torch.isin`` and the like."""
        if isinstance(node, ast.Name):
            return node.id in self.bools
        if isinstance(node, ast.Compare):
            return self.is_tensor(node)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.is_bool_tensor(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_bool_tensor(node.left) and self.is_bool_tensor(node.right)
        if isinstance(node, ast.Call):
            tail = call_tail(node.func)
            if tail in _BOOL_METHODS:
                return self.is_tensor(node)
            if any(kw.arg == "dtype" and self.ctx.is_torch_attr(kw.value, "bool")
                   for kw in node.keywords):
                return self.is_tensor(node)
            if self._torch_call_kind(node) is None:
                return self._returns_tensor(node, bools=True)
        return False

    def is_host(self, node: ast.AST) -> bool:
        """A value known to live on the host: numpy, a ``.cpu()`` /
        ``.numpy()`` result, a CPU factory tensor, or a name bound to one."""
        ctx = self.ctx
        if isinstance(node, ast.Name):
            return node.id in self.hosts
        if isinstance(node, ast.Call):
            d = dotted_name(node.func) or ""
            if d.partition(".")[0] in ctx.numpy_aliases:
                return True
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                    "numpy", "cpu", "tolist"):
                return True
            if self._torch_call_kind(node) is False:
                return True
        return False


def _device_kw(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    return None


def _is_cpu(node: ast.AST) -> bool:
    """A literal ``"cpu"`` device (or ``torch.device("cpu")``)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and call_tail(node.func) == "device" and node.args:
        return _is_cpu(node.args[0])
    return False


def _to_device_target(call: ast.Call) -> Optional[ast.AST]:
    """The device a ``.to(...)`` call moves to, when it names one (a
    device keyword, a string, or a ``device``-named value)."""
    kw = _device_kw(call)
    if kw is not None:
        return kw
    if call.args:
        a = call.args[0]
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a
        name = (dotted_name(a) or "").rpartition(".")[2].lower()
        if "dev" in name or (isinstance(a, ast.Call) and call_tail(a.func) == "device"):
            return a
    return None


def _non_blocking(call: ast.Call) -> bool:
    return any(kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords)


def _uses_tensor(node: ast.AST, ts: _TensorScope) -> bool:
    """Does converting ``node`` to a Python bool read a tensor? ``and``/
    ``or``/``not`` convert each operand."""
    if isinstance(node, ast.BoolOp):
        return any(_uses_tensor(v, ts) for v in node.values)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        return _uses_tensor(node.operand, ts)
    return ts.is_tensor(node)


# -- R001: host syncs on the hot path ----------------------------------------


def _host_sync(ctx: ModuleContext, ts: _TensorScope, node: ast.AST) -> Optional[str]:
    """What makes ``node`` a host sync, or None."""
    if isinstance(node, ast.Subscript):
        # masked indexing: the result's size is the mask's count
        if isinstance(node.ctx, ast.Load) and ts.is_tensor(node.value) \
                and ts.is_bool_tensor(node.slice):
            return "masked indexing `x[mask]` (its size is read back)"
        return None
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    tail = call_tail(func)
    recv = func.value if isinstance(func, ast.Attribute) else None
    # downloads
    if recv is not None and tail in ("item", "tolist") and ts.is_tensor(recv):
        return f"`.{tail}()` of a tensor (device->host copy)"
    if recv is not None and tail in ("cpu", "numpy") and not ts.is_host(recv):
        return f"`.{tail}()` (device->host copy)"
    if recv is not None and tail == "to" and not _non_blocking(node):
        target = _to_device_target(node)
        if target is not None and _is_cpu(target) and not ts.is_host(recv):
            return "`.to(\"cpu\")` (device->host copy)"
        if target is not None and not _is_cpu(target) and ts.is_host(recv):
            return "`.to(device)` of a host value (host->device copy from pageable memory)"
    if isinstance(func, ast.Name) and tail in ("int", "float", "bool", "complex") \
            and node.args and ts.is_tensor(node.args[0]):
        return f"`{tail}()` of a tensor (device->host copy)"
    # explicit synchronisation (torch.cuda, an Event, a stream, device.py)
    if tail == "synchronize":
        return f"`{ast.unparse(func)}()`"
    if ctx.is_torch_attr(func, "allclose", "equal") or (
            recv is not None and tail in ("allclose", "equal") and ts.is_tensor(recv)):
        return f"`{tail}` (a Python bool from the device)"
    if recv is not None and tail == "new_tensor" and not ts.is_host(recv):
        return "`.new_tensor(...)` (host->device copy from pageable memory)"
    # uploads from pageable host memory
    if ctx.is_torch_attr(func, "tensor", "as_tensor"):
        dev = _device_kw(node)
        if dev is not None and not _is_cpu(dev):
            return (f"`torch.{tail}(..., device=...)` (host->device copy from "
                    "pageable memory)")
    # size-dependent ops
    if tail in _SIZE_DEPENDENT or tail == "repeat_interleave" or (
            tail == "where" and len(node.args) == 1 and not node.keywords):
        is_fn = ctx.is_torch_attr(func, tail)
        if not (is_fn or (recv is not None and ts.is_tensor(recv))):
            return None
        if tail == "where" and not is_fn:
            return None
        if tail == "repeat_interleave":
            if any(kw.arg == "output_size" for kw in node.keywords):
                return None
            reps = node.args[1] if is_fn and len(node.args) > 1 else (
                node.args[0] if not is_fn and node.args else None)
            reps = reps if reps is not None else next(
                (kw.value for kw in node.keywords if kw.arg == "repeats"), None)
            if reps is None or not ts.is_tensor(reps):
                return None  # integer repeats: the size is known
        return f"`{tail}` (its output size is read back)"
    return None


def _hot_functions(ctx: ModuleContext):
    for name in sorted(ctx.hot_reachable):
        fn = ctx.functions.get(name)
        if fn is not None:
            yield name, fn


@register(
    "R001",
    "host-sync-in-hot-path",
    "calls that make the host wait for the card (.item()/.tolist()/.cpu()/"
    ".numpy()/.to(\"cpu\"), int/float/bool of a tensor, synchronize, "
    "size-dependent ops, masked indexing, uploads from pageable memory) "
    "inside functions reachable from a record_function range or a kernel "
    "launch",
    mirrors="R001 host-transfer-in-jit",
)
def check_host_sync(ctx: ModuleContext) -> List[Finding]:
    findings: List[Finding] = []
    for name, fn in _hot_functions(ctx):
        ts = tensor_scope(ctx, fn)
        for node in _scope_nodes(fn, keep_lambdas=True):
            what = _host_sync(ctx, ts, node)
            if what is not None:
                findings.append(ctx.finding(
                    "R001", node,
                    f"{what} inside hot-path `{name}`: the host waits for the "
                    "card; suppress with the reason where the host needs it"))
    return findings


# -- R002: dtype-contract drift --------------------------------------------

_U64_MODULE_FUNCS = {"full", "from_u32", "shr", "shl", "rotl", "minimum",
                     "from_numpy_u64", "from_limbs"}
_U64_CALL_TAILS = {"from_numpy_u64", "from_limbs", "hash64", "mix64",
                   "mix64_bulk", "mix64_torch", "combine64", "combine64_torch"}
_U64_NAME = re.compile(r"(key64|k64)$|(^|_)words$")
_SIGNED_ORDER_FUNCS = {"minimum", "maximum", "sort", "argsort", "searchsorted"}


def _u64_aliases(ctx: ModuleContext) -> Set[str]:
    """Names bound to the port's ``core/u64.py`` module."""
    out = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name == "u64":
                    out.add(alias.asname or "u64")
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.endswith(".u64") and alias.asname:
                    out.add(alias.asname)
    return out


class _U64TorchScope:
    """Local-dataflow typing of int64 tensors that hold u64 bits."""

    def __init__(self, ctx: ModuleContext, scope: ast.AST, u64_mods: Set[str],
                 numpy_names: Set[str]):
        self.ctx = ctx
        self.u64_mods = u64_mods
        self.names: Set[str] = set()
        self.host: Set[str] = set(numpy_names)
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for a in list(scope.args.posonlyargs) + list(scope.args.args) \
                    + list(scope.args.kwonlyargs):
                if "ndarray" in (dotted_name(a.annotation) or "") or (
                        isinstance(a.annotation, ast.Constant)
                        and "ndarray" in str(a.annotation.value)):
                    self.host.add(a.arg)
        assigns = [n for n in _scope_nodes(scope)
                   if isinstance(n, (ast.Assign, ast.AnnAssign))]
        for _ in range(2):
            for a in assigns:
                if a.value is None:
                    continue
                for t in _assign_targets(a):
                    names = _target_names(t)
                    if self._is_numpy(a.value):
                        self.host.update(names)
                    elif (isinstance(t, ast.Tuple) and isinstance(a.value, ast.Call)
                          and self._u64_call(a.value) == "sort" and names):
                        self.names.add(names[0])
                    elif self.is_u64(a.value):
                        self.names.update(names)

    def _u64_call(self, call: ast.Call) -> Optional[str]:
        d = dotted_name(call.func)
        if d and d.count(".") == 1 and d.partition(".")[0] in self.u64_mods:
            return d.partition(".")[2]
        return None

    def _is_numpy(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            d = dotted_name(node.func) or ""
            if d.partition(".")[0] in self.ctx.numpy_aliases:
                return True
            if call_tail(node.func) in ("numpy", "to_numpy_u64", "astype", "tolist"):
                return True
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            return self._is_numpy(node.value)
        if isinstance(node, ast.IfExp):
            return self._is_numpy(node.body) and self._is_numpy(node.orelse)
        return isinstance(node, ast.Name) and node.id in self.host

    def is_u64(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            if node.id in self.host:
                return False
            return node.id in self.names or bool(_U64_NAME.search(node.id))
        if isinstance(node, ast.Subscript):
            return self.is_u64(node.value)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.is_u64(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitXor, ast.BitOr, ast.Add, ast.Sub, ast.Mult)):
            return self.is_u64(node.left) or self.is_u64(node.right)
        if isinstance(node, ast.Call):
            mod_fn = self._u64_call(node)
            if mod_fn is not None:
                return mod_fn in _U64_MODULE_FUNCS
            if call_tail(node.func) in _U64_CALL_TAILS:
                return True
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                    "clone", "contiguous", "reshape", "view", "flatten", "ravel",
                    "squeeze", "unsqueeze", "expand", "repeat"):
                return self.is_u64(node.func.value)
        return False


def _torch_u64_findings(ctx: ModuleContext, findings: List[Finding],
                        numpy_names: Set[str]) -> None:
    if not ctx.torch_aliases or ctx.path.replace("\\", "/").endswith("core/u64.py"):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Attribute) and ctx.is_torch_attr(
                node, "uint64", "uint32"):
            findings.append(ctx.finding(
                "R002", node,
                f"`{dotted_name(node)}` outside core/u64.py: the port holds a "
                "u64 as the bits of one int64 (torch's unsigned types lack "
                "+, >>, < and minimum)"))
    u64_mods = _u64_aliases(ctx)
    scopes = [ctx.tree] + list(ctx.functions.values())
    for scope in scopes:
        u = _U64TorchScope(ctx, scope, u64_mods, numpy_names)
        for node in _scope_nodes(scope, keep_lambdas=True):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.RShift) \
                    and u.is_u64(node.left):
                findings.append(ctx.finding(
                    "R002", node,
                    "`>>` on an int64 that holds a u64 is arithmetic (sign bits "
                    "shift in); use u64.shr"))
            elif isinstance(node, ast.Compare) and any(
                    isinstance(op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE))
                    for op in node.ops) and any(
                    u.is_u64(x) for x in [node.left] + node.comparators):
                findings.append(ctx.finding(
                    "R002", node,
                    "signed order on an int64 that holds a u64 (the sentinel -1 "
                    "sorts first); use u64.lt / u64.le"))
            elif isinstance(node, ast.Call):
                tail = call_tail(node.func)
                recv = node.func.value if isinstance(node.func, ast.Attribute) else None
                if tail in _SIGNED_ORDER_FUNCS and (
                        (ctx.is_torch_attr(node.func, tail)
                         and any(u.is_u64(a) for a in node.args))
                        or (tail in ("sort", "argsort") and recv is not None
                            and u.is_u64(recv))):
                    findings.append(ctx.finding(
                        "R002", node,
                        f"`{tail}` in signed order on an int64 that holds a u64; "
                        "use u64.minimum / u64.sort / u64.searchsorted"))
                elif tail == "to" and recv is not None and node.args \
                        and ctx.is_torch_attr(node.args[0], "int32") \
                        and isinstance(recv, (ast.Name, ast.Subscript)) \
                        and u.is_u64(recv):
                    findings.append(ctx.finding(
                        "R002", node,
                        "narrowing `.to(torch.int32)` straight off a u64 drops the "
                        "high bits; mask or shift the field out first "
                        "(u64.lo32 / u64.to_int32_bits)"))


@register(
    "R002",
    "dtype-contract-drift",
    "numpy uint64 arithmetic with untyped int literals or int64 values and "
    "narrowing casts off a uint64 word; for int64 tensors that hold u64 bits "
    "outside core/u64.py: >>, signed compares/minimum/maximum/sort/argsort/"
    "searchsorted, .to(torch.int32) with no mask, torch.uint64/uint32",
    mirrors="R002 dtype-contract-drift",
)
def check_dtype_contracts(ctx: ModuleContext) -> List[Finding]:
    findings: List[Finding] = []
    module_scope = _U64Scope(ctx, ctx.tree)
    scopes = [(ctx.tree, module_scope)]
    for fn in ctx.functions.values():
        scopes.append((fn, _U64Scope(ctx, fn, inherited=module_scope.names)))

    numpy_names: Set[str] = set()
    seen: Set[int] = set()
    for scope, u64 in scopes:
        numpy_names |= u64.names
        for node in _scope_nodes(scope, keep_lambdas=True):
            if id(node) in seen:
                continue
            # (a)/(b) uint64 mixed with untyped literal or int64 value
            if isinstance(node, ast.BinOp) and not isinstance(node.op, (ast.MatMult,)):
                left_u64, right_u64 = u64.is_u64(node.left), u64.is_u64(node.right)
                if left_u64 ^ right_u64:
                    other = node.right if left_u64 else node.left
                    if isinstance(other, ast.Constant) and isinstance(other.value, int) \
                            and not isinstance(other.value, bool):
                        seen.add(id(node))
                        findings.append(ctx.finding(
                            "R002", node,
                            "uint64 arithmetic with an untyped int literal "
                            "(NumPy 1.x value-based casting promotes through "
                            "int64 to float64 — precision loss past 2**53); "
                            "wrap the literal in np.uint64(...)"))
                    elif isinstance(other, ast.Call) and (
                        _np_attr(ctx, other.func, _I64_DTYPES)
                        or (
                            isinstance(other.func, ast.Attribute)
                            and other.func.attr == "astype"
                            and other.args
                            and _is_dtype_ref(ctx, other.args[0], _I64_DTYPES)
                        )
                    ):
                        seen.add(id(node))
                        findings.append(ctx.finding(
                            "R002", node,
                            "uint64 x int64 arithmetic promotes to float64 "
                            "(even under NEP 50) — cast one side explicitly"))
            # (c) narrowing cast straight off a uint64 word
            if isinstance(node, ast.Call):
                cast_to_narrow = (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "astype"
                    and node.args
                    and _is_dtype_ref(ctx, node.args[0], _NARROW_DTYPES)
                )
                if cast_to_narrow:
                    src_node = node.func.value
                elif _np_attr(ctx, node.func, _NARROW_DTYPES) and len(node.args) == 1:
                    src_node = node.args[0]
                else:
                    continue
                # masked/shifted words ((w >> k), (w & m)) narrow on purpose
                if isinstance(src_node, (ast.Name, ast.Subscript)) and u64.is_u64(src_node):
                    seen.add(id(node))
                    findings.append(ctx.finding(
                        "R002", node,
                        "narrowing cast directly off a uint64 packed word "
                        "drops high bits (62-bit word / 23-bit rid contract) "
                        "— mask or shift the field out explicitly first"))
    _torch_u64_findings(ctx, findings, numpy_names)
    return findings


# -- R003: Python control flow on tensors ----------------------------------


@register(
    "R003",
    "tensor-control-flow",
    "Python if/while/assert, conditional expressions and comprehension "
    "filters that test a tensor inside a hot-path function (each converts "
    "a device value to a Python bool: an implicit sync)",
    mirrors="R003 tracer-control-flow",
)
def check_tensor_control_flow(ctx: ModuleContext) -> List[Finding]:
    findings: List[Finding] = []
    for name, fn in _hot_functions(ctx):
        ts = tensor_scope(ctx, fn)
        for node in _scope_nodes(fn, keep_lambdas=True):
            tests = []
            if isinstance(node, (ast.If, ast.While)):
                tests = [(node.test, type(node).__name__.lower())]
            elif isinstance(node, ast.IfExp):
                tests = [(node.test, "conditional expression")]
            elif isinstance(node, ast.Assert):
                tests = [(node.test, "assert")]
            elif isinstance(node, ast.comprehension):
                tests = [(t, "comprehension filter") for t in node.ifs]
            for test, kind in tests:
                if _uses_tensor(test, ts):
                    findings.append(ctx.finding(
                        "R003", test,
                        f"Python {kind} on a tensor inside hot-path `{name}`: "
                        "an implicit device->host sync; keep the decision on "
                        "the card (torch.where) or suppress with the reason"))
    return findings


# -- R004: unsynced CUDA timing ----------------------------------------------


def _is_perf_counter_call(ctx: ModuleContext, node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    if isinstance(node.func, ast.Name) and node.func.id in ctx.perf_counter_names:
        return True
    d = dotted_name(node.func)
    return bool(d) and any(d == f"{t}.perf_counter" for t in ctx.time_aliases)


def _is_sync_call(ctx: ModuleContext, node: ast.Call) -> bool:
    """torch.cuda.synchronize, Event/device/stream ``.synchronize()``,
    ``.elapsed_time``, a host download, or a ``sync``/``synced`` helper."""
    tail = call_tail(node.func)
    return tail in ("synchronize", "elapsed_time", "sync", "synced", "item",
                    "tolist", "cpu", "numpy")


def _is_trivial_call(ctx: ModuleContext, node: ast.Call) -> bool:
    if _is_perf_counter_call(ctx, node):
        return True
    return call_tail(node.func) in _TRIVIAL_CALLS


@register(
    "R004",
    "unsynced-cuda-timing",
    "time.perf_counter() windows that run real work with no "
    "torch.cuda.synchronize, Event.synchronize/elapsed_time, "
    "device.synchronize or host download before the clock stops (CUDA "
    "launches are async: the window measures enqueue time)",
    mirrors="R004 unsynced-benchmark-timing",
)
def check_unsynced_timing(ctx: ModuleContext) -> List[Finding]:
    if not ctx.imports_torchlike:
        return []
    findings: List[Finding] = []
    scopes: List[ast.AST] = [ctx.tree] + list(ctx.functions.values())
    for scope in scopes:
        nodes = _scope_nodes(scope, keep_lambdas=True)
        starts = [
            (n.targets[0].id, n.lineno)
            for n in nodes
            if isinstance(n, ast.Assign)
            and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Name)
            and _is_perf_counter_call(ctx, n.value)
        ]
        stops = [
            (n.right.id, n.lineno, n)
            for n in nodes
            if isinstance(n, ast.BinOp)
            and isinstance(n.op, ast.Sub)
            and _is_perf_counter_call(ctx, n.left)
            and isinstance(n.right, ast.Name)
        ]
        for var, start_line in starts:
            matching = [s for s in stops if s[0] == var and s[1] >= start_line]
            if not matching:
                continue
            _, stop_line, stop_node = min(matching, key=lambda s: s[1])
            window = [
                c for c in nodes
                if isinstance(c, ast.Call) and start_line < c.lineno <= stop_line
            ]
            if any(_is_sync_call(ctx, c) for c in window):
                continue
            if any(not _is_trivial_call(ctx, c) for c in window):
                findings.append(ctx.finding(
                    "R004", stop_node,
                    f"timing window `{var}` (opened line {start_line}) stops "
                    "the clock without a synchronize or host download of the "
                    "timed outputs — measures CUDA enqueue, not execution"))
    return findings


# -- R005: no counterpart ------------------------------------------------------

register_without_counterpart(
    "R005", "R005 jit-cache-hazard",
    "eager PyTorch has no trace cache to miss, and kernels/_build.py builds "
    "and loads each CUDA library once per process (a Kernel binds its "
    "symbol at first launch); nothing to check")
