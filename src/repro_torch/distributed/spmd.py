"""The collectives that the reference's sharding constraints imply, as
autograd functions over a ``DeviceMesh``'s named dims.

Under ``sharding.use_rules`` the models keep plain local tensors: each
rank holds its rows of the batch (split over the "batch" dims), its
block of each parameter (``sharding.shard_params``) and, inside a
tensor-parallel layer, its heads, ffn columns, experts or vocab rows
(the "model" dim). Each rank's autograd then computes its part of the
gradient of one global loss, on these conventions:

- a tensor that every rank of a mesh dim computes alike (replicated)
  has the same gradient on each; one that the ranks of a dim compute in
  parts ("partial") has its gradient summed over the dim where the parts
  meet: ``enter`` (forward identity, backward all-reduce) where a
  replicated tensor feeds per-rank work, ``reduce`` (forward all-reduce,
  backward identity) where per-rank parts sum into a replicated tensor
  (Megatron's f and g), and ``psum`` (both all-reduces) where per-rank
  parts sum into a tensor that each rank then uses for its own part of
  the work (Mamba's B, C and dt inputs, RWKV's output norm);
- ``gather`` joins per-rank blocks along a tensor dim: its backward
  takes this rank's block of the gradient (``grad="slice"``, the tensor
  is used alike after the gather) or reduce-scatters it (``"sum"``: an
  FSDP weight, used on every rank's own rows);
- ``weight`` is a parameter as its layer uses it: its fsdp block gathered
  over the batch dims (backward reduce-scatter), its gradient summed over
  the batch dims it is not split over, and, for a layer whose ranks of a
  non-batch dim do different work with it (``split``), over those too;
  ``part`` is this rank's slice of a parameter replicated by the rules
  that its layer reads only in part (a bias or a per-channel vector of
  a layer split over "model"), its gradient summed alike.

These are the reference's ``shard_map`` semantics for an input replicated
over a mesh axis: its cotangent is summed over the axes its spec does not
mention. All collectives are ``torch.distributed``'s own (gloo takes
all of them for CUDA tensors; DTensor's functional all-gather does not,
``sharding``'s docstring). Reductions of 16-bit floats run in float32,
but for a sum over one mesh dim of 2 ranks, which they send in their
own type: gloo adds two of them in float32 and rounds once, as the
float32 sum then a cast does (bit-equal), with half the bytes.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from ..core.routing import linear_shard_index
from .sharding import (NamedSharding, active_rules, axes_of, axis_size,
                       sharding_of)

Axes = Tuple[str, ...]


def _sum_type(x: torch.Tensor, mesh, axes: Axes) -> torch.dtype:
    """The type ``x`` is summed in over ``axes`` (module docstring)."""
    if x.dtype not in (torch.bfloat16, torch.float16):
        return x.dtype
    pair = len(axes) == 1 and mesh.size(mesh.mesh_dim_names.index(axes[0])) == 2
    return x.dtype if pair else torch.float32


def _all_reduce(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    if not axes:
        return x
    work = _sum_type(x, mesh, axes)
    y = x.to(work) if work != x.dtype else x.clone()
    for a in axes:
        dist.all_reduce(y, group=mesh.get_group(a))  # repro: noqa[R001] gloo stages CUDA tensors through host memory
    return y.to(x.dtype)


def _all_gather(x: torch.Tensor, dim: int, mesh, axes: Axes) -> torch.Tensor:
    """Blocks joined along ``dim`` in row-major order over ``axes``
    (the innermost dim gathered first)."""
    for a in reversed(axes):
        n = mesh.size(mesh.mesh_dim_names.index(a))
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=mesh.get_group(a))  # repro: noqa[R001] gloo stages CUDA tensors through host memory
        x = out.movedim(0, dim)
    return x


# elements a reduce-scatter sends at once: a gradient is summed a slab of
# this rank's rows at a time, not as one copy (in float32, where it is
# summed in float32) of the whole gathered gradient (1.85 GB for
# deepseek-v3's head block)
SCATTER_SLAB = 1 << 26


def _reduce_scatter(x: torch.Tensor, dim: int, mesh, axes: Axes) -> torch.Tensor:
    """The adjoint of ``_all_gather``: summed over ``axes``, this rank's
    block of ``dim`` kept (the outermost dim first)."""
    for a in axes:
        n = mesh.size(mesh.mesh_dim_names.index(a))
        work = _sum_type(x, mesh, (a,))
        src = x.movedim(dim, 0)
        rows, tail = src.shape[0] // n, tuple(src.shape[1:])
        blocks = src.reshape((n, rows) + tail)
        out = torch.empty((rows,) + tail, dtype=work, device=src.device)
        step = max(1, SCATTER_SLAB // max(1, n * blocks[0, 0].numel()))
        for r0 in range(0, rows, step):
            part = blocks[:, r0:r0 + step].to(work).contiguous()
            dist.reduce_scatter_tensor(out[r0:r0 + step],  # repro: noqa[R001] gloo stages CUDA tensors through host memory
                                       part.reshape((-1,) + tail), group=mesh.get_group(a))
        x = out.to(x.dtype).movedim(0, dim)
    return x


def block(x: torch.Tensor, dim: int, mesh, axes: Axes) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes`` (a slice:
    autograd needs no rule)."""
    if not axes:
        return x
    size = x.shape[dim] // axis_size(mesh, axes)
    return x.narrow(dim, linear_shard_index(mesh, axes) * size, size).contiguous()


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.mesh, ctx.axes), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x.contiguous(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes, grad):
        ctx.dim, ctx.mesh, ctx.axes, ctx.grad = dim, mesh, axes, grad
        return _all_gather(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            out = _reduce_scatter(g, ctx.dim, ctx.mesh, ctx.axes)
        else:
            out = block(g, ctx.dim, ctx.mesh, ctx.axes)
        return out, None, None, None, None


class _AllToAll(torch.autograd.Function):
    """Equal splits of dim 0 exchanged over one mesh dim; its own adjoint."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _exchange(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.mesh, ctx.axis), None, None


def _exchange(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.get_group(axis))  # repro: noqa[R001] gloo stages CUDA tensors through host memory
    return out


def enter(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Forward identity, backward all-reduce over ``axes`` (f)."""
    return _Enter.apply(x, mesh, tuple(axes)) if axes else x


def reduce(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Forward all-reduce (sum) over ``axes``, backward identity (g)."""
    return _Reduce.apply(x, mesh, tuple(axes)) if axes else x


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Forward all-reduce (sum) over ``axes`` and backward all-reduce:
    per-rank parts summed into a tensor that each rank then uses for its
    own part of the work (``enter(reduce(x))``)."""
    return enter(reduce(x, mesh, axes), mesh, axes)


def gather(x: torch.Tensor, dim: int, mesh, axes: Axes, grad: str = "slice") -> torch.Tensor:
    """Blocks joined along ``dim`` over ``axes``; ``grad`` "slice" or
    "sum" (module docstring)."""
    if not axes:
        return x
    return _Gather.apply(x, dim % x.ndim, mesh, tuple(axes), grad)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The reference's tiled ``all_to_all`` over split and concat axis 0."""
    return _AllToAll.apply(x, mesh, axis)


def batch_axes(rules) -> Axes:
    return axes_of(rules.axis("batch"))


def tp_axes(p, dim: int) -> Axes:
    """The mesh dims a parameter's tensor dim ``dim`` is split over (its
    layer works on that block: heads, ffn columns, experts, vocab rows)."""
    sh = sharding_of(p)
    return () if sh is None else axes_of(sh.spec[dim])


def weight(p: torch.Tensor, split: bool = False) -> torch.Tensor:
    """``p`` as its layer uses it: the whole parameter without rules;
    under rules (module docstring) its block gathered over the batch dims
    that split it, with the gradient summed over the batch dims that do
    not and, with ``split``, over the non-batch dims that do not."""
    rules = active_rules()
    sh = sharding_of(p)
    if rules is None:
        if sh is not None:
            raise RuntimeError("a sharded parameter is used without sharding rules")
        return p
    if sh is None:
        raise RuntimeError("under sharding rules every parameter is a block "
                           "(sharding.shard_params)")
    mesh = rules.mesh
    batch = batch_axes(rules)
    w = p
    for a in reversed(batch):
        d = sh.dim_of(a)
        w = gather(w, d, mesh, (a,), grad="sum") if d is not None else enter(w, mesh, (a,))
    if split:
        used = sh.split_dims()
        w = enter(w, mesh, tuple(a for a in mesh.mesh_dim_names
                                 if a not in batch and a not in used))
    return w


def part(p: torch.Tensor, dim: int, axes: Axes) -> torch.Tensor:
    """This rank's block along ``dim`` over ``axes`` (a layer's "model"
    dims) of ``p`` as ``weight(p, split=True)`` gives it: a parameter the
    rules replicate but whose layer reads only this rank's channels of
    it. Without ``axes``, ``weight(p)``."""
    if not axes:
        return weight(p)
    return block(weight(p, split=True), dim, active_rules().mesh, axes)


def batch_rows(x: torch.Tensor) -> torch.Tensor:
    """Under rules, this rank's rows (dim 0) of a global batch tensor, or
    the whole batch on every rank when its rows do not divide over the
    batch dims (the reference's rule: ``lshard``'s guard replicates the
    dim, and its MoE sets ``batch_axis=None, dp=1``). Without rules,
    ``x``."""
    rules = active_rules()
    if rules is None:
        return x
    axes = batch_axes(rules)
    if x.shape[0] % axis_size(rules.mesh, axes):
        return x
    return block(x, 0, rules.mesh, axes)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """Under rules, the mean over the batch dims' ranks of a per-rank
    mean over equal row counts (the global mean), replicated; backward
    as the mean's. Where ``batch_rows`` replicated the batch, every rank's
    mean is the global one and this returns it, each rank's gradient a
    share that the parameters' gradient sums over the batch dims
    (``weight``) add up to the mean's. Without rules, ``x``."""
    rules = active_rules()
    if rules is None:
        return x
    axes = batch_axes(rules)
    return reduce(x / axis_size(rules.mesh, axes), rules.mesh, axes)


def gather_mesh(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` (no autograd): shape ``mesh.shape + x.shape``."""
    y = x.reshape((1,) * mesh.ndim + tuple(x.shape))
    for i, a in enumerate(mesh.mesh_dim_names):
        y = _all_gather(y, i, mesh, (a,))
    return y


def global_sq_norm(grads: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
    """The float32 sum of squares of the global gradients, on every rank:
    each block's sum over the ranks that hold it (divided by its replica
    count, then one all-reduce over the mesh). Every parameter must hold
    a block of one mesh."""
    total, mesh = None, None
    for k, g in grads.items():
        sh: NamedSharding = sharding_of(params[k])
        s = torch.sum(torch.square(g.to(torch.float32))) / sh.replicas()
        total = s if total is None else total + s
        mesh = sh.mesh
    return _all_reduce(total, mesh, tuple(mesh.mesh_dim_names))
