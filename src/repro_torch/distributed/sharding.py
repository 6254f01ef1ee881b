"""Logical-axis sharding rules, and shard ids and process groups over a
``DeviceMesh``'s named dims.

Port of the JAX package's ``distributed/sharding.py``. ``mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names``
are the reference's axis names; every rank runs the same host loop
(SPMD). A spec is the reference's ``PartitionSpec`` as a tuple with one
entry per tensor dim: a mesh dim name, a tuple of them (the dim split
over them in row-major order), or None (replicated).

- Blocking: a rank's shard id is its row-major position over
  ``axis_names`` (the reference's ``linear_shard_index``); the
  collectives of a routed step run on the group of the ranks those dims
  span, whose group-rank order must be the shard order (``shards``).
- Models: ``ShardingRules`` maps logical axis names ("batch", "heads",
  "experts", ...) to mesh dims; ``production_rules`` is the reference's
  table; ``use_rules`` makes rules active for the code under it. With
  no active rules every annotation is a no-op and the models run on one
  device unchanged. ``param_sharding`` gives each parameter its spec from
  the reference's path-pattern table, and ``shard_params`` keeps only
  this rank's block of each (``NamedSharding`` on the parameter says
  which); ``models`` then uses the blocks through
  ``distributed.spmd``.
- The reference's ``lshard`` constraints have no function here: the
  models' activations are plain local tensors, and the layers make the
  collectives those constraints imply (``distributed.spmd``). DTensor's
  redistributions are not used: its functional all-gather crashes with
  gloo on CUDA tensors (SIGSEGV, torch 2.11 on an H100), and four ranks
  on one card must use gloo.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.routing import linear_shard_index

Spec = Tuple[object, ...]  # a mesh dim name, a tuple of names, or None per tensor dim


def axis_size(mesh, ax) -> int:
    """Total rank count over a mesh dim name, a tuple of them, or None (=1)."""
    if ax is None:
        return 1
    axes = ax if isinstance(ax, tuple) else (ax,)
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axes_of(ax) -> Tuple[str, ...]:
    """A spec entry as a tuple of mesh dim names (None: none)."""
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


@dataclasses.dataclass(frozen=True)
class Shards:
    """This rank's place among the shards of ``axis_names``."""

    group: object     # the ProcessGroup the routed collectives run on
    shard: int        # row-major position over axis_names
    n_shards: int


def _dims(mesh, axes: Tuple[str, ...]) -> Tuple[int, ...]:
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"mesh dims {names} have no {missing}")
    return tuple(names.index(a) for a in axes)


def shards(mesh, axis_names: Sequence[str]) -> Shards:
    """The group and shard id of this rank over ``axis_names``.

    ``axis_names`` is one mesh dim, or every dim of the mesh in its
    order (the reference's flat, pod and 3-axis meshes), so that group
    rank order is shard order.
    """
    axes = tuple(axis_names)
    dims = _dims(mesh, axes)
    if len(dims) == 1:
        group = mesh.get_group(dims[0])
    elif dims == tuple(range(mesh.ndim)):
        ranks = mesh.mesh.flatten().tolist()
        if ranks != list(range(dist.get_world_size())):
            raise ValueError("a multi-dim mesh must hold every rank of the "
                             "world in rank order")
        group = dist.group.WORLD
    else:
        raise ValueError(f"axis_names {axes} must be one mesh dim or all of "
                         f"{tuple(mesh.mesh_dim_names)} in order")
    shard = linear_shard_index(mesh, axes)
    if dist.get_rank(group) != shard:
        raise ValueError(f"group rank {dist.get_rank(group)} is not shard "
                         f"{shard}: the mesh's ranks must ascend row-major")
    return Shards(group, shard, axis_size(mesh, axes))


# ---------------------------------------------------------------------------
# logical rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh dim (str, tuple of str, or None)."""

    mesh: object
    rules: Tuple[Tuple[str, object], ...]

    def axis(self, logical: Optional[str]):
        if logical is None:
            return None
        for name, mesh_axis in self.rules:
            if name == logical:
                return mesh_axis
        return None

    def spec(self, *logical: Optional[str]) -> Spec:
        return tuple(self.axis(l) for l in logical)


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data-like dims ("pod", "data"), in mesh order."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def production_rules(mesh, *, fsdp: bool = True, seq_shard: bool = False) -> ShardingRules:
    """The reference's default rules: batch -> every data-like dim (DP);
    heads/ffn/experts/vocab -> "model" (TP/EP); with ``fsdp`` the
    parameters' embed dim on "data"; with ``seq_shard`` the sequence and
    KV-cache dims on the data dims (SP)."""
    axes = data_axes(mesh)
    batch = axes if len(axes) > 1 else (axes[0] if axes else None)
    rules = [
        ("batch", batch),
        ("seq", batch if seq_shard else None),
        ("kv_seq", batch if seq_shard else None),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("ffn", "model"),
        ("experts", "model"),
        ("vocab", "model"),
        ("embed", None),
        ("fsdp", "data" if fsdp and "data" in mesh.mesh_dim_names else None),
        ("state", "model"),
        ("moe_ff", None),  # expert-internal ff dim (serving TP; the dry run)
    ]
    return ShardingRules(mesh=mesh, rules=tuple(rules))


_ACTIVE: contextvars.ContextVar[Optional[ShardingRules]] = \
    contextvars.ContextVar("sharding_rules", default=None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    token = _ACTIVE.set(rules)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_rules() -> Optional[ShardingRules]:
    return _ACTIVE.get()


def guard_spec(mesh, shape, spec: Spec) -> Spec:
    """Replicate any dim whose size doesn't divide its assigned dims
    (GQA archs with kv_heads < the model dim's size, odd vocab, ...)."""
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(ax if ax is not None and dim % axis_size(mesh, ax) == 0 else None
                 for dim, ax in zip(shape, padded))


# ---------------------------------------------------------------------------
# parameter sharding: leaf-name pattern -> logical axes
# ---------------------------------------------------------------------------

# Patterns are matched against the '/'-joined param path. First match wins.
# Axis entries name the LOGICAL axis of each tensor dim (None = replicated).
_PARAM_PATTERNS: Sequence[Tuple[str, Optional[Tuple[Optional[str], ...]]]] = (
    # embeddings / output head: vocab-parallel + FSDP on embed
    (r"embed/table$", ("vocab", "fsdp")),
    (r"lm_head/w$", ("fsdp", "vocab")),
    # attention
    (r"attn/wq$", ("fsdp", "heads", None)),
    (r"attn/wk$", ("fsdp", "kv_heads", None)),
    (r"attn/wv$", ("fsdp", "kv_heads", None)),
    (r"attn/wo$", ("heads", None, "fsdp")),
    # MLA
    (r"attn/w_dq$", ("fsdp", None)),
    (r"attn/w_uq$", (None, "heads", None)),
    (r"attn/w_dkv$", ("fsdp", None)),
    (r"attn/w_ukv$", (None, "heads", None)),
    (r"attn/w_kr$", ("fsdp", None)),
    # dense mlp
    (r"mlp/w_gate$", ("fsdp", "ffn")),
    (r"mlp/w_up$", ("fsdp", "ffn")),
    (r"mlp/w_down$", ("ffn", "fsdp")),
    # moe
    (r"moe/router$", ("fsdp", None)),
    (r"moe/w_gate$", ("experts", "fsdp", "moe_ff")),
    (r"moe/w_up$", ("experts", "fsdp", "moe_ff")),
    (r"moe/w_down$", ("experts", "moe_ff", "fsdp")),
    (r"moe/shared_.*$", ("fsdp", "ffn")),
    (r"moe/shared_down$", ("ffn", "fsdp")),
    # mamba
    (r"mamba/w_in$", ("fsdp", "ffn")),
    (r"mamba/w_z$", ("fsdp", "ffn")),
    (r"mamba/w_out$", ("ffn", "fsdp")),
    (r"mamba/(w_b|w_c|w_dt)$", ("ffn", None)),
    (r"mamba/(a_log|dt_bias)$", ("ffn",) + (None,)),
    (r"mamba/conv$", (None, "ffn")),
    # rwkv
    (r"rwkv/(w_r|w_k|w_v|w_g|w_w)$", ("fsdp", "ffn")),
    (r"rwkv/w_o$", ("ffn", "fsdp")),
    (r"rwkv/.*lora.*$", (None, None)),
    # norms / scalars: replicated
    (r".*(norm|ln|bias|scale).*$", None),
)


def logical_axes_for(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The reference's lookup, quirks included: a pattern one axis short
    of ``ndim`` takes a leading None (a scanned leaf's stack axis), and a
    pattern of another length is passed over (a 1-D Mamba ``dt_bias``
    misses its 2-axis pattern and lands on the norm/bias catch-all)."""
    for pattern, axes in _PARAM_PATTERNS:
        if re.search(pattern, path):
            if axes is None:
                return (None,) * ndim
            if len(axes) == ndim:
                return axes
            if len(axes) == ndim - 1:
                return (None,) + tuple(axes)
    return (None,) * ndim


def param_sharding(named_shapes: Iterable[Tuple[str, Sequence[int]]],
                   rules: ShardingRules) -> Dict[str, Spec]:
    """{name: spec} of ``(name, shape)`` pairs (``model.named_parameters()``
    serves: a tensor's ``shape`` is read) by the pattern table, over the
    name's '/'-joined path. The port's layers carry no stack axis, so a
    scanned leaf's spec in the reference has one more (leading) entry."""
    out = {}
    for name, shape in named_shapes:
        shape = tuple(getattr(shape, "shape", shape))
        axes = logical_axes_for(name.replace(".", "/"), len(shape))
        out[name] = guard_spec(rules.mesh, shape, rules.spec(*axes))
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor held as this rank's block of a global tensor: the
    reference's ``NamedSharding(mesh, spec)``. ``shape`` is the global
    shape."""

    mesh: object
    spec: Spec
    shape: Tuple[int, ...]

    def dim_of(self, axis: str) -> Optional[int]:
        """The tensor dim split over mesh dim ``axis``, or None."""
        for d, ax in enumerate(self.spec):
            if axis in axes_of(ax):
                return d
        return None

    def split_dims(self) -> set:
        """The mesh dims the spec splits a tensor dim over."""
        return {a for ax in self.spec for a in axes_of(ax)}

    def replicas(self) -> int:
        """How many ranks hold each block: the sizes of the mesh dims the
        spec does not split."""
        used = self.split_dims()
        return axis_size(self.mesh, tuple(a for a in self.mesh.mesh_dim_names
                                          if a not in used))


def sharding_of(t) -> Optional[NamedSharding]:
    """The ``NamedSharding`` of a tensor holding a block, else None."""
    return getattr(t, "named_sharding", None)


def block_slices(sh: NamedSharding, coord: Optional[Sequence[int]] = None
                 ) -> Tuple[slice, ...]:
    """The block of a tensor of ``sh.shape`` that this rank holds, or the
    rank at mesh coordinate ``coord``."""
    names = tuple(sh.mesh.mesh_dim_names)
    out = []
    for dim, ax in zip(sh.shape, sh.spec):
        axes = axes_of(ax)
        if not axes:
            out.append(slice(None))
            continue
        n = axis_size(sh.mesh, axes)
        if coord is None:
            i = linear_shard_index(sh.mesh, axes)
        else:
            i = 0
            for a in axes:
                d = names.index(a)
                i = i * sh.mesh.size(d) + coord[d]
        out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(out)


def local_block(x: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    """A contiguous copy of this rank's block of the global tensor ``x``."""
    if tuple(x.shape) != sh.shape:
        raise ValueError(f"global shape {tuple(x.shape)} is not {sh.shape}")
    return x[block_slices(sh)].clone(memory_format=torch.contiguous_format)


def mark(t: torch.Tensor, sh: Optional[NamedSharding]) -> torch.Tensor:
    """Record that ``t`` holds the block ``sh`` describes (None: a whole
    tensor); returns ``t``."""
    if sh is not None:
        t.named_sharding = sh
    return t


@torch.no_grad()
def shard_params(module: torch.nn.Module, rules: ShardingRules) -> Dict[str, Spec]:
    """Keep only this rank's block of each parameter of ``module`` (the
    same global values on every rank, as ``build_model`` from one seed
    gives them), in place: each ``nn.Parameter`` keeps its identity, its
    data becomes the block, and its ``named_sharding`` says which.
    Returns ``param_sharding``'s specs."""
    specs = param_sharding(module.named_parameters(), rules)
    for name, p in module.named_parameters():
        if sharding_of(p) is not None:
            raise ValueError(f"{name} is sharded already")
        sh = NamedSharding(rules.mesh, specs[name], tuple(p.shape))
        p.data = local_block(p.data, sh)
        mark(p, sh)
    return specs
