"""Fault-tolerant checkpoints of nested dicts (and lists) of tensors.

Port of the JAX package's ``training/checkpoint.py``, on its on-disk
format, so each package reads the other's checkpoints:

- ``step_%010d/`` written as ``step_%010d.tmp/`` and published by an
  atomic rename, then ``LATEST`` replaced atomically; ``keep``
  checkpoints kept;
- ``arrays.npz`` with one ``leaf_i`` a leaf, ``meta.json`` with each
  leaf's dtype name and crc32; bfloat16 stored as a ``uint16`` view;
- leaves in ``jax.tree_util``'s flatten order: dict keys sorted, lists
  and tuples in order.

Works for the train state and for HDB iteration state alike (bool, int,
uint, float, bfloat16 tensors). ``restore`` fills a template in place:
each tensor keeps its device and dtype, so a state restores onto
whatever device its template was built on (the reference's elastic
``sharding`` argument) and a train state keeps its tensors' identity.

A sharded state (leaves that hold a block, ``distributed.sharding.
sharding_of``) is saved whole: every rank copies its block of each such
leaf to the host and gathers it to rank 0 (a collective over the world:
every rank calls ``save``), rank 0 writes, and all ranks wait for the
write. ``restore`` reads the whole leaf on every rank and keeps the
rank's block.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
import zlib
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.sharding import block_slices, sharding_of

_BF16 = "bfloat16"


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of ``tree`` in ``jax.tree_util.tree_flatten`` order
    (``None`` holds no leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if tree is None:
        return []
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"checkpoint leaves are tensors, not {type(tree).__name__}")
    return [tree]


def _structure(tree: Any) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "None" if tree is None else "*"


def _dtype_name(t: torch.Tensor) -> str:
    return _BF16 if t.dtype == torch.bfloat16 else str(t.dtype).removeprefix("torch.")


def _leaf_to_np(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of ``t``: ``t`` may change after save
    returns); bfloat16 as its raw uint16 bits."""
    bf16 = t.dtype == torch.bfloat16
    arr = (t.detach().view(torch.int16) if bf16 else t.detach()).to("cpu", copy=True).numpy()
    return arr.view(np.uint16) if bf16 else arr


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B")) & 0xFFFFFFFF


def save(directory: str, step: int, tree: Any, *, blocking: bool = True,
         keep: int = 3) -> str:
    """Atomically write ``tree`` under directory/step_<step>.

    Every leaf is copied to the host before this returns, so with
    ``blocking=False`` the writer thread holds the state as it was at
    the call, whatever the caller then updates in place. A sharded state
    is written before this returns, on any rank."""
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    leaves = tree_leaves(tree)
    sharded = any(sharding_of(leaf) is not None for leaf in leaves)
    writer = not (sharded and dist.is_initialized()) or dist.get_rank() == 0
    arrays = {}
    meta = {"step": step, "num_leaves": len(leaves), "treedef": _structure(tree),
            "dtypes": [], "crc": []}
    # gloo gathers host tensors; another backend (NCCL) gets a gloo group
    # of the world for this save
    group = None if not sharded or dist.get_backend() == "gloo" else \
        dist.new_group(backend="gloo")
    for i, leaf in enumerate(leaves):
        whole = _gather_block(leaf, group) if sharding_of(leaf) is not None else leaf
        if writer:
            arr = _leaf_to_np(whole)
            meta["dtypes"].append(_dtype_name(leaf))
            meta["crc"].append(_crc(arr))
            arrays[f"leaf_{i}"] = arr
    if group is not None:
        dist.destroy_process_group(group)
    if writer:
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

    def _write():
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(directory, "LATEST.tmp"),
                   os.path.join(directory, "LATEST"))
        _gc(directory, keep)

    if not writer:
        pass
    elif blocking or sharded:
        _write()
    else:
        threading.Thread(target=_write, daemon=True).start()
    if sharded and dist.is_initialized():
        dist.barrier()
    return final


@torch.no_grad()
def _gather_block(leaf: torch.Tensor, group) -> Optional[torch.Tensor]:
    """The whole tensor of which ``leaf`` holds a block, on rank 0's host
    (None on the other ranks): each rank sends the host copy of its block
    once, and rank 0 places every rank's block by its mesh coordinate."""
    sh = sharding_of(leaf)
    block = leaf.detach().to("cpu", copy=True).contiguous()
    me = dist.get_rank()
    blocks = [torch.empty_like(block) for _ in range(dist.get_world_size())] \
        if me == 0 else None
    dist.gather(block, blocks, dst=0, group=group)
    if me != 0:
        return None
    whole = torch.empty(sh.shape, dtype=block.dtype)
    ranks = sh.mesh.mesh
    for coord in itertools.product(*(range(n) for n in ranks.shape)):
        whole[block_slices(sh, coord)] = blocks[int(ranks[coord])]
    return whole


def _gc(directory: str, keep: int):
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    path = os.path.join(directory, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def _np_to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@torch.no_grad()
def restore(directory: str, template: Any, step: Optional[int] = None) -> Any:
    """Fill ``template``'s tensors in place from the checkpoint at ``step``
    (default: ``LATEST``) and return it. Each leaf's crc32 is checked
    (``IOError`` on corruption), and its dtype and shape must be the
    template's."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    src = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(src, "meta.json")) as f:
        meta = json.load(f)
    leaves = tree_leaves(template)
    if meta["num_leaves"] != len(leaves):
        raise ValueError(f"checkpoint/template mismatch: {meta['num_leaves']} "
                         f"leaves saved, {len(leaves)} in the template")
    with np.load(os.path.join(src, "arrays.npz")) as data:
        for i, leaf in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            crc = _crc(arr)
            if crc != meta["crc"][i]:
                raise IOError(f"checkpoint corruption at leaf {i} "
                              f"(crc {crc} != {meta['crc'][i]})")
            got = _np_to_tensor(arr, meta["dtypes"][i])
            sh = sharding_of(leaf)
            if sh is not None and tuple(got.shape) == sh.shape:
                got = got[block_slices(sh)]
            if got.dtype != leaf.dtype or got.shape != leaf.shape:
                raise ValueError(f"leaf {i}: saved {meta['dtypes'][i]} "
                                 f"{tuple(got.shape)}, template {leaf.dtype} "
                                 f"{tuple(leaf.shape)}")
            leaf.copy_(got)
    return template
