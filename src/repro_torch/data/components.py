"""Graph partitioning — stage 4 of the dedup pipeline (paper §1).

Port of the JAX package's ``data/components.py``: connected components by
frontier-masked min-label hooking of component ROOTS plus full path
compression, with a hard ``max_rounds`` bound and a ``converged`` flag
(truncation warns). ``label.at[la].min(new)`` becomes
``scatter_reduce_(..., "amin")``. The survivor of each component is its
min record id, which is the label itself. Zero-padded pair tails are
(0, 0) self-edges, which the frontier mask drops.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

_INT32_MAX = 2**31 - 1


def _cc_device(a: torch.Tensor, b: torch.Tensor, *, num_nodes: int,
               max_rounds: int):
    """Bounded label-propagation fixpoint -> (label, converged, rounds)."""
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    label = torch.arange(num_nodes, dtype=torch.int32, device=a.device)
    changed, rounds = True, 0
    while changed and rounds < max_rounds:
        la, lb = label[a], label[b]
        # settled edges (la == lb, including (0, 0) padding) push INT32_MAX
        new = torch.where(la != lb, torch.minimum(la, lb), _INT32_MAX)
        # hook the ROOTS: after compression every member points at its root
        label2 = label.scatter_reduce(0, la.to(torch.int64), new, "amin")
        label2 = label2.scatter_reduce(0, lb.to(torch.int64), new, "amin")
        # full path compression: labels point downward, so this terminates
        while True:
            nxt = label2[label2.to(torch.int64)]
            if torch.equal(nxt, label2):  # repro: noqa[R001] converged? the host decides the next round
                break
            label2 = nxt
        changed = not torch.equal(label2, label)  # repro: noqa[R001] converged? the host decides the next round
        label = label2
        rounds += 1
    # `changed` False: the last round was a fixpoint check with nothing to do
    return label, not changed, rounds


def _survivors_device(label: torch.Tensor):
    """Sorted component roots (== ``np.unique(label)``)."""
    idx = torch.arange(label.shape[0], dtype=torch.int32, device=label.device)
    return idx[label == idx]  # repro: noqa[R001] survivors: the labels that are their own root


def cluster_pairs_device(num_nodes: int, a: torch.Tensor, b: torch.Tensor, *,
                         max_rounds: int = 64, device: DeviceLike = None):
    """Cluster a (possibly zero-padded) pair buffer on the device.

    Returns ``(label, survivors, n_survivors, converged, rounds)``, the
    reference's tuple: ``label`` has one entry per node, ``survivors`` one
    per component (no capacity padding to crop).
    """
    dev = resolve_device(device)
    label, converged, rounds = _cc_device(
        a.to(dev), b.to(dev), num_nodes=num_nodes, max_rounds=max_rounds)
    surv = _survivors_device(label)
    return label, surv, surv.shape[0], converged, rounds


def _warn_truncated(max_rounds: int) -> None:
    warnings.warn(
        f"connected_components stopped at max_rounds={max_rounds} before "
        "convergence; labels may merge further — raise max_rounds",
        RuntimeWarning, stacklevel=3)


@dataclasses.dataclass
class ClusterResult:
    """Host-side clustering outcome (the only values that cross over)."""
    label: np.ndarray        # (N,) int64 component label = min member id
    survivors: np.ndarray    # (S,) int64 sorted canonical record ids
    converged: bool          # False iff truncated at max_rounds
    rounds: int              # propagation rounds actually run


def cluster_edges(num_nodes: int, a: np.ndarray, b: np.ndarray, *,
                  max_rounds: int = 64, device: DeviceLike = None
                  ) -> ClusterResult:
    """Host edge list -> ClusterResult through the device CC path.

    The reference pads edges and nodes to powers of two to bound its jit
    compiles; padding edges are (0, 0) no-ops and padding nodes are
    isolated, so the unpadded run gives the same labels, survivors,
    ``converged`` and ``rounds``.
    """
    if len(a) == 0:
        label = np.arange(num_nodes, dtype=np.int64)
        return ClusterResult(label=label, survivors=label.copy(),
                             converged=True, rounds=0)
    dev = resolve_device(device)
    at = torch.from_numpy(np.asarray(a, np.int64)).to(dev)  # repro: noqa[R001] host numpy edges uploaded once a call
    bt = torch.from_numpy(np.asarray(b, np.int64)).to(dev)  # repro: noqa[R001] host numpy edges uploaded once a call
    label, surv, _, converged, rounds = cluster_pairs_device(
        num_nodes, at, bt, max_rounds=max_rounds, device=dev)
    if not converged:
        _warn_truncated(max_rounds)
    return ClusterResult(label=label.cpu().numpy().astype(np.int64),  # repro: noqa[R001] ClusterResult is host numpy
                         survivors=surv.cpu().numpy().astype(np.int64),  # repro: noqa[R001] ClusterResult is host numpy
                         converged=converged, rounds=rounds)


def connected_components(num_nodes: int, a: np.ndarray, b: np.ndarray,
                         max_rounds: int = 64,
                         device: DeviceLike = None) -> np.ndarray:
    """Component label per node (min node id in the component), host arrays
    in and out; truncation at ``max_rounds`` warns."""
    if len(a) == 0:
        return np.arange(num_nodes, dtype=np.int64)
    dev = resolve_device(device)
    at = torch.from_numpy(np.asarray(a, np.int64)).to(dev)  # repro: noqa[R001] host numpy edges uploaded once a call
    bt = torch.from_numpy(np.asarray(b, np.int64)).to(dev)  # repro: noqa[R001] host numpy edges uploaded once a call
    label, converged, _ = _cc_device(at, bt, num_nodes=num_nodes,
                                     max_rounds=max_rounds)
    if not converged:
        _warn_truncated(max_rounds)
    return label.cpu().numpy().astype(np.int64)  # repro: noqa[R001] the labels are host numpy


def connected_components_oracle(num_nodes: int, a: np.ndarray,
                                b: np.ndarray) -> np.ndarray:
    """Union-find ground truth: same contract as ``connected_components``.

    Path-halving find + union that attaches the larger root under the
    smaller, so every root IS the min member id.
    """
    parent = np.arange(num_nodes, dtype=np.int64)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]   # path halving
            x = parent[x]
        return x

    for x, y in zip(np.asarray(a, np.int64), np.asarray(b, np.int64)):
        rx, ry = find(int(x)), find(int(y))
        if rx != ry:
            if rx < ry:
                parent[ry] = rx
            else:
                parent[rx] = ry
    return np.array([find(i) for i in range(num_nodes)], dtype=np.int64)
