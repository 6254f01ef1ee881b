"""Count-Min Sketch (paper §3.1 "Rough Over-sized Block Detection").

The CMS half of the JAX package's ``core/sketches.py``. The build is the
cms kernel (``kernels/cms``) on a CUDA tensor and its plain per-row
``index_add_`` on a CPU tensor; the bucket indices come from
``hashing.hash_u64`` (the hash64 mix kernel on the card). The CMS never
undercounts, so no truly over-sized block is reported right-sized.

The sketch is linear: the sketch of a union is the sum of its parts'
sketches, and removing entries subtracts theirs (``cms_fold`` /
``cms_subtract``). The streaming store keeps one sketch a level current
that way; ``np_cms_indices`` gives it the bucket indices on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.cms import ops as cms_ops
from . import hashing


@dataclasses.dataclass(frozen=True)
class CMSConfig:
    depth: int = 4
    width: int = 1 << 20  # power of two; index = hash & (width-1)

    def __post_init__(self):
        if self.width & (self.width - 1):
            raise ValueError("width must be a power of 2")


def cms_indices(cfg: CMSConfig, key: torch.Tensor) -> torch.Tensor:
    """(depth, *key_shape) int32 bucket indices for a u64 key array."""
    return torch.stack([(hashing.hash_u64(key, seed=0xC0DE + j)
                         & (cfg.width - 1)).to(torch.int32)
                        for j in range(cfg.depth)], dim=0)


def cms_build_indices(cfg: CMSConfig, idx: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
    """(depth, width) int32 CMS from (depth, n) bucket indices + (n,) mask."""
    return cms_ops.cms_update(idx, mask.contiguous(), cfg.width)


def cms_query_indices(sketch: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Approximate count per entry of (depth, ...) bucket indices."""
    est = sketch[0][idx[0]]
    for j in range(1, sketch.shape[0]):
        est = torch.minimum(est, sketch[j][idx[j]])
    return est


def cms_build(cfg: CMSConfig, key: torch.Tensor, mask: torch.Tensor
              ) -> torch.Tensor:
    """(depth, width) int32 CMS from a flat array of keys."""
    return cms_build_indices(cfg, cms_indices(cfg, key), mask)


def cms_query(cfg: CMSConfig, sketch: torch.Tensor, key: torch.Tensor
              ) -> torch.Tensor:
    """Approximate count per key: min over depth rows. Never undercounts."""
    return cms_query_indices(sketch, cms_indices(cfg, key))


def cms_fold(global_sketch, delta_sketch):
    """Fold a delta's sketch into a persistent one.

    The sketch of (corpus + delta) is exactly ``cms(corpus) + cms(delta)``:
    no rebuild over the corpus and no error beyond the sketch's own.
    Works on tensors and numpy arrays alike.
    """
    return global_sketch + delta_sketch


# merging two sketches is the same elementwise add
cms_merge = cms_fold


def cms_subtract(global_sketch, delta_sketch):
    """Remove entries folded in earlier: exact, since each was added with
    the same +1 updates, so every bucket stays a true non-negative sum."""
    return global_sketch - delta_sketch


def cms_decay(sketch, shift: int = 1):
    """Halve every bucket ``shift`` times (integer right shift).

    Ages out stale mass in a long-running sketch; after a decay the
    never-undercounts guarantee no longer holds for surviving entries.
    """
    return sketch >> shift


def np_cms_indices(cfg: CMSConfig, key64) -> np.ndarray:
    """Host mirror of ``cms_indices`` on numpy uint64 keys: (depth,
    *key_shape) int32, the same seeds and width mask."""
    key64 = np.asarray(key64, np.uint64)
    idx = np.empty((cfg.depth,) + key64.shape, np.int32)
    for j in range(cfg.depth):
        h = hashing.np_hash_u64_vec(key64, seed=0xC0DE + j)
        idx[j] = (h & np.uint64(cfg.width - 1)).astype(np.int32)
    return idx
