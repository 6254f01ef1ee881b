"""Count-Min Sketch (paper §3.1 "Rough Over-sized Block Detection").

The CMS half of the JAX package's ``core/sketches.py``. The build is the
cms kernel (``kernels/cms``) on a CUDA tensor and its plain per-row
``index_add_`` on a CPU tensor; the bucket indices come from
``hashing.hash_u64`` (the hash64 mix kernel on the card). The CMS never
undercounts, so no truly over-sized block is reported right-sized.
"""
from __future__ import annotations

import dataclasses

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
