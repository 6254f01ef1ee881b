"""Count-Min Sketch (paper §3.1 "Rough Over-sized Block Detection").

The CMS half of the JAX package's ``core/sketches.py``. ``cms_build`` is
a plain ``index_add_`` here, as the JAX main path is a plain jnp scatter;
the CMS never undercounts, so no truly over-sized block is reported
right-sized.
"""
from __future__ import annotations

import dataclasses

import torch

from . import hashing


@dataclasses.dataclass(frozen=True)
class CMSConfig:
    depth: int = 4
    width: int = 1 << 20  # power of two; index = hash & (width-1)

    def __post_init__(self):
        if self.width & (self.width - 1):
            raise ValueError("width must be a power of 2")


def cms_indices(cfg: CMSConfig, key: torch.Tensor) -> torch.Tensor:
    """(depth, *key_shape) int64 bucket indices for a u64 key array."""
    return torch.stack([hashing.hash_u64(key, seed=0xC0DE + j) & (cfg.width - 1)
                        for j in range(cfg.depth)], dim=0)


def cms_build(cfg: CMSConfig, key: torch.Tensor, mask: torch.Tensor
              ) -> torch.Tensor:
    """(depth, width) int32 CMS from a flat array of keys."""
    idx = cms_indices(cfg, key)
    upd = mask.to(torch.int32)
    sketch = torch.zeros((cfg.depth, cfg.width), dtype=torch.int32,
                         device=key.device)
    for j in range(cfg.depth):
        sketch[j].index_add_(0, idx[j], upd)
    return sketch


def cms_query(cfg: CMSConfig, sketch: torch.Tensor, key: torch.Tensor
              ) -> torch.Tensor:
    """Approximate count per key: min over depth rows. Never undercounts."""
    idx = cms_indices(cfg, key)
    est = sketch[0][idx[0]]
    for j in range(1, cfg.depth):
        est = torch.minimum(est, sketch[j][idx[j]])
    return est
