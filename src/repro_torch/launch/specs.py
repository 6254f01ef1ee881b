"""Input construction per architecture: concrete tensors for smoke tests
and training, meta tensors (no allocation) for shape-only callers.

Port of the JAX package's ``launch/specs.py`` for the decoder-only
families (``decode_inputs`` and the enc-dec and VLM batches wait for
ROADMAP A10b-4). The integers are the reference's: numpy draws from ``rng``
(``default_rng(0)`` per draw when None), cast to int32.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig


def _mk(concrete: bool, shape, rng: Optional[np.random.Generator], device,
        high: int) -> torch.Tensor:
    if not concrete:
        return torch.empty(shape, dtype=torch.int32, device="meta")
    rng = rng or np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, high, shape).astype(np.int32)).to(device)


def train_batch(cfg: ModelConfig, seq_len: int, batch: int, concrete: bool = False,
                rng: Optional[np.random.Generator] = None,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """``{"tokens", "targets"}``: (batch, seq_len) int32 tensors on
    ``device`` (None means the card), or on the meta device when not
    ``concrete``."""
    if cfg.family in ("encdec", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} batch is not ported; the port builds "
            "the decoder-only families' (ROADMAP A10b-4)")
    dev = resolve_device(device) if concrete else None
    v = cfg.vocab_size
    return {"tokens": _mk(concrete, (batch, seq_len), rng, dev, v),
            "targets": _mk(concrete, (batch, seq_len), rng, dev, v)}
