"""Input construction per architecture: concrete tensors for smoke tests
and training, meta tensors (no allocation) for shape-only callers.

Port of the JAX package's ``launch/specs.py``. The draws are the
reference's: numpy draws from ``rng`` (``default_rng(0)`` per draw when
None), in its order; integers cast to int32, floats (``frames``,
``patches``, ``enc_out``) from ``standard_normal`` cast to the compute
dtype.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig


def _mk(concrete: bool, shape, rng: Optional[np.random.Generator], device,
        high: int) -> torch.Tensor:
    if not concrete:
        return torch.empty(shape, dtype=torch.int32, device="meta")
    rng = rng or np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, high, shape).astype(np.int32)).to(device)  # repro: noqa[R001] the batch's host draws, uploaded


def _mk_float(concrete: bool, shape, rng: Optional[np.random.Generator], device,
              dtype: torch.dtype) -> torch.Tensor:
    if not concrete:
        return torch.empty(shape, dtype=dtype, device="meta")
    rng = rng or np.random.default_rng(0)
    return torch.from_numpy(rng.standard_normal(shape)).to(device, dtype)  # repro: noqa[R001] the batch's host draws, uploaded


def train_batch(cfg: ModelConfig, seq_len: int, batch: int, concrete: bool = False,
                rng: Optional[np.random.Generator] = None,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """``{"tokens", "targets"}``, (batch, seq_len) int32 tensors, on
    ``device`` (None means the card), or on the meta device when not
    ``concrete``. The encdec family adds ``frames`` (batch, seq_len,
    d_model) and decodes ``max(8, seq_len // encoder_seq_ratio)`` tokens;
    the vlm family adds ``patches`` (batch, num_patches, d_model) and has
    ``max(8, seq_len - num_patches)`` text tokens."""
    dev = resolve_device(device) if concrete else None
    v, d = cfg.vocab_size, cfg.d_model
    out = {}
    if cfg.family == "encdec":
        out["frames"] = _mk_float(concrete, (batch, seq_len, d), rng, dev, cfg.cdtype)
        seq_len = max(8, seq_len // cfg.encoder_seq_ratio)
    elif cfg.family == "vlm":
        out["patches"] = _mk_float(concrete, (batch, cfg.num_patches, d), rng, dev,
                                   cfg.cdtype)
        seq_len = max(8, seq_len - cfg.num_patches)
    out["tokens"] = _mk(concrete, (batch, seq_len), rng, dev, v)
    out["targets"] = _mk(concrete, (batch, seq_len), rng, dev, v)
    return out


def decode_inputs(model, seq_len: int, batch: int, concrete: bool = False,
                  rng: Optional[np.random.Generator] = None):
    """(token, caches, extras) for one decode step with a full cache: a
    (batch, 1) token, ``model``'s caches of ``seq_len`` rows with every
    ``pos`` at ``seq_len - 1`` (a recurrent cache has none), and for the
    encdec family ``extras["enc_out"]`` (batch, seq_len, d_model). On the
    model's device, or the meta device when not ``concrete``."""
    cfg = model.cfg
    dev = model.device if concrete else torch.device("meta")
    token = _mk(concrete, (batch, 1), rng, dev, cfg.vocab_size)
    caches = model.init_caches(batch, seq_len, dev)
    if concrete:
        _set_pos(caches, seq_len - 1)
    extras = {}
    if cfg.family == "encdec":
        extras["enc_out"] = _mk_float(concrete, (batch, seq_len, cfg.d_model), rng, dev,
                                      cfg.cdtype)
    return token, caches, extras


def _set_pos(caches: List[Dict], pos: int) -> List[Dict]:
    """Every cache's ``pos`` set to ``pos``, in place."""
    for c in caches:
        if "pos" in c:
            c["pos"] = pos
    return caches
