"""Pairwise matching — stage 3 of the 4-stage dedup pipeline (paper §1).

Port of the JAX package's ``data/matcher.py``: a weighted token-overlap
scorer over the padded token columns used for blocking. ``match_pairs``
is the score-on-host parity baseline; ``match_compact`` is the fused
path (score + threshold + compaction; the CUDA match kernel on the card,
its plain version on the CPU) whose matched pairs stay on the device.
Both follow one float32 op order (``kernels/match``), so they agree bit
for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..core import u64
from ..core.blocks import TokenColumn
from ..device import DeviceLike, resolve_device
from ..kernels.match import ops as match_ops

# "auto" is the fused path; "host" is the score-on-host baseline. The
# reference's "jnp" and "pallas" name JAX back ends and are refused here.
MATCH_BACKENDS = ("auto", "host")


def resolve_match_backend(backend: str) -> str:
    if backend not in MATCH_BACKENDS:
        raise ValueError(
            f"match_backend {backend!r} not in {MATCH_BACKENDS}")
    return backend


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    threshold: float = 0.65
    # per-column weights; text columns dominate, scalar agreement helps
    weights: tuple = (("name", 0.4), ("description", 0.3), ("brand", 0.1),
                      ("category", 0.05), ("model_no", 0.15))


def _schema(columns: Dict[str, TokenColumn], cfg: MatcherConfig):
    """Config-ordered (tokens, masks, weights) for the columns present."""
    names = [n for n, _ in cfg.weights if n in columns]
    tokens = [columns[n].tokens for n in names]
    masks = [columns[n].mask for n in names]
    weights = tuple(w for n, w in cfg.weights if n in columns)
    return tokens, masks, weights


def _as_index(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(x, np.int64)).to(device)


def score_pairs(columns: Dict[str, TokenColumn], a, b,
                cfg: MatcherConfig = MatcherConfig(),
                batch: int = 65536) -> np.ndarray:
    """Similarity in [0, 1] (float32) for each candidate pair.

    ``a``/``b`` may be host numpy or tensors; scoring runs on the
    columns' device in batches, and only the scores come back.
    """
    tokens, masks, weights = _schema(columns, cfg)
    dev = tokens[0].device
    a = _as_index(a, dev)
    b = _as_index(b, dev)
    out = np.empty(a.shape[0], np.float32)
    for off in range(0, a.shape[0], batch):
        sl = slice(off, off + batch)
        got = match_ops.score_lanes(tokens, masks, weights, a[sl], b[sl])
        out[sl] = got.cpu().numpy()
    return out


def match_pairs(columns, a, b, cfg: MatcherConfig = MatcherConfig()) -> np.ndarray:
    """Boolean match decision per candidate pair (host parity baseline);
    compares in float32, as the device paths do."""
    return score_pairs(columns, a, b, cfg) >= np.float32(cfg.threshold)


def match_compact(columns: Dict[str, TokenColumn], a, b,
                  cfg: MatcherConfig = MatcherConfig(), *,
                  backend: str = "auto", device: DeviceLike = None):
    """Fused match: score + threshold + compaction, no host hop.

    Returns device ``(ca, cb, count)``: the first ``count`` lanes of the
    int32 ``ca``/``cb`` are the matched pairs in candidate order and the
    tail is (0, 0) padding, which ``cluster_pairs_device`` reads as
    no-op edges. ``count`` is a 0-dim int32 tensor.
    """
    if resolve_match_backend(backend) == "host":
        raise ValueError("match_compact is the device path; use "
                         "match_pairs for the host baseline")
    dev = resolve_device(device)
    tokens, masks, weights = _schema(columns, cfg)
    col_off = np.concatenate([[0], np.cumsum([t.shape[1] for t in tokens])])
    tok = u64.to_int32_bits(torch.cat(tokens, dim=1).to(dev)).contiguous()
    msk = torch.cat(masks, dim=1).to(device=dev, dtype=torch.uint8).contiguous()
    return match_ops.fused_match_pairs(
        tok, msk, [int(c) for c in col_off], weights, _as_index(a, dev),
        _as_index(b, dev), threshold=cfg.threshold)
