"""Deterministic, shardable batch loader feeding LM training.

Port of the JAX package's ``data/loader.py``: the same numpy, so the
same seeded permutation, EOS packing and ``batch(step, dp_rank,
dp_size)`` give the reference's tokens exactly; batches become int32
tensors on the loader's device. Fault tolerance by construction:
``batch(step)`` is a pure function of (corpus, survivors, step, rank),
so restarts resume mid-stream with no loader state in the checkpoint
beyond the step counter, and elastic re-sharding (another DP size) only
changes the rank slicing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .synthetic import Corpus


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    batch_size: int      # GLOBAL batch
    seq_len: int
    vocab_size: int
    eos_id: int = 0
    seed: int = 1234


class TokenStreamLoader:
    """Packs (deduplicated) records into LM batches.

    Record token hashes map into the model vocab by modulo; records are
    shuffled once (seeded) and concatenated with EOS separators into a
    ring buffer token stream. ``device`` None means the card.
    """

    def __init__(self, corpus: Corpus, cfg: LoaderConfig,
                 survivors: Optional[np.ndarray] = None, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        keep = survivors if survivors is not None else np.arange(corpus.num_records)
        rng = np.random.default_rng(cfg.seed)
        order = rng.permutation(keep)
        chunks = []
        for name in sorted(corpus.columns):
            col = corpus.columns[name]
            toks = col.tokens.cpu().numpy()[order]  # repro: noqa[R001] the corpus to the host at set-up
            mask = col.mask.cpu().numpy()[order]  # repro: noqa[R001] the corpus to the host at set-up
            ids = (toks.astype(np.int64) % (cfg.vocab_size - 2)) + 2
            ids = np.where(mask, ids, -1)
            chunks.append(ids)
        flat = np.concatenate([c.reshape(len(order), -1) for c in chunks], axis=1)
        docs = []
        for row in flat:
            t = row[row >= 0]
            docs.append(np.concatenate([t, [cfg.eos_id]]))
        self.stream = np.concatenate(docs).astype(np.int32)
        if len(self.stream) < cfg.seq_len + 1:
            reps = int(np.ceil((cfg.seq_len + 1) / len(self.stream)))
            self.stream = np.tile(self.stream, reps + 1)

    @property
    def tokens_per_batch(self) -> int:
        return self.cfg.batch_size * self.cfg.seq_len

    def batch(self, step: int, dp_rank: int = 0, dp_size: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(inputs, targets) for ``step``, restricted to this DP rank's rows."""
        cfg = self.cfg
        if cfg.batch_size % dp_size:
            raise ValueError(f"batch {cfg.batch_size} does not split over "
                             f"{dp_size} data-parallel ranks")
        rows_per_rank = cfg.batch_size // dp_size
        n = len(self.stream)
        out_in = np.empty((rows_per_rank, cfg.seq_len), np.int32)
        out_tg = np.empty((rows_per_rank, cfg.seq_len), np.int32)
        for r in range(rows_per_rank):
            row = dp_rank * rows_per_rank + r
            start = (step * self.tokens_per_batch + row * cfg.seq_len) % (n - cfg.seq_len - 1)
            seg = self.stream[start : start + cfg.seq_len + 1]
            out_in[r] = seg[:-1]
            out_tg[r] = seg[1:]
        return (torch.from_numpy(out_in).to(self.device),  # repro: noqa[R001] a host batch, uploaded a step
                torch.from_numpy(out_tg).to(self.device))  # repro: noqa[R001] a host batch, uploaded a step
