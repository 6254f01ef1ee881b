"""Blocking quality metrics (paper §5.2): PQ, PC, pair counts.

Port of the JAX package's ``data/metrics.py``. The blocks and their
distinct pairs come from the port's pair engine on the caller's device;
PQ is the share of those pairs that are true duplicates
(``Corpus.is_duplicate``), PC the share of labelled duplicate pairs that
share an accepted block (``pairs.pair_covered``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core import pairs as pairs_mod
from ..core.hdb import BlockingResult
from ..device import DeviceLike, resolve_device
from .synthetic import Corpus


@dataclasses.dataclass
class BlockingMetrics:
    pq: float                # pair quality (precision analog)
    pc: float                # pair completeness (recall analog)
    distinct_pairs: int      # |P| (exact or budget-truncated)
    pair_slots: int          # sum C(n,2) before cross-block dedupe
    exact_pairs: bool
    num_blocks: int
    largest_block: int

    def row(self, name: str) -> str:
        return (f"{name},{self.pq:.6g},{self.pc:.6g},{self.distinct_pairs},"
                f"{self.pair_slots},{self.num_blocks},{self.largest_block}")


def evaluate(result: BlockingResult, corpus: Corpus,
             labeled: Optional[tuple] = None,
             pair_budget: int = 30_000_000,
             device: DeviceLike = None) -> BlockingMetrics:
    """PQ over distinct produced pairs (vs ground truth), PC over labels."""
    dev = resolve_device(device)
    blocks = pairs_mod.build_blocks(result, device=dev)
    pset = pairs_mod.dedupe_pairs(blocks, budget=pair_budget, device=dev)
    pq = float(np.mean(corpus.is_duplicate(pset.a, pset.b))) if len(pset.a) else 0.0
    if labeled is None:
        labeled = corpus.labeled_pairs()
    la, lb = labeled
    pc = (float(np.mean(pairs_mod.pair_covered(result, la, lb, device=dev)))
          if len(la) else 0.0)
    return BlockingMetrics(
        pq=pq, pc=pc,
        distinct_pairs=len(pset.a),
        pair_slots=pset.total_slots,
        exact_pairs=pset.exact,
        num_blocks=blocks.num_blocks,
        largest_block=int(blocks.size.max()) if blocks.num_blocks else 0,
    )
