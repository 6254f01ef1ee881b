"""Slot-scheduled front-end for the streaming blocker.

Port of the JAX package's ``streaming/engine.py``: submissions (ingest
record batches, query probes) queue on the host; each ``step()`` drains at
most one ingest micro-batch and one query batch under their slot budgets
(``serving.scheduler``). Keys are built on the engine's device (the
minhash and mix64 kernels on the card). Optionally each ingest's new
candidate pairs are scored with the matcher against the retained columns
(``ColumnCache``), host-side scores or the fused match kernel.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..core import blocks as blocks_mod
from ..core import hdb as hdb_mod
from ..data import matcher
from ..device import DeviceLike, resolve_device
from ..kernels.match.ops import packed_host
from ..serving.scheduler import collate_fifo, drain
from .delta import DeltaBlocker, IngestReport, QueryResult
from .shard import ShardedBlockStore
from .store import BlockStore


@dataclasses.dataclass
class RecordBatch:
    """A micro-batch of records in the corpus column format.

    ``columns`` maps column name -> (tokens (n, T) uint32 values, mask
    (n, T) bool), host numpy; widths and the blocking spec must match
    the engine's schema across batches.
    """

    columns: Dict[str, tuple]
    num_records: int

    @staticmethod
    def from_corpus(corpus, idx: np.ndarray) -> "RecordBatch":
        idx = np.asarray(idx)
        cols = {name: (col.tokens.cpu().numpy()[idx], col.mask.cpu().numpy()[idx])  # repro: noqa[R001] RecordBatch is host numpy
                for name, col in corpus.columns.items()}
        return RecordBatch(columns=cols, num_records=len(idx))


_NP_DTYPE = {torch.int64: np.int64, torch.bool: bool}


def _on(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A host array or a tensor as a tensor of ``dtype`` on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, _NP_DTYPE[dtype]))
    return x.to(device=device, dtype=dtype)  # repro: noqa[R001] a host batch uploaded once a part


class ColumnCache:
    """Device-resident token columns with amortized-growth appends.

    The matcher needs every ingested record's columns on the device to
    score new candidate pairs. The cache keeps power-of-two-capacity
    device buffers: within capacity an append copies only the delta rows
    into a slice of the buffer; on overflow the capacity doubles and the
    buffer is rebuilt once, on the device. Rows past ``num_records``
    carry ``mask=False`` and no real pair indexes them.
    """

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.num_records = 0
        self._cap = 0
        self._dev: Dict[str, blocks_mod.TokenColumn] = {}

    def append(self, columns: Dict[str, tuple]) -> None:
        """Append rows given as (tokens, mask) tensors or numpy arrays."""
        cols = {name: (_on(t, torch.int64, self.device), _on(m, torch.bool, self.device))
                for name, (t, m) in columns.items()}
        n = next(iter(cols.values()))[0].shape[0]
        start, new_len = self.num_records, self.num_records + n
        if new_len > self._cap:
            cap = 1024
            while cap < new_len:
                cap *= 2
            for name, (t, m) in cols.items():
                bt = torch.zeros((cap, t.shape[1]), dtype=torch.int64,
                                 device=self.device)
                bm = torch.zeros((cap, m.shape[1]), dtype=torch.bool,
                                 device=self.device)
                if name in self._dev:  # the one rebuild: old rows move over
                    bt[:start].copy_(self._dev[name].tokens[:start])
                    bm[:start].copy_(self._dev[name].mask[:start])
                self._dev[name] = blocks_mod.TokenColumn(bt, bm)
            self._cap = cap
        for name, (t, m) in cols.items():
            col = self._dev[name]
            col.tokens[start:new_len].copy_(t)
            col.mask[start:new_len].copy_(m)
        self.num_records = new_len

    def columns(self) -> Dict[str, blocks_mod.TokenColumn]:
        return dict(self._dev)


@dataclasses.dataclass
class IngestResult:
    uids: List[int]     # every submission coalesced into this micro-batch
    first_rid: int
    report: IngestReport
    match_scores: Optional[np.ndarray] = None   # scores of pairs_added
    # fused match_backend only: packed a<<32|b words of the MATCHED new
    # pairs (match_scores stays None)
    matched_pairs: Optional[np.ndarray] = None


@dataclasses.dataclass
class ProbeResult:
    uid: int
    result: QueryResult


class StreamingEngine:
    """Micro-batch ingest + probe queries over one BlockStore.

    ``device`` holds the store and runs every device step (``None`` means
    CUDA and raises without a card). ``match_backend`` ``"host"`` scores
    new pairs and returns the scores; ``"auto"`` runs the fused match and
    returns only the matched pairs. ``n_shards > 1`` keeps the state in
    a meshless ``ShardedBlockStore``.
    """

    def __init__(self, blocking: Dict[str, blocks_mod.ColumnBlocking],
                 cfg: hdb_mod.HDBConfig = hdb_mod.HDBConfig(),
                 ingest_slots: int = 256, query_slots: int = 64,
                 matcher_cfg=None, sort_backend: str = "auto",
                 n_shards: int = 1, match_backend: str = "host",
                 device: DeviceLike = None):
        self.blocking = blocking
        self.match_backend = matcher.resolve_match_backend(match_backend)
        self.device = resolve_device(device)
        if n_shards > 1:
            self.store = ShardedBlockStore(cfg, n_shards=n_shards,
                                           device=self.device)
        else:
            self.store = BlockStore(cfg, device=self.device)
        self.blocker = DeltaBlocker(self.store, sort_backend=sort_backend)
        self.ingest_slots = ingest_slots
        self.query_slots = query_slots
        self.matcher_cfg = matcher_cfg
        self._uid = 0
        self._ingest_queue: List[tuple] = []   # (uid, RecordBatch)
        self._query_queue: List[tuple] = []    # (uid, RecordBatch)
        self.ingest_results: List[IngestResult] = []
        self.probe_results: List[ProbeResult] = []
        # retained columns for matcher scoring of new pairs
        self.column_cache = ColumnCache(self.device)

    # ------------------------------------------------------------------

    def submit_ingest(self, batch: RecordBatch) -> int:
        self._uid += 1
        self._ingest_queue.append((self._uid, batch))
        return self._uid

    def submit_query(self, batch: RecordBatch) -> int:
        self._uid += 1
        self._query_queue.append((self._uid, batch))
        return self._uid

    @property
    def busy(self) -> bool:
        return bool(self._ingest_queue) or bool(self._query_queue)

    # ------------------------------------------------------------------

    def _build_keys(self, batch: RecordBatch):
        with record_function("dedup.keys"):
            cols = {name: blocks_mod.TokenColumn(_on(t, torch.int64, self.device),
                                                 _on(m, torch.bool, self.device))
                    for name, (t, m) in batch.columns.items()}
            return blocks_mod.build_keys(cols, self.blocking)

    def _pad_batch(self, batches: List[tuple], slots: int) -> List[tuple]:
        """Coalesce queued (uid, batch) entries up to one slot budget
        (skip-scan collation, ``serving.scheduler.collate_fifo``)."""
        return collate_fifo(batches, slots,
                            size_fn=lambda e: e[1].num_records,
                            group_fn=lambda e: e[0])

    @staticmethod
    def _merge_columns(taken: List[tuple]) -> RecordBatch:
        merged = {name: (np.concatenate([b.columns[name][0] for _, b in taken]),
                         np.concatenate([b.columns[name][1] for _, b in taken]))
                  for name in taken[0][1].columns}
        return RecordBatch(merged, sum(b.num_records for _, b in taken))

    def step(self) -> None:
        """Process one ingest micro-batch and one query batch, if queued."""
        ingest = self._pad_batch(self._ingest_queue, self.ingest_slots)
        if ingest:
            uids = [u for u, _ in ingest]
            batch = self._merge_columns(ingest)
            if self.matcher_cfg is not None:
                self.column_cache.append(batch.columns)
            first_rid = self.store.num_records
            keys, valid = self._build_keys(batch)
            report = self.blocker.ingest_keys(keys, valid)
            scores = matched = None
            if self.matcher_cfg is not None and report.num_pairs_added:
                if self.match_backend == "host":
                    scores = self._score_new_pairs(report)
                else:
                    matched = self._match_new_pairs(report)
            self.ingest_results.append(IngestResult(
                uids=uids, first_rid=first_rid, report=report,
                match_scores=scores, matched_pairs=matched))
        queries = self._pad_batch(self._query_queue, self.query_slots)
        if queries:
            batch = self._merge_columns(queries)
            keys, valid = self._build_keys(batch)
            results = self.blocker.query_keys(keys, valid)
            off = 0
            for uid, qb in queries:
                for r in results[off:off + qb.num_records]:
                    self.probe_results.append(ProbeResult(uid=uid, result=r))
                off += qb.num_records

    @property
    def queue_depth(self) -> int:
        """Submissions still queued across both lanes."""
        return len(self._ingest_queue) + len(self._query_queue)

    def run(self, max_steps: int = 10_000):
        """Drain the queues; warn if ``max_steps`` truncates the drain."""
        drain(self, max_steps)
        if self.busy:
            warnings.warn(
                f"StreamingEngine.run stopped at max_steps={max_steps} with "
                f"{self.queue_depth} submissions still queued; call run() "
                "again to finish the drain", RuntimeWarning, stacklevel=2)
        return self.ingest_results, self.probe_results

    # ------------------------------------------------------------------

    def _score_new_pairs(self, report: IngestReport) -> np.ndarray:
        """Matcher scores of this ingest's new candidate pairs."""
        a, b, _ = report.pairs_added
        return matcher.score_pairs(self.column_cache.columns(), a, b,
                                   self.matcher_cfg)

    def _match_new_pairs(self, report: IngestReport) -> np.ndarray:
        """Fused match over this ingest's new pairs: packed ``a<<32|b``
        words of the matched subset (the scores stay on the device)."""
        a, b, _ = report.pairs_added
        with record_function("dedup.match"):
            ca, cb, cnt = matcher.match_compact(
                self.column_cache.columns(), a, b, self.matcher_cfg,
                device=self.device)
            return packed_host(ca, cb, int(cnt))  # repro: noqa[R001] the matched count sizes the host copy
