"""End-to-end dedup: keys -> HDB -> pairs -> match -> clusters.

Port of the JAX package's ``data/pipeline.py``. ``dedup_corpus`` is the
batch mode; ``DedupPipeline`` the streaming-consistent one, whose
``extend(delta)`` absorbs new records through a persistent
``streaming.BlockStore`` and matches only the new candidate pairs.
``blocker="hdb"`` blocks with HDB, ``blocker="threshold"``
with the paper's THR baseline (``core/baselines.py``); everything after
blocking is shared. The back half runs behind a
``match_backend`` knob: ``"host"`` scores on the host and clusters the
gathered matched pairs; ``"auto"`` is the fused path, where the pair list
stays on the device from the pair engine through the match kernel into
clustering and only labels, survivors and counts come back. The two are
bit-identical. A ``torch.cuda.synchronize()`` closes every stage so the
stage seconds are the stage's own.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
from torch.profiler import record_function

from ..core import baselines
from ..core import blocks as blocks_mod
from ..core import hdb as hdb_mod
from ..core import pairs as pairs_mod
from ..device import DeviceLike, resolve_device, synchronize
from ..kernels.match.ops import packed_host
from ..streaming.delta import DeltaBlocker
from ..streaming.engine import ColumnCache
from ..streaming.store import BlockStore, pack_pair, searchsorted_mask, unpack_pair
from . import components, matcher
from .synthetic import Corpus


@dataclasses.dataclass
class DedupReport:
    num_records: int
    num_candidate_pairs: int
    num_matched_pairs: int
    num_components: int
    num_survivors: int
    blocking_seconds: float
    matching_seconds: float
    partition_seconds: float
    survivors: np.ndarray       # (S,) record ids, one per component
    component_of: np.ndarray    # (N,) component label per record


def dedup_corpus(corpus: Corpus,
                 cfg: hdb_mod.HDBConfig = hdb_mod.HDBConfig(max_block_size=100),
                 match_cfg: matcher.MatcherConfig = matcher.MatcherConfig(),
                 pair_budget: int = 20_000_000,
                 blocker: str = "hdb",
                 verbose: bool = False,
                 match_backend: str = "auto",
                 cc_max_rounds: int = 64,
                 device: DeviceLike = None) -> DedupReport:
    if blocker not in ("hdb", "threshold"):
        raise ValueError(blocker)
    backend = matcher.resolve_match_backend(match_backend)
    dev = resolve_device(device)
    n = corpus.num_records
    columns = {name: blocks_mod.TokenColumn(c.tokens.to(dev), c.mask.to(dev))
               for name, c in corpus.columns.items()}
    t0 = time.perf_counter()
    # record_function ranges name the stages in a profiler trace
    with record_function("dedup.keys"):
        keys, valid = blocks_mod.build_keys(columns, corpus.blocking)
    if blocker == "hdb":
        with record_function("dedup.hdb"):
            result = hdb_mod.hashed_dynamic_blocking(keys, valid, cfg,
                                                     verbose=verbose, device=dev)
    else:
        with record_function("dedup.threshold"):
            result = baselines.threshold_blocking(keys, valid,
                                                  cfg.max_block_size, device=dev)
    with record_function("dedup.build_blocks"):
        blk = pairs_mod.build_blocks(result, device=dev)
    with record_function("dedup.pairs"):
        pset = pairs_mod.dedupe_pairs(blk, budget=pair_budget, device=dev)
        dev_a, dev_b = pset.pair_buffers(dev)
        synchronize(dev)  # repro: noqa[R001] stage boundary for the stage clock
    t1 = time.perf_counter()
    if backend == "host":
        # parity baseline: scores + matched mask land host-side, the
        # matched pairs are gathered in numpy and clustered
        matched = matcher.match_pairs(columns, dev_a, dev_b, match_cfg)
        ma, mb = pset.a[matched], pset.b[matched]
        num_matched = int(matched.sum())
        t2 = time.perf_counter()
        label = components.connected_components(n, ma, mb,
                                                max_rounds=cc_max_rounds,
                                                device=dev)
        survivors = np.unique(label)
    else:
        # fused: the (0, 0)-padded matched buffer flows straight into CC
        with record_function("dedup.match"):
            ca, cb, cnt = matcher.match_compact(columns, dev_a, dev_b,
                                                match_cfg, device=dev)
            synchronize(dev)  # repro: noqa[R001] stage boundary for the stage clock
        t2 = time.perf_counter()
        with record_function("dedup.cluster"):
            label_d, surv_d, _, converged, _ = components.cluster_pairs_device(
                n, ca, cb, max_rounds=cc_max_rounds, device=dev)
        if not converged:
            components._warn_truncated(cc_max_rounds)
        num_matched = int(cnt)  # repro: noqa[R001] DedupReport's matched count is a host int
        label = label_d.cpu().numpy().astype(np.int64)  # repro: noqa[R001] DedupReport is host numpy
        survivors = surv_d.cpu().numpy().astype(np.int64)  # repro: noqa[R001] DedupReport is host numpy
    synchronize(dev)  # repro: noqa[R001] stage boundary for the stage clock
    t3 = time.perf_counter()
    return DedupReport(
        num_records=n,
        num_candidate_pairs=len(pset.a),
        num_matched_pairs=num_matched,
        num_components=len(survivors),
        num_survivors=len(survivors),
        blocking_seconds=t1 - t0,
        matching_seconds=t2 - t1,
        partition_seconds=t3 - t2,
        survivors=survivors,
        component_of=label,
    )


class DedupPipeline:
    """Incremental dedup: persistent blocking state + delta matching.

    ``extend(corpus_delta)`` ingests a record delta through the streaming
    blocker (exact-incremental HDB over the union), matches ONLY the new
    candidate pairs, drops matches whose candidate pair was retracted,
    and re-partitions. The returned ``DedupReport`` describes the whole
    union and equals ``dedup_corpus`` on it (within its pair budget).
    ``match_backend="host"`` scores on the host and clusters with
    ``connected_components``; ``"auto"`` runs the fused match kernel and
    ``cluster_edges``. Everything runs on ``device`` (``None`` means CUDA).

    On the card ``extend`` is slower than ``dedup_corpus`` on the union:
    the blocker's level state and pair ledger are host numpy, so each
    delta pays host work in proportion to the store (PERF.md, the SYN
    stream cell).
    """

    def __init__(self, cfg: hdb_mod.HDBConfig = hdb_mod.HDBConfig(max_block_size=100),
                 match_cfg: matcher.MatcherConfig = matcher.MatcherConfig(),
                 match_backend: str = "auto",
                 cc_max_rounds: int = 64,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.match_cfg = match_cfg
        self.match_backend = matcher.resolve_match_backend(match_backend)
        self.cc_max_rounds = cc_max_rounds
        self.device = resolve_device(device)
        self.store = BlockStore(cfg, device=self.device)
        self.blocker = DeltaBlocker(self.store)
        self.blocking: Optional[Dict[str, blocks_mod.ColumnBlocking]] = None
        self._columns = ColumnCache(self.device)
        # matched pairs as packed a<<32|b, sorted
        self._matched = np.zeros((0,), np.uint64)

    def extend(self, corpus_delta: Corpus) -> DedupReport:
        dev = self.device
        t0 = time.perf_counter()
        if self.blocking is None:
            self.blocking = corpus_delta.blocking
        columns = {name: blocks_mod.TokenColumn(c.tokens.to(dev), c.mask.to(dev))
                   for name, c in corpus_delta.columns.items()}
        self._columns.append({name: (c.tokens, c.mask)
                              for name, c in columns.items()})
        with record_function("dedup.keys"):
            keys, valid = blocks_mod.build_keys(columns, self.blocking)
        # ingest returns host arrays, so its device work is done here
        report = self.blocker.ingest_keys(keys, valid)
        t1 = time.perf_counter()
        a, b, _ = report.pairs_added
        ra, rb = report.pairs_retracted
        if len(ra):
            # blocks dissolved by this delta withdraw their pairs' matches
            pos, hit = searchsorted_mask(self._matched, pack_pair(ra, rb))
            keep = np.ones(len(self._matched), bool)
            keep[pos[hit]] = False
            self._matched = self._matched[keep]
        if len(a):
            cols = self._columns.columns()
            with record_function("dedup.match"):
                if self.match_backend == "host":
                    matched = matcher.match_pairs(cols, a, b, self.match_cfg)
                    new = pack_pair(a[matched], b[matched])
                else:
                    # fused delta match: only the packed matched words return
                    ca, cb, cnt = matcher.match_compact(
                        cols, a, b, self.match_cfg, device=dev)
                    new = packed_host(ca, cb, int(cnt))  # repro: noqa[R001] the matched count sizes the host copy
            self._matched = np.union1d(self._matched, new)
        t2 = time.perf_counter()
        n = self.store.num_records
        ma, mb = unpack_pair(self._matched)
        with record_function("dedup.cluster"):
            if self.match_backend == "host":
                label = components.connected_components(
                    n, ma, mb, max_rounds=self.cc_max_rounds, device=dev)
                survivors = np.unique(label)
            else:
                cres = components.cluster_edges(
                    n, ma, mb, max_rounds=self.cc_max_rounds, device=dev)
                label, survivors = cres.label, cres.survivors
        t3 = time.perf_counter()
        return DedupReport(
            num_records=n,
            num_candidate_pairs=len(self.store.led_pack),
            num_matched_pairs=len(self._matched),
            num_components=len(survivors),
            num_survivors=len(survivors),
            blocking_seconds=t1 - t0,
            matching_seconds=t2 - t1,
            partition_seconds=t3 - t2,
            survivors=survivors,
            component_of=label,
        )


def dedup_quality(report: DedupReport, corpus: Corpus) -> dict:
    """Cluster-level quality vs ground truth entity ids."""
    la, lb = corpus.labeled_pairs()
    same_comp = report.component_of[la] == report.component_of[lb]
    recall = float(same_comp.mean()) if len(la) else 0.0
    rng = np.random.default_rng(0)
    order = np.argsort(report.component_of, kind="stable")
    lab = report.component_of[order]
    starts = np.flatnonzero(np.concatenate([[True], lab[1:] != lab[:-1]]))
    sizes = np.diff(np.concatenate([starts, [len(lab)]]))
    multi = np.flatnonzero(sizes >= 2)
    correct = total = 0
    for ci in multi[:20000]:
        s, m = starts[ci], sizes[ci]
        mem = order[s : s + m]
        if m > 12:
            mem = rng.choice(mem, 12, replace=False)
        ii, jj = np.triu_indices(len(mem), 1)
        correct += int((corpus.entity_id[mem[ii]] == corpus.entity_id[mem[jj]]).sum())
        total += len(ii)
    precision = correct / total if total else 1.0
    return {"pair_recall": recall, "pair_precision": precision,
            "dedup_ratio": report.num_survivors / report.num_records}
