"""End-to-end batch dedup: keys -> HDB -> pairs -> match -> clusters.

Port of ``dedup_corpus`` from the JAX package's ``data/pipeline.py``
(batch mode). ``blocker="hdb"`` blocks with HDB, ``blocker="threshold"``
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

import numpy as np
from torch.profiler import record_function

from ..core import baselines
from ..core import blocks as blocks_mod
from ..core import hdb as hdb_mod
from ..core import pairs as pairs_mod
from ..device import DeviceLike, resolve_device, synchronize
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
        synchronize(dev)
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
            synchronize(dev)
        t2 = time.perf_counter()
        with record_function("dedup.cluster"):
            label_d, surv_d, _, converged, _ = components.cluster_pairs_device(
                n, ca, cb, max_rounds=cc_max_rounds, device=dev)
        if not converged:
            components._warn_truncated(cc_max_rounds)
        num_matched = int(cnt)
        label = label_d.cpu().numpy().astype(np.int64)
        survivors = surv_d.cpu().numpy().astype(np.int64)
    synchronize(dev)
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
