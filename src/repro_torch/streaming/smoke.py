"""The streaming smoke: a small corpus ingested in parts through every
streaming entry point, for holding one device's results against another's.

``smoke_run(device)`` ingests the 150-entity smoke corpus in three parts
through ``StreamingEngine`` (fused matcher, one query) and through
``DedupPipeline.extend`` with both match back ends, and returns what each
produced; ``sharded_run(device, n_shards)`` ingests it through
``StreamingEngine(n_shards=n_shards)``; ``differing(a, b)`` names the
results in which two runs differ.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ..core import hdb
from ..data import matcher, pipeline, synthetic
from .engine import RecordBatch, StreamingEngine


def _smoke_engine(device, n_shards: int = 1):
    """The smoke corpus ingested in three parts through StreamingEngine
    (fused matcher), then one query. Returns (corpus, cfg, parts, engine,
    ingest results, probe results)."""
    corpus = synthetic.generate(synthetic.SyntheticSpec(num_entities=150, seed=7),
                                device=device)
    cfg = hdb.HDBConfig(max_block_size=50, max_iterations=6, cms_width=1 << 12)
    parts = np.array_split(np.arange(corpus.num_records), 3)
    eng = StreamingEngine(corpus.blocking, cfg, matcher_cfg=matcher.MatcherConfig(),
                          match_backend="auto", n_shards=n_shards, device=device)
    for part in parts:
        eng.submit_ingest(RecordBatch.from_corpus(corpus, part))
    eng.submit_query(RecordBatch.from_corpus(corpus, np.array([0, 5])))
    ingests, probes = eng.run()
    return corpus, cfg, parts, eng, ingests, probes


def sharded_run(device, n_shards: int) -> Dict[str, list]:
    """{result name: values} of the smoke corpus through
    ``StreamingEngine(n_shards=n_shards)``: every ingest report (without
    its seconds), the ledger, the candidate pairs, the matched pairs and
    the probe results."""
    _, _, _, eng, ingests, probes = _smoke_engine(device, n_shards)
    cand = eng.store.candidate_pairs()
    return {"reports": [[r.report.num_records, *r.report.pairs_added,
                         *r.report.pairs_retracted,
                         [list(dataclasses.astuple(lv)) for lv in r.report.levels]]
                        for r in ingests],
            "ledger": [eng.store.led_pack, eng.store.led_src],
            "candidate pairs": [cand.a, cand.b, cand.src_size, cand.total_slots],
            "matched pairs": [r.matched_pairs for r in ingests],
            "probes": [[p.result.candidates, p.result.block_sizes] for p in probes]}


def smoke_run(device) -> Dict[str, list]:
    """{result name: values} of the smoke corpus ingested in three parts:
    the engine's ledger, matched pairs and probe results, and each extend
    back end's (candidate pairs, matched pairs, component_of) per part."""
    corpus, cfg, parts, eng, ingests, probes = _smoke_engine(device)
    out = {"ledger": [eng.store.led_pack, eng.store.led_src],
           "matched pairs": [r.matched_pairs for r in ingests],
           "probes": [[p.result.candidates, p.result.block_sizes] for p in probes]}
    for backend in ("auto", "host"):
        pipe = pipeline.DedupPipeline(cfg, match_backend=backend, device=device)
        reps = [pipe.extend(synthetic.corpus_slice(corpus, part)) for part in parts]
        out[f"extend {backend}"] = [[r.num_candidate_pairs, r.num_matched_pairs,
                                     r.component_of] for r in reps]
    return out


def same_values(x, y) -> bool:
    """Nested lists of arrays, scalars or None, equal element for element."""
    if isinstance(x, list):
        return len(x) == len(y) and all(same_values(a, b) for a, b in zip(x, y))
    if x is None or y is None:
        return x is y
    return np.array_equal(np.asarray(x), np.asarray(y))


def differing(a: Dict[str, list], b: Dict[str, list]) -> List[str]:
    """The result names of two smoke runs whose values differ."""
    return [k for k in a if k not in b or not same_values(a[k], b[k])]
