"""The serving smoke: a small scenario through both front ends, for
holding one device's results against another's.

``service_run(device, n_shards)`` drives a ``DedupeService`` under a
stepping clock (ingests, ``refresh_clusters``, probes in both modes, a
shed probe) and returns what it answered; ``engine_run(model, requests)``
serves requests through a ``ServingEngine`` and returns the tokens and
the first decode step's logits; ``greedy_step`` takes one decode step as
the engine takes it, for the encdec family, which the engine cannot
serve; ``differing(a, b)`` names the results in which two runs differ. ``step_clock`` is the deterministic clock the
tests share with the reference service.
"""
from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np
import torch

from ..core import blocks, hdb, u64
from ..device import DeviceLike
from ..streaming.smoke import scenario_key64
from .engine import Request, ServingEngine
from .service import DedupeService, ServiceConfig

SERVICE_CFG = dict(max_block_size=8, max_iterations=5, max_oversize_keys=6,
                   cms_width=1 << 10)


def step_clock(step: float = 1e-3):
    """A clock that advances ``step`` seconds on every read."""
    ticks = itertools.count(1)
    return lambda: next(ticks) * step


def result_arrays(results) -> List:
    """A list of QueryResults as comparable arrays."""
    return [(r.candidates, r.block_sizes, r.n_blocks_hit, r.levels_walked)
            for r in results]


def service_run(device: DeviceLike, n_shards: int = 1, n: int = 150) -> Dict:
    """Two tenants of ``n_shards``-shard stores on ``device``: three
    ingests each, ``refresh_clusters``, probes in both ``include_probe``
    modes, and one already-expired probe."""
    rng = np.random.default_rng(11)
    k64, valid = scenario_key64(rng, n, 6, 16)
    keys, valid = blocks.dedupe_row_keys(u64.from_numpy_u64(k64), torch.from_numpy(valid))
    svc = DedupeService(hdb.HDBConfig(**SERVICE_CFG),
                        ServiceConfig(n_shards=n_shards, probe_slots=8),
                        step_clock(), device=device)
    third = (n * 2 // 3) // 3
    for name, lo in (("a", 0), ("b", n // 4)):
        for off in range(lo, lo + 3 * third, third):
            svc.submit_ingest(name, keys[off:off + third], valid[off:off + third])
    svc.run()
    clusters = {}
    for name in ("a", "b"):
        res = svc.refresh_clusters(name)
        clusters[name] = (res.label, res.survivors, res.converged, res.rounds)
    lo = n * 2 // 3
    for off in range(lo, n, 5):
        svc.submit_probe("a", keys[off:off + 5], valid[off:off + 5],
                         include_probe=bool(off % 2))
    svc.submit_probe("b", keys[lo:lo + 4], valid[lo:lo + 4], deadline_s=-1.0)
    svc.submit_probe("b", keys[lo + 4:], valid[lo + 4:])
    svc.run()
    return {"probes": [(r.uid, r.tenant, r.status, r.latency_s, result_arrays(r.results))
                       for r in svc.probe_responses],
            "ingests": [(r.uid, r.first_rid, r.num_rows, r.latency_s,
                         r.report.pairs_added, r.report.pairs_retracted)
                        for r in svc.ingest_responses],
            "ledger": [svc.tenant(t).store.led_pack for t in ("a", "b")],
            "clusters": clusters, "snapshot": svc.snapshot()}


def engine_run(model, requests, slots: int, max_len: int) -> Dict:
    """``requests`` ((uid, prompt, max_new_tokens) each, eos -1) through a
    ``ServingEngine``: the tokens by uid, the shared pos, the decode steps
    run, and the logits of one decode step of the first prompt tokens
    from fresh caches."""
    first = np.zeros((slots, 1), np.int32)
    for i, (_, prompt, _) in enumerate(requests[:slots]):
        first[i, 0] = prompt[0]
    logits, _ = model.decode_step(torch.from_numpy(first).to(model.device),  # repro: noqa[R001] a check helper's upload
                                  model.init_caches(slots, max_len))
    eng = ServingEngine(model, batch_slots=slots, max_len=max_len)
    for uid, prompt, max_new in requests:
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new, eos_id=-1))
    tokens = {r.uid: r.tokens for r in eng.run()}
    return {"tokens": tokens, "pos": eng.pos, "first_logits": logits.float().cpu()}  # repro: noqa[R001] a check helper's host copy


def greedy(logits: torch.Tensor) -> np.ndarray:
    """The last position's argmax (the first index on ties, as the
    engine's), on the host: (B, 1) int32."""
    return logits[:, -1].argmax(-1, keepdim=True).to(torch.int32).cpu().numpy()  # repro: noqa[R001] sampled tokens to the host scheduler


def greedy_step(model, tokens: np.ndarray, caches: List, batch=None):
    """One greedy decode step as the ``ServingEngine`` takes one: the host
    tokens (B, 1) uploaded, ``decode_step`` with ``batch`` (the encdec
    family reads ``batch["enc_out"]``, which the engine does not pass:
    ROADMAP Queue C, LM fault 8), the argmax downloaded. Returns (the next
    tokens, the logits, the caches)."""
    tok = torch.from_numpy(tokens).to(model.device)  # repro: noqa[R001] the host tokens, uploaded
    logits, caches = model.decode_step(tok, caches, batch)
    return greedy(logits), logits, caches


def lm_requests(vocab: int, n: int, max_new: int, lo: int = 2, hi: int = 33,
                seed: int = 0):
    """``n`` requests of ``lo``..``hi - 1`` random prompt tokens."""
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(1, vocab, rng.integers(lo, hi)).astype(np.int32), max_new)
            for uid in range(n)]


def same(x, y) -> bool:
    """Exact equality of nested lists, tuples, dicts and arrays."""
    if isinstance(x, (list, tuple)):
        return (isinstance(y, (list, tuple)) and len(x) == len(y)
                and all(same(a, b) for a, b in zip(x, y)))
    if isinstance(x, dict):
        return (isinstance(y, dict) and x.keys() == y.keys()
                and all(same(x[k], y[k]) for k in x))
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        return np.array_equal(x, y)
    return x == y


def differing(a: Dict, b: Dict) -> List[str]:
    """Keys of two ``service_run`` results whose values differ."""
    return [k for k in a if not same(a[k], b[k])]
