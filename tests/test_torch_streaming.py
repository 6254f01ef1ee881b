"""Port parity: streaming ingest (BlockStore, DeltaBlocker, StreamingEngine,
DedupPipeline.extend) and the modules it brings (sketch folding,
survivor dedupe, cluster_edges, corpus_slice, the slot scheduler).

The same numpy inputs, made from fixed seeds, go through the JAX package
(``repro.streaming``, Pallas in interpret mode where it reaches a kernel)
and the port on the CPU (``device="cpu"``, the kernels' plain versions).
Tolerance: exact equality of every pair, provenance, report count, label,
score and query result.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import blocks as jblocks  # noqa: E402
from repro.core import hashing as jhashing  # noqa: E402
from repro.core import hdb as jhdb  # noqa: E402
from repro.core import sketches as jsketches  # noqa: E402
from repro.data import components as jcomp  # noqa: E402
from repro.data import matcher as jmatcher  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.streaming import BlockStore as JBlockStore  # noqa: E402
from repro.streaming import DeltaBlocker as JDeltaBlocker  # noqa: E402
from repro.streaming import RecordBatch as JRecordBatch  # noqa: E402
from repro.streaming import StreamingEngine as JStreamingEngine  # noqa: E402
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core import blocks, hashing, hdb, pairs, sketches, u64  # noqa: E402
from repro_torch.data import components, matcher, pipeline, synthetic  # noqa: E402
from repro_torch.serving import scheduler  # noqa: E402
from repro_torch.streaming import (BlockStore, DeltaBlocker, RecordBatch,  # noqa: E402
                                   ShardedBlockStore, StreamingEngine)
from repro_torch.streaming.store import LevelKeys, pack_key64  # noqa: E402


def _cfg(max_block):
    return dict(max_block_size=max_block, max_iterations=5,
                max_oversize_keys=6, cms_width=1 << 10)


def _random_keys(rng, n, k, card, pvalid=0.85):
    """Low-cardinality key matrix (the JAX streaming tests' layout): shared,
    over-sized and duplicate blocks and intersections all occur. Returns
    the JAX (n, k, 2) limbs, the port's (n, k) uint64 keys and valid."""
    k64 = (rng.integers(0, card, (n, k)).astype(np.uint64)
           * np.uint64(0x9E3779B97F4A7C15))
    valid = rng.random((n, k)) < pvalid
    h, l, v = jblocks.dedupe_row_keys(
        jnp.asarray((k64 >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((k64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray(valid))
    limbs = np.stack([np.asarray(h), np.asarray(l)], -1)
    v = np.array(v)
    # the port's own row dedupe gives the same keys
    pk, pv = blocks.dedupe_row_keys(u64.from_numpy_u64(k64), torch.from_numpy(valid))
    assert np.array_equal(u64.to_numpy_u64(pk), pack_key64(limbs))
    assert np.array_equal(pv.numpy(), v)
    return limbs, pack_key64(limbs), v


def _parts(rng, n, k_parts):
    if k_parts == 1:
        return [np.arange(n)]
    cuts = np.sort(rng.choice(np.arange(1, n), k_parts - 1, replace=False))
    return np.split(np.arange(n), cuts)


def _ingest_both(limbs, key64, valid, max_block, parts):
    """The same parts into the JAX store and the port's (on the CPU)."""
    jstore = JBlockStore(jhdb.HDBConfig(**_cfg(max_block)))
    jblk = JDeltaBlocker(jstore)
    store = BlockStore(hdb.HDBConfig(**_cfg(max_block)), device="cpu")
    blk = DeltaBlocker(store)
    jreps, reps = [], []
    for part in parts:
        jreps.append(jblk.ingest_keys(limbs[part], valid[part]))
        reps.append(blk.ingest_keys(key64[part], valid[part]))
    return (jstore, jblk, jreps), (store, blk, reps)


def _assert_reports_equal(got, want, tag):
    assert got.num_records == want.num_records, tag
    for g, w in zip(got.pairs_added + got.pairs_retracted,
                    want.pairs_added + want.pairs_retracted):
        assert np.array_equal(np.asarray(g, np.int64), np.asarray(w, np.int64)), tag
    assert ([dataclasses.asdict(r) for r in got.levels]
            == [dataclasses.asdict(r) for r in want.levels]), tag


def _batch_port(key64, valid, max_block):
    res = hdb.hashed_dynamic_blocking(u64.from_numpy_u64(key64),
                                      torch.from_numpy(valid.copy()),
                                      hdb.HDBConfig(**_cfg(max_block)), device="cpu")
    blk = pairs.build_blocks(res, device="cpu")
    return (pairs.dedupe_pairs(blk, budget=blk.num_pair_slots + 1, device="cpu"),
            pairs.build_blocks(res, min_size=1, device="cpu"))


def _assert_store_matches(store, want, want_blk, tag):
    got = store.candidate_pairs()
    for f in ("a", "b", "src_size"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), (tag, f)
    assert got.total_slots == want.total_slots, tag
    gb = store.accepted_blocks(min_size=1)
    for f in ("key_hi", "key_lo", "start", "size", "members"):
        assert np.array_equal(getattr(gb, f), getattr(want_blk, f)), (tag, f)


# ---------------------------------------------------------------------------
# the acceptance property: store == batch HDB, reports == JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_block", [3, 8, 20])
@pytest.mark.parametrize("k_parts", [1, 2, 3, 6])
def test_ingest_in_parts_matches_batch_and_reference(k_parts, max_block):
    seed = 100 * k_parts + max_block
    rng = np.random.default_rng(seed)
    card = (12, 30, 60)[seed % 3]
    limbs, key64, valid = _random_keys(rng, n=160, k=6, card=card)
    parts = _parts(rng, len(key64), k_parts)
    (jstore, _, jreps), (store, _, reps) = _ingest_both(limbs, key64, valid,
                                                         max_block, parts)
    tag = f"K={k_parts} mbs={max_block} card={card}"
    for got, want in zip(reps, jreps):
        _assert_reports_equal(got, want, tag)
    want, want_blk = _batch_port(key64, valid, max_block)
    assert len(want.a) > 0, tag
    _assert_store_matches(store, want, want_blk, tag)
    assert np.array_equal(store.led_pack, jstore.led_pack), tag
    assert np.array_equal(store.led_src, jstore.led_src), tag
    assert store.memory_stats() == jstore.memory_stats(), tag


def test_pair_deltas_reconstruct_ledger():
    rng = np.random.default_rng(77)
    _, key64, valid = _random_keys(rng, n=200, k=6, card=15)
    store = BlockStore(hdb.HDBConfig(**_cfg(8)), device="cpu")
    blk = DeltaBlocker(store)
    led = {}
    for part in _parts(rng, len(key64), 5):
        rep = blk.ingest_keys(key64[part], valid[part])
        for x, y in zip(*rep.pairs_retracted):
            del led[(int(x), int(y))]
        for x, y, s in zip(*rep.pairs_added):
            assert (int(x), int(y)) not in led
            led[(int(x), int(y))] = int(s)
    got = store.candidate_pairs()
    assert set(led) == {(int(x), int(y)) for x, y in zip(got.a, got.b)}
    assert len(led) > 0


@pytest.mark.parametrize("include_probe", [False, True])
def test_query_keys_matches_reference(include_probe):
    rng = np.random.default_rng(3)
    limbs, key64, valid = _random_keys(rng, n=150, k=6, card=20)
    parts = _parts(rng, 120, 2)
    (jstore, jblk, _), (store, blk, _) = _ingest_both(limbs, key64, valid, 8, parts)
    # five probes (stored records and new ones) + three padding rows
    probe = np.array([0, 7, 119, 130, 149])
    q_limbs = np.concatenate([limbs[probe], np.full((3, 6, 2), 0xFFFFFFFF, np.uint32)])
    q_valid = np.concatenate([valid[probe], np.zeros((3, 6), bool)])
    before = store.memory_stats()
    want = jblk.query_keys(q_limbs, q_valid, include_probe=include_probe, n_real=5)
    got = blk.query_keys(pack_key64(q_limbs), q_valid, include_probe=include_probe,
                         n_real=5)
    assert store.memory_stats() == before  # read-only
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert np.array_equal(g.candidates, w.candidates)
        assert g.n_blocks_hit == w.n_blocks_hit
        assert g.levels_walked == w.levels_walked
        assert np.array_equal(g.block_sizes, w.block_sizes)
    assert sum(g.n_blocks_hit for g in got) > 0


# ---------------------------------------------------------------------------
# record-level front ends
# ---------------------------------------------------------------------------


SPEC_ENGINE = dict(num_entities=80, seed=11)
CFG_ENGINE = dict(max_block_size=25, max_iterations=5, cms_width=1 << 12)


@pytest.mark.parametrize("match_backend", ["host", "auto"])
def test_streaming_engine_matches_reference(match_backend):
    jc = jsyn.generate(jsyn.SyntheticSpec(**SPEC_ENGINE))
    tc = synthetic.generate(synthetic.SyntheticSpec(**SPEC_ENGINE), device="cpu")
    n = tc.num_records
    cuts = np.sort(np.random.default_rng(0).choice(np.arange(1, n), 3, replace=False))
    parts = np.split(np.arange(n), cuts)
    jeng = JStreamingEngine(jc.blocking, jhdb.HDBConfig(**CFG_ENGINE), ingest_slots=64,
                            matcher_cfg=jmatcher.MatcherConfig(),
                            match_backend=match_backend)
    eng = StreamingEngine(tc.blocking, hdb.HDBConfig(**CFG_ENGINE), ingest_slots=64,
                          matcher_cfg=matcher.MatcherConfig(),
                          match_backend=match_backend, device="cpu")
    for part in parts:
        jeng.submit_ingest(JRecordBatch.from_corpus(jc, part))
        eng.submit_ingest(RecordBatch.from_corpus(tc, part))
    for probe in ([0], [3, 17]):
        jeng.submit_query(JRecordBatch.from_corpus(jc, np.array(probe)))
        eng.submit_query(RecordBatch.from_corpus(tc, np.array(probe)))
    jing, jprobes = jeng.run()
    ing, probes = eng.run()
    assert len(ing) == len(jing) > 1
    for g, w in zip(ing, jing):
        assert (g.uids, g.first_rid) == (w.uids, w.first_rid)
        _assert_reports_equal(g.report, w.report, "engine")
        if match_backend == "host":
            assert (g.match_scores is None) == (w.match_scores is None)
            if w.match_scores is not None:
                assert np.array_equal(g.match_scores, np.asarray(w.match_scores))
        else:
            assert (g.matched_pairs is None) == (w.matched_pairs is None)
            if w.matched_pairs is not None:
                assert np.array_equal(g.matched_pairs, w.matched_pairs)
    assert sum(g.report.num_pairs_added for g in ing) > 0
    assert len(probes) == len(jprobes) == 3
    for g, w in zip(probes, jprobes):
        assert g.uid == w.uid
        assert np.array_equal(g.result.candidates, w.result.candidates)
        assert g.result.n_blocks_hit == w.result.n_blocks_hit
    # the store equals the port's batch path on the corpus's keys
    keys, valid = blocks.build_keys(tc.columns, tc.blocking)
    res = hdb.hashed_dynamic_blocking(keys, valid, hdb.HDBConfig(**CFG_ENGINE),
                                      device="cpu")
    blk = pairs.build_blocks(res, device="cpu")
    want = pairs.dedupe_pairs(blk, budget=blk.num_pair_slots + 1, device="cpu")
    got = eng.store.candidate_pairs()
    assert np.array_equal(got.a, want.a) and np.array_equal(got.b, want.b)


SPEC_PIPE = dict(num_entities=100, seed=21)
CFG_PIPE = dict(max_block_size=30, max_iterations=5, cms_width=1 << 12)


@pytest.mark.parametrize("match_backend", ["host", "auto"])
def test_dedup_pipeline_extend_matches_batch_and_reference(match_backend):
    jc = jsyn.generate(jsyn.SyntheticSpec(**SPEC_PIPE))
    tc = synthetic.generate(synthetic.SyntheticSpec(**SPEC_PIPE), device="cpu")
    n = tc.num_records
    cuts = np.sort(np.random.default_rng(5).choice(np.arange(1, n), 2, replace=False))
    jpipe_ = jpipe.DedupPipeline(jhdb.HDBConfig(**CFG_PIPE), match_backend=match_backend)
    pipe = pipeline.DedupPipeline(hdb.HDBConfig(**CFG_PIPE), match_backend=match_backend,
                                  device="cpu")
    seen = 0
    for part in np.split(np.arange(n), cuts):
        want = jpipe_.extend(jsyn.corpus_slice(jc, part))
        rep = pipe.extend(synthetic.corpus_slice(tc, part))
        seen += len(part)
        for f in ("num_records", "num_candidate_pairs", "num_matched_pairs",
                  "num_components", "num_survivors"):
            assert getattr(rep, f) == getattr(want, f), f
        assert np.array_equal(rep.component_of, want.component_of)
        assert np.array_equal(rep.survivors, want.survivors)
        # each extend describes the union so far, as the batch path does
        batch = pipeline.dedup_corpus(synthetic.corpus_slice(tc, np.arange(seen)),
                                      hdb.HDBConfig(**CFG_PIPE), pair_budget=50_000_000,
                                      match_backend=match_backend, device="cpu")
        assert rep.num_candidate_pairs == batch.num_candidate_pairs
        assert rep.num_matched_pairs == batch.num_matched_pairs
        assert np.array_equal(rep.component_of, batch.component_of)
    assert rep.num_matched_pairs > 0 and rep.num_components < rep.num_records


def test_stream_smoke_run_matches_reference():
    """The streaming smoke that the card holds against the CPU: its extend
    results equal JAX's DedupPipeline.extend on the same parts, its engine
    ledger equals the last extend's pairs, and differing() names a change."""
    from repro_torch.streaming import smoke
    got = smoke.smoke_run("cpu")
    jc = jsyn.generate(jsyn.SyntheticSpec(num_entities=150, seed=7))
    parts = np.array_split(np.arange(jc.num_records), 3)
    for backend in ("auto", "host"):
        jp = jpipe.DedupPipeline(jhdb.HDBConfig(max_block_size=50, max_iterations=6,
                                                cms_width=1 << 12),
                                 match_backend=backend)
        want = [jp.extend(jsyn.corpus_slice(jc, part)) for part in parts]
        assert smoke.same_values(
            got[f"extend {backend}"],
            [[w.num_candidate_pairs, w.num_matched_pairs, w.component_of]
             for w in want]), backend
    assert len(got["ledger"][0]) == got["extend auto"][-1][0] > 0
    assert smoke.differing(got, smoke.smoke_run("cpu")) == []
    changed = dict(got, probes=got["probes"][:1])
    assert smoke.differing(got, changed) == ["probes"]


# ---------------------------------------------------------------------------
# the modules the slice brings
# ---------------------------------------------------------------------------


def test_np_mirrors_equal_device_functions_and_reference():
    rng = np.random.default_rng(0)
    k64 = rng.integers(0, 1 << 63, 500, dtype=np.uint64)
    k64[:3] = [0, 0xFFFFFFFFFFFFFFFF, 1 << 63]
    cfg = sketches.CMSConfig(4, 1 << 12)
    host = sketches.np_cms_indices(cfg, k64)
    dev = sketches.cms_indices(cfg, u64.from_numpy_u64(k64)).numpy()
    assert host.dtype == np.int32 and np.array_equal(host, dev)
    assert np.array_equal(host, jsketches.np_cms_indices(jsketches.CMSConfig(4, 1 << 12),
                                                         k64))
    rid = rng.integers(0, 1 << 31, 500).astype(np.int64)
    fp = hashing.np_fingerprint_rid(rid)
    assert np.array_equal(fp, u64.to_numpy_u64(hashing.fingerprint_rid(torch.from_numpy(rid))))
    assert np.array_equal(fp, jhashing.np_fingerprint_rid(rid))


def test_cms_fold_subtract_decay_algebra():
    cfg = sketches.CMSConfig(2, 1 << 8)
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(sketches.np_cms_indices(
        cfg, rng.integers(0, 50, 300, dtype=np.uint64)))
    live = torch.ones(300, dtype=torch.bool)
    full = sketches.cms_build_indices(cfg, idx, live)
    part_a = sketches.cms_build_indices(cfg, idx[:, :100].contiguous(), live[:100])
    part_b = sketches.cms_build_indices(cfg, idx[:, 100:].contiguous(), live[100:])
    assert torch.equal(sketches.cms_fold(part_a, part_b), full)
    assert torch.equal(sketches.cms_merge(part_a, part_b), full)
    assert torch.equal(sketches.cms_subtract(full, part_b), part_a)
    assert torch.equal(sketches.cms_decay(full, 1), full >> 1)
    # numpy sketches fold the same way, as the reference's do
    assert np.array_equal(sketches.cms_fold(part_a.numpy(), part_b.numpy()),
                          jsketches.cms_fold(part_a.numpy(), part_b.numpy()))


@pytest.mark.parametrize("n", [0, 1, 31, 1000])
def test_level_cms_apply_equals_add_at(n):
    cfg = sketches.CMSConfig(4, 1 << 10)
    rng = np.random.default_rng(n)
    base = sketches.np_cms_indices(cfg, rng.integers(0, 40, 3000, dtype=np.uint64))
    lk = LevelKeys.empty(cfg, torch.device("cpu"))
    want = np.zeros((cfg.depth, cfg.width), np.int32)
    lk.cms_apply(base, 1)
    for j in range(cfg.depth):
        np.add.at(want[j], base[j], 1)
    delta = base[:, rng.permutation(3000)[:n]]
    for sign in (1, -1, -1):
        lk.cms_apply(delta, sign)
        for j in range(cfg.depth):
            np.add.at(want[j], delta[j], sign)
        assert np.array_equal(lk.cms.numpy(), want)
        assert (lk.cms >= 0).all()
    look = lk.cms_lookup(base[:, :50])
    assert np.array_equal(look, np.stack([want[j][base[j, :50]] for j in range(4)]))
    with pytest.raises(ValueError):
        lk.cms_apply(delta, 2)


@pytest.mark.parametrize("seed", [0, 1])
def test_survivor_dedupe_matches_reference(seed):
    rng = np.random.default_rng(seed)
    m = 300
    key = np.unique(rng.integers(0, 1 << 63, m, dtype=np.uint64))
    m = len(key)
    grp = rng.integers(0, 60, m)  # equal (fingerprint, size) groups: duplicates
    fp = (grp.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) ^ np.uint64(7)
    sz = (grp % 7 + 10).astype(np.int32)
    _, _, want = jhdb.survivor_reps(
        *[jnp.asarray(x) for x in (*_limbs(fp), sz, *_limbs(key))])
    table, n_dup, got = hdb.dedupe_oversized_reps(
        u64.from_numpy_u64(fp), torch.from_numpy(sz), u64.from_numpy_u64(key))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(n_dup) == m - len(np.unique(grp))


def _limbs(x):
    return ((x >> np.uint64(32)).astype(np.uint32),
            (x & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def test_merge_blocks_matches_reference():
    """CSR slices with disjoint keys merge back into the key-sorted CSR."""
    from repro.core import pairs as jpairs
    from repro.streaming import store as jstore_mod
    from repro_torch.streaming import store as store_mod
    rng = np.random.default_rng(8)
    _, key64, valid = _random_keys(rng, n=160, k=6, card=30)
    store = BlockStore(hdb.HDBConfig(**_cfg(8)), device="cpu")
    DeltaBlocker(store).ingest_keys(key64, valid)
    whole = store.accepted_blocks(min_size=1)
    part = rng.integers(0, 3, whole.num_blocks)
    slices = [store_mod.blocks_from_segments(
        store.bk_key[part == p], whole.size[part == p],
        store_mod.gather_segments(whole.start[part == p], whole.size[part == p],
                                  whole.members)) for p in range(3)]
    got = store_mod.merge_blocks(slices)
    want = jstore_mod.merge_blocks([jpairs.Blocks(b.key_hi, b.key_lo, b.start, b.size,
                                                  b.members) for b in slices])
    for f in ("key_hi", "key_lo", "start", "size", "members"):
        assert np.array_equal(getattr(got, f), getattr(whole, f)), f
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert whole.num_blocks > 10 and len(np.unique(part)) == 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_edges_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 700
    a = rng.integers(0, n, 400)
    b = rng.integers(0, n, 400)
    chain = rng.permutation(n)[:150]   # long diameter: several rounds
    a = np.concatenate([a, chain[:-1]])
    b = np.concatenate([b, chain[1:]])
    want = jcomp.cluster_edges(n, a, b)
    got = components.cluster_edges(n, a, b, device="cpu")
    assert np.array_equal(got.label, want.label)
    assert np.array_equal(got.survivors, want.survivors)
    assert (got.converged, got.rounds) == (want.converged, want.rounds)
    empty = components.cluster_edges(5, a[:0], b[:0], device="cpu")
    assert np.array_equal(empty.label, np.arange(5)) and empty.rounds == 0
    with pytest.warns(RuntimeWarning):
        cut = components.cluster_edges(n, a, b, max_rounds=1, device="cpu")
    with pytest.warns(RuntimeWarning):
        wcut = jcomp.cluster_edges(n, a, b, max_rounds=1)
    assert not cut.converged and np.array_equal(cut.label, wcut.label)


def test_corpus_slice_matches_reference():
    jc = jsyn.generate(jsyn.SyntheticSpec(num_entities=60, seed=3))
    tc = synthetic.generate(synthetic.SyntheticSpec(num_entities=60, seed=3), device="cpu")
    idx = np.random.default_rng(0).permutation(tc.num_records)[:40]
    js, ts = jsyn.corpus_slice(jc, idx), synthetic.corpus_slice(tc, idx)
    assert ts.num_records == js.num_records == 40
    assert np.array_equal(ts.entity_id, js.entity_id)
    for name, col in js.columns.items():
        assert np.array_equal(ts.columns[name].tokens.numpy(), np.asarray(col.tokens))
        assert np.array_equal(ts.columns[name].mask.numpy(), np.asarray(col.mask))


def test_scheduler_matches_reference():
    rng = np.random.default_rng(4)
    for _ in range(20):
        queue = [(int(rng.integers(0, 4)), int(rng.integers(1, 40)))
                 for _ in range(int(rng.integers(0, 12)))]
        jq, tq = list(queue), list(queue)
        budget = int(rng.integers(1, 60))
        kw = dict(size_fn=lambda e: e[1], group_fn=lambda e: e[0],
                  take_if=lambda e: e[1] % 5 != 0)
        assert scheduler.collate_fifo(tq, budget, **kw) == jsched.collate_fifo(jq, budget, **kw)
        assert tq == jq

    class Eng:
        def __init__(self, work):
            self.work = work

        @property
        def busy(self):
            return self.work > 0

        def step(self):
            self.work -= 1

    for work, cap in ((3, 10), (12, 5), (0, 4)):
        t, j = Eng(work), Eng(work)
        assert scheduler.drain(t, cap) == jsched.drain(j, cap)
        assert t.work == j.work


def test_entry_points_refuse_what_is_not_ported(monkeypatch):
    cfg = hdb.HDBConfig(**_cfg(8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlockStore(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.DedupPipeline(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingEngine({}, cfg)
    assert device_mod.resolve_device("cpu").type == "cpu"
    store = BlockStore(cfg, device="cpu")
    with pytest.raises(ValueError, match="sort_backend"):
        DeltaBlocker(store, sort_backend="radix")
    with pytest.raises(ValueError, match="sort_backend"):
        DeltaBlocker(store, sort_backend="comparator")
    # the meshless sharded store is ported; a mesh is not
    assert isinstance(StreamingEngine({}, cfg, n_shards=2, device="cpu").store,
                      ShardedBlockStore)
    with pytest.raises(NotImplementedError, match="A7"):
        ShardedBlockStore(cfg, n_shards=2, mesh=object(), device="cpu")
    store.mesh = object()
    with pytest.raises(NotImplementedError, match="A7"):
        DeltaBlocker(store)
    assert DeltaBlocker(BlockStore(cfg, device="cpu")).routed_fallback_total == 0
