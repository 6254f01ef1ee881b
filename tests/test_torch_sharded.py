"""Port parity: the meshless sharded streaming store (ShardRouter,
ShardedLevelKeys, StoreShard, ShardedBlockStore), the owner rule of
``core/routing.py`` and ``StreamingEngine(n_shards > 1)``.

The inputs of the JAX package's ``tests/test_streaming_sharded.py`` (its
key layouts, seeds and configurations) go through ``repro.streaming`` and
``repro_torch.streaming`` (``device="cpu"``) in the same parts. Tolerance:
exact equality of every report, ledger entry, block, query result, table
row, sketch count and byte gauge.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_streaming import _assert_reports_equal, _random_keys  # noqa: E402

from repro.core import hdb as jhdb  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.streaming import DeltaBlocker as JDeltaBlocker  # noqa: E402
from repro.streaming import RecordBatch as JRecordBatch  # noqa: E402
from repro.streaming import ShardedBlockStore as JShardedBlockStore  # noqa: E402
from repro.streaming import StreamingEngine as JStreamingEngine  # noqa: E402
from repro_torch.core import hdb, routing  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.streaming import (BlockStore, DeltaBlocker, RecordBatch,  # noqa: E402
                                   ShardedBlockStore, ShardRouter, StoreShard,
                                   StreamingEngine)


def _cfg(max_block):
    # tests/test_streaming.py's _CFGS
    return dict(max_block_size=max_block, max_iterations=5, max_oversize_keys=6,
                cms_width=1 << 10)


def _parts(rng, n, k_parts):
    if k_parts == 1:
        return [np.arange(n)]
    cuts = np.sort(rng.choice(np.arange(1, n), k_parts - 1, replace=False))
    return np.split(np.arange(n), cuts)


def _ingest_three(limbs, key64, valid, max_block, parts, n_shards):
    """The same parts into the reference's sharded store, the port's
    sharded store and the port's single store. Returns (store, blocker,
    reports) for each."""
    jst = JShardedBlockStore(jhdb.HDBConfig(**_cfg(max_block)), n_shards=n_shards)
    st = ShardedBlockStore(hdb.HDBConfig(**_cfg(max_block)), n_shards=n_shards,
                           device="cpu")
    single = BlockStore(hdb.HDBConfig(**_cfg(max_block)), device="cpu")
    out = []
    for store, blk, k in ((jst, JDeltaBlocker(jst), limbs), (st, DeltaBlocker(st), key64),
                          (single, DeltaBlocker(single), key64)):
        reps = [blk.ingest_keys(k[p], valid[p]) for p in parts if len(p)]
        out.append((store, blk, reps))
    return out


def _assert_views_equal(got, want, tag):
    assert np.array_equal(got.led_pack, want.led_pack), tag
    assert np.array_equal(got.led_src, want.led_src), tag
    ga, wa = got.accepted_blocks(1), want.accepted_blocks(1)
    for f in ("key_hi", "key_lo", "start", "size", "members"):
        assert np.array_equal(getattr(ga, f), getattr(wa, f)), (tag, f)
    gp, wp = got.candidate_pairs(), want.candidate_pairs()
    for f in ("a", "b", "src_size"):
        assert np.array_equal(getattr(gp, f), getattr(wp, f)), (tag, f)
    assert (gp.exact, gp.total_slots) == (wp.exact, wp.total_slots), tag


@pytest.mark.parametrize("n_shards", [1, 4, 8])
@pytest.mark.parametrize("k_parts,card,seed", [(2, 12, 0), (3, 30, 1)])
def test_sharded_ingest_equals_reference_and_single_store(n_shards, k_parts, card, seed):
    rng = np.random.default_rng(seed)
    limbs, key64, valid = _random_keys(rng, 140, 6, card)
    (jst, _, jreps), (st, _, reps), (single, _, sreps) = _ingest_three(
        limbs, key64, valid, 8, _parts(rng, 140, k_parts), n_shards)
    tag = f"shards={n_shards} K={k_parts} card={card}"
    for g, w, s in zip(reps, jreps, sreps):
        _assert_reports_equal(g, w, tag)
        _assert_reports_equal(g, s, tag)
    _assert_views_equal(st, jst, tag)
    _assert_views_equal(st, single, tag)
    assert len(st.led_pack) > 0
    assert st.memory_stats() == jst.memory_stats()
    assert st.router.exchange_total == jst.router.exchange_total > 0


def test_single_shard_degenerates_to_blockstore():
    """n_shards=1 matches the single store down to the per-level tables
    and sketches."""
    rng = np.random.default_rng(5)
    limbs, key64, valid = _random_keys(rng, 120, 5, 15)
    parts = [np.arange(0, 40), np.arange(40, 80), np.arange(80, 120)]
    _, (st, _, reps), (single, _, sreps) = _ingest_three(limbs, key64, valid, 3,
                                                         parts, 1)
    for g, s in zip(reps, sreps):
        _assert_reports_equal(g, s, "degenerate")
    _assert_views_equal(st, single, "degenerate")
    for rs, ss in zip(single.levels, st.levels):
        if rs is None or ss is None:
            assert rs is ss
            continue
        sl = ss.keyspace.slices[0]
        for f in ("tab_key", "tab_cnt", "tab_fp", "tab_surv"):
            assert np.array_equal(getattr(rs.keyspace, f), getattr(sl, f)), f
        assert torch.equal(rs.keyspace.cms, sl.cms)
        assert torch.equal(rs.keyspace.cms, ss.keyspace.cms)


@pytest.mark.parametrize("include_probe", [False, True])
def test_sharded_query_parity(include_probe):
    rng = np.random.default_rng(11)
    limbs, key64, valid = _random_keys(rng, 150, 6, 20)
    (jst, jblk, _), (st, blk, _), (_, sblk, _) = _ingest_three(
        limbs, key64, valid, 8, _parts(rng, 150, 3), 4)
    ql, qk, qv = _random_keys(rng, 16, 6, 20)
    got = blk.query_keys(qk, qv, include_probe=include_probe)
    for want in (jblk.query_keys(ql, qv, include_probe=include_probe),
                 sblk.query_keys(qk, qv, include_probe=include_probe)):
        assert len(got) == len(want) == 16
        for g, w in zip(got, want):
            assert np.array_equal(g.candidates, w.candidates)
            assert (g.n_blocks_hit, g.levels_walked) == (w.n_blocks_hit, w.levels_walked)
            assert np.array_equal(g.block_sizes, w.block_sizes)
    # queries are read-only on the sharded store too
    before = st.memory_stats()
    blk.query_keys(qk, qv, include_probe=include_probe)
    assert st.memory_stats() == before


def test_empty_shard_edge():
    """One key for every record sends every key to one owner: 7 of 8
    shards stay empty and every merged view is still exact."""
    k64 = np.full((40, 3), np.uint64(0x9E3779B97F4A7C15))
    limbs = np.stack([(k64 >> np.uint64(32)).astype(np.uint32),
                      (k64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)], -1)
    limbs[:, 1:] = 0xFFFFFFFF
    k64[:, 1:] = np.uint64(0xFFFFFFFFFFFFFFFF)
    valid = np.zeros((40, 3), bool)
    valid[:, 0] = True
    parts = _parts(np.random.default_rng(2), 40, 3)
    (jst, _, jreps), (st, _, reps), (single, _, _) = _ingest_three(
        limbs, k64, valid, 3, parts, 8)
    for g, w in zip(reps, jreps):
        _assert_reports_equal(g, w, "empty-shard")
    _assert_views_equal(st, jst, "empty-shard")
    _assert_views_equal(st, single, "empty-shard")
    assert sum(sh.num_keys > 0 for sh in st.shards) == 1
    assert st.memory_stats()["shard_skew"] > 1.0
    assert st.memory_stats() == jst.memory_stats()


@pytest.mark.parametrize("n_shards", [4, 8])
def test_merged_cms_equals_sum_of_shard_slices(n_shards):
    rng = np.random.default_rng(21)
    limbs, key64, valid = _random_keys(rng, 100, 5, 18)
    (jst, _, _), (st, _, _), (single, _, _) = _ingest_three(
        limbs, key64, valid, 8, _parts(rng, 100, 2), n_shards)
    for js, ss, rs in zip(jst.levels, st.levels, single.levels):
        if ss is None:
            assert js is None and rs is None
            continue
        total = torch.zeros_like(ss.keyspace.cms)
        for sl, jsl in zip(ss.keyspace.slices, js.keyspace.slices):
            assert np.array_equal(sl.cms.numpy(), jsl.cms)
            total += sl.cms
        assert torch.equal(total, ss.keyspace.cms)
        assert torch.equal(ss.keyspace.cms, rs.keyspace.cms)
        assert np.array_equal(ss.keyspace.cms.numpy(), js.keyspace.cms)


def test_memory_stats_per_shard_gauges():
    rng = np.random.default_rng(33)
    limbs, key64, valid = _random_keys(rng, 120, 5, 20)
    (jst, _, _), (st, _, _), (single, _, _) = _ingest_three(
        limbs, key64, valid, 8, _parts(rng, 120, 2), 4)
    ms = st.memory_stats()
    assert ms == jst.memory_stats()
    assert ms["n_shards"] == 4 and ms["shard_skew"] >= 1.0
    assert sum(ms[f"shard{s}_ledger_bytes"] for s in range(4)) == ms["ledger_bytes"]
    assert sum(ms[f"shard{s}_csr_bytes"] for s in range(4)) == ms["csr_bytes"]
    rms = single.memory_stats()
    for k in ("ledger_pairs", "accepted_blocks", "accepted_assignments",
              "num_records", "keytab_bytes", "ledger_bytes"):
        assert ms[k] == rms[k], k
    # the merged replica plus one slice a shard
    assert ms["cms_bytes"] == 5 * rms["cms_bytes"]


def test_owner_rule_and_router_equal_reference():
    x = np.random.default_rng(0).integers(0, 1 << 63, 5000, dtype=np.int64).astype(np.uint64)
    x[:3] = [0, 1, np.uint64(0xFFFFFFFFFFFFFFFF)]
    assert (routing.KEY_OWNER_SEED, routing.REP_OWNER_SEED) == \
        (jrouting.KEY_OWNER_SEED, jrouting.REP_OWNER_SEED)
    for n in (1, 3, 4, 8, 96):
        for seed in (routing.KEY_OWNER_SEED, routing.REP_OWNER_SEED, 0):
            got = routing.np_owner_u64(x, n, seed=seed)
            assert got.dtype == np.int32
            assert np.array_equal(got, jrouting.np_owner_u64(x, n, seed=seed))
    with pytest.raises(ValueError):
        routing.np_owner_u64(x, 0)
    with pytest.raises(ValueError):
        ShardRouter(0)
    r = ShardRouter(8)
    ko, po = r.key_owner(x), r.pair_owner(x)
    assert ko.min() >= 0 and ko.max() < 8 and (ko != po).any()
    assert np.array_equal(ko, jrouting.np_owner_u64(x, 8, seed=jrouting.KEY_OWNER_SEED))
    # the exchange hands each shard its keys, in key order
    key = np.sort(x)
    parts = r.exchange_key_deltas(key, np.arange(len(key)), key)
    assert r.exchange_total == 1
    assert sum(len(k) for k, _, _ in parts) == len(key)
    for s, (k, c, f) in enumerate(parts):
        assert (r.key_owner(k) == s).all() and (np.diff(k) > 0).all()
        assert np.array_equal(key[c], k) and np.array_equal(f, k)


def test_mesh_raises_and_shards_are_containers():
    cfg = hdb.HDBConfig(**_cfg(8))
    eight_ranks = types.SimpleNamespace(mesh_dim_names=("data",), size=lambda dim: 8)
    with pytest.raises(ValueError, match="must match"):
        ShardedBlockStore(cfg, n_shards=4, mesh=eight_ranks, device="cpu")
    sh = StoreShard(cfg, 2, torch.device("cpu"))
    assert sh.total_bytes == 0 and sh.num_keys == 0
    assert sh.keys_at(1) is sh.keys_at(1)
    assert sh.keys_at(1).cms.shape == (cfg.cms.depth, cfg.cms.width)
    st = ShardedBlockStore(cfg, n_shards=4, device="cpu")
    assert DeltaBlocker(st).routed_fallback_total == 0
    with pytest.raises(ValueError):
        st.level(0)


SPEC_ENGINE = dict(num_entities=80, seed=11)
CFG_ENGINE = dict(max_block_size=25, max_iterations=5, cms_width=1 << 12)


def test_streaming_engine_sharded_matches_reference_and_single():
    jc = jsyn.generate(jsyn.SyntheticSpec(**SPEC_ENGINE))
    tc = synthetic.generate(synthetic.SyntheticSpec(**SPEC_ENGINE), device="cpu")
    parts = _parts(np.random.default_rng(0), tc.num_records, 3)
    jeng = JStreamingEngine(jc.blocking, jhdb.HDBConfig(**CFG_ENGINE), ingest_slots=64,
                            n_shards=4)
    engines = [StreamingEngine(tc.blocking, hdb.HDBConfig(**CFG_ENGINE), ingest_slots=64,
                               n_shards=n, device="cpu") for n in (4, 1)]
    for part in parts:
        jeng.submit_ingest(JRecordBatch.from_corpus(jc, part))
        for eng in engines:
            eng.submit_ingest(RecordBatch.from_corpus(tc, part))
    for eng in [jeng] + engines:
        eng.submit_query((JRecordBatch if eng is jeng else RecordBatch).from_corpus(
            jc if eng is jeng else tc, np.array([3, 17])))
    jing, jprobes = jeng.run()
    (ing, probes), (sing, sprobes) = (eng.run() for eng in engines)
    assert isinstance(engines[0].store, ShardedBlockStore)
    assert isinstance(engines[1].store, BlockStore)
    assert len(ing) == len(jing) == len(sing) > 1
    for g, w, s in zip(ing, jing, sing):
        assert (g.uids, g.first_rid) == (w.uids, w.first_rid) == (s.uids, s.first_rid)
        _assert_reports_equal(g.report, w.report, "engine")
        _assert_reports_equal(g.report, s.report, "engine")
    for g, w, s in zip(probes, jprobes, sprobes):
        assert np.array_equal(g.result.candidates, w.result.candidates)
        assert np.array_equal(g.result.candidates, s.result.candidates)
    _assert_views_equal(engines[0].store, jeng.store, "engine")
    _assert_views_equal(engines[0].store, engines[1].store, "engine")
    assert sum(g.report.num_records for g in ing) == tc.num_records


@pytest.mark.parametrize("n_shards", [4, 8])
def test_sharded_smoke_run_equals_single_store(n_shards):
    """chip_smoke's phase 5d on the CPU: the smoke corpus through
    StreamingEngine(n_shards) equals the single store's run."""
    from repro_torch.streaming import smoke
    got = smoke.sharded_run("cpu", n_shards)
    assert smoke.differing(got, smoke.sharded_run("cpu", 1)) == []
    assert len(got["ledger"][0]) > 0 and len(got["reports"]) > 1
