"""Port parity: the dedupe probe service (``repro_torch.serving``: service,
buckets, metrics) against ``repro.serving``, and every test of
``tests/test_serving.py`` on the port.

The same numpy keys, made from fixed seeds, go to the JAX service (limb
pairs) and to the port's service on the CPU (u64 keys, ``device="cpu"``).
Each service reads its own deterministic clock, a counter that steps by a
fixed amount on every read, so latencies and snapshots are comparable.
Tolerance: exact equality of every response, latency and snapshot value.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _propcheck import given, settings, st  # noqa: E402
from test_torch_streaming import _random_keys  # noqa: E402

import repro.serving as jserving  # noqa: E402
from repro.core import hdb as jhdb  # noqa: E402
from repro.serving import buckets as jbuckets  # noqa: E402
from repro.serving import metrics as jmetrics  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.core import hdb, u64  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.serving import (BackpressureError, DedupeService,  # noqa: E402
                                 ServiceConfig)
from repro_torch.serving.buckets import BucketLadder, pad_probe_rows  # noqa: E402
from repro_torch.serving.metrics import Histogram, Metrics  # noqa: E402
from repro_torch.serving.scheduler import collate_fifo  # noqa: E402
from repro_torch.serving.smoke import step_clock  # noqa: E402
from repro_torch.streaming import RecordBatch, StreamingEngine  # noqa: E402
from repro_torch.streaming.delta import probe_jit_cache_sizes  # noqa: E402

_CFG = dict(max_block_size=8, max_iterations=5, max_oversize_keys=6,
            cms_width=1 << 10)


class Twin:
    """The JAX service and the port's, driven by the same calls."""

    def __init__(self, **service):
        self.j = jserving.DedupeService(jhdb.HDBConfig(**_CFG),
                                        jserving.ServiceConfig(**service), step_clock())
        self.t = DedupeService(hdb.HDBConfig(**_CFG), ServiceConfig(**service),
                               step_clock(), device="cpu")

    def add_tenant(self, name):
        self.j.add_tenant(name)
        return self.t.add_tenant(name)

    def submit_probe(self, tenant, limbs, key64, valid, **kw):
        uj = self.j.submit_probe(tenant, limbs, valid, **kw)
        ut = self.t.submit_probe(tenant, key64, valid, **kw)
        assert uj == ut
        return ut

    def submit_ingest(self, tenant, limbs, key64, valid):
        uj = self.j.submit_ingest(tenant, limbs, valid)
        ut = self.t.submit_ingest(tenant, key64, valid)
        assert uj == ut
        return ut

    def step(self):
        self.j.step()
        self.t.step()

    def run(self, **kw):
        self.j.run(**kw)
        return self.t.run(**kw)

    def refresh_clusters(self, name):
        want = self.j.refresh_clusters(name)
        got = self.t.refresh_clusters(name)
        assert np.array_equal(got.label, want.label)
        assert np.array_equal(got.survivors, want.survivors)
        assert (got.converged, got.rounds) == (want.converged, want.rounds)
        return got

    def assert_equal(self):
        """Every response, latency and the snapshot equal the reference's."""
        assert len(self.t.probe_responses) == len(self.j.probe_responses)
        for g, w in zip(self.t.probe_responses, self.j.probe_responses):
            assert (g.uid, g.tenant, g.status, g.latency_s) == (
                w.uid, w.tenant, w.status, w.latency_s)
            assert len(g.results) == len(w.results)
            for gr, wr in zip(g.results, w.results):
                _assert_result_equal(gr, wr)
        assert len(self.t.ingest_responses) == len(self.j.ingest_responses)
        for g, w in zip(self.t.ingest_responses, self.j.ingest_responses):
            assert (g.uid, g.tenant, g.status, g.first_rid, g.num_rows, g.latency_s) == (
                w.uid, w.tenant, w.status, w.first_rid, w.num_rows, w.latency_s)
            for x, y in zip(g.report.pairs_added + g.report.pairs_retracted,
                            w.report.pairs_added + w.report.pairs_retracted):
                assert np.array_equal(x, y)
            assert g.report.num_records == w.report.num_records
        assert self.t.snapshot() == self.j.snapshot()
        assert self.t.queue_depths() == self.j.queue_depths()


def _assert_result_equal(got, want):
    np.testing.assert_array_equal(got.candidates, want.candidates)
    np.testing.assert_array_equal(got.block_sizes, want.block_sizes)
    assert got.n_blocks_hit == want.n_blocks_hit
    assert got.levels_walked == want.levels_walked


def test_exports_match_reference():
    assert serving._EXPORTS == jserving._EXPORTS
    for name in serving._EXPORTS:
        assert getattr(serving, name) is not None
    assert serving.STATUS_OK == jserving.STATUS_OK == "ok"
    assert serving.STATUS_EXPIRED == jserving.STATUS_EXPIRED == "expired"


# ---------------------------------------------------------------------------
# batching invariance
# ---------------------------------------------------------------------------


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10_000),
       batch=st.sampled_from([1, 2, 5, 7, 16]),
       include_probe=st.sampled_from([False, True]))
def test_micro_batched_probes_match_one_at_a_time(seed, batch, include_probe):
    """Service responses (collated across requests, padded to bucket rungs)
    equal solo DeltaBlocker.query_keys calls — candidates, block sizes,
    hit and level counts — in both include_probe modes, and equal the JAX
    service's responses. probe_slots=16 with min_bucket=4 makes the
    collated batches cross several ladder rungs (4, 8, 16) across draws."""
    rng = np.random.default_rng(seed)
    limbs, key64, valid = _random_keys(rng, n=160, k=6, card=18)
    twin = Twin(probe_slots=16, min_bucket=4)
    tenant = twin.add_tenant("t")
    twin.submit_ingest("t", limbs[:120], key64[:120], valid[:120])
    twin.run()
    uids = []
    for off in range(120, 160, batch):
        end = min(off + batch, 160)
        uids.append(twin.submit_probe("t", limbs[off:end], key64[off:end],
                                      valid[off:end], include_probe=include_probe))
    twin.run()
    got = {r.uid: r for r in twin.t.probe_responses}
    row = 120
    some_candidates = False
    for uid in uids:
        resp = got[uid]
        assert resp.status == "ok"
        for qr in resp.results:
            want = tenant.blocker.query_keys(
                key64[row:row + 1], valid[row:row + 1],
                include_probe=include_probe)[0]
            _assert_result_equal(qr, want)
            some_candidates |= len(qr.candidates) > 0
            row += 1
    assert row == 160                # every probe row answered exactly once
    assert some_candidates           # the draw actually exercised the walk
    twin.assert_equal()


def test_pad_probe_rows_and_ladder():
    ladder = BucketLadder(min_bucket=8)
    assert [ladder.bucket(n) for n in (0, 1, 8, 9, 64, 65)] == [
        8, 8, 8, 16, 64, 128]
    assert ladder.rungs(64) == [8, 16, 32, 64]
    jladder = jbuckets.BucketLadder(min_bucket=3)
    for n in range(0, 70):
        assert BucketLadder(min_bucket=3).bucket(n) == jladder.bucket(n)
    assert BucketLadder(3).rungs(100) == jladder.rungs(100)
    rng = np.random.default_rng(0)
    limbs, key64, valid = _random_keys(rng, n=5, k=4, card=9)
    want_k, want_v = jbuckets.pad_probe_rows(limbs, valid, 8)
    # numpy uint64, numpy int64 bit patterns and an int64 tensor alike
    for keys in (key64, key64.view(np.int64), u64.from_numpy_u64(key64)):
        pk, pv = pad_probe_rows(keys, torch.from_numpy(valid), 8)
        assert pk.dtype == np.uint64 and pk.shape == (8, 4) and pv.shape == (8, 4)
        np.testing.assert_array_equal(pk[:5], key64)
        np.testing.assert_array_equal(pv[:5], valid)
        assert not pv[5:].any()
        assert (pk[5:] == np.uint64(0xFFFFFFFFFFFFFFFF)).all()
        np.testing.assert_array_equal(u64.to_limbs(u64.from_numpy_u64(pk)), want_k)
        np.testing.assert_array_equal(pv, want_v)
    pk, pv = pad_probe_rows(key64, valid, 5)
    np.testing.assert_array_equal(pk, key64)
    with pytest.raises(ValueError):
        pad_probe_rows(key64, valid, 4)


# ---------------------------------------------------------------------------
# lanes, backpressure, deadlines, fair share
# ---------------------------------------------------------------------------


def test_probes_never_stall_behind_ingest_queue():
    rng = np.random.default_rng(3)
    limbs, key64, valid = _random_keys(rng, n=200, k=6, card=20)
    twin = Twin(probe_slots=8, ingest_slots=32)
    twin.add_tenant("t")
    twin.submit_ingest("t", limbs[:64], key64[:64], valid[:64])
    twin.run()
    for off in range(64, 192, 32):   # 4 queued ledger syncs
        twin.submit_ingest("t", limbs[off:off + 32], key64[off:off + 32],
                           valid[off:off + 32])
    uid = twin.submit_probe("t", limbs[:4], key64[:4], valid[:4])
    twin.step()   # read lane served in the same step, not after the backlog
    assert any(r.uid == uid for r in twin.t.probe_responses)
    assert twin.t.queue_depths()["write"] > 0
    twin.assert_equal()
    twin.run()
    twin.assert_equal()


def test_backpressure_rejects_full_lanes():
    rng = np.random.default_rng(1)
    limbs, key64, valid = _random_keys(rng, n=40, k=6, card=12)
    twin = Twin(max_read_queue=2, max_write_queue=1)
    twin.add_tenant("t")
    twin.submit_ingest("t", limbs[:20], key64[:20], valid[:20])
    with pytest.raises(BackpressureError):
        twin.t.submit_ingest("t", key64[20:30], valid[20:30])
    with pytest.raises(jserving.BackpressureError):
        twin.j.submit_ingest("t", limbs[20:30], valid[20:30])
    twin.run()
    twin.submit_probe("t", limbs[:1], key64[:1], valid[:1])
    twin.submit_probe("t", limbs[1:2], key64[1:2], valid[1:2])
    with pytest.raises(BackpressureError):
        twin.t.submit_probe("t", key64[2:3], valid[2:3])
    with pytest.raises(jserving.BackpressureError):
        twin.j.submit_probe("t", limbs[2:3], valid[2:3])
    assert twin.t.snapshot()["counters"]["rejected_total"] == 2
    twin.run()
    assert all(r.status == "ok" for r in twin.t.probe_responses)
    twin.assert_equal()


def test_expired_probe_is_shed_with_explicit_response():
    rng = np.random.default_rng(2)
    limbs, key64, valid = _random_keys(rng, n=30, k=6, card=10)
    twin = Twin()
    twin.add_tenant("t")
    twin.submit_ingest("t", limbs[:20], key64[:20], valid[:20])
    twin.run()
    expired = twin.submit_probe("t", limbs[20:22], key64[20:22], valid[20:22],
                                deadline_s=-1.0)   # already past its deadline
    live = twin.submit_probe("t", limbs[22:24], key64[22:24], valid[22:24])
    twin.run()
    by_uid = {r.uid: r for r in twin.t.probe_responses}
    assert by_uid[expired].status == "expired"
    assert by_uid[expired].results == []
    assert by_uid[live].status == "ok" and len(by_uid[live].results) == 2
    counters = twin.t.snapshot()["counters"]
    assert counters["shed_total"] == 1
    assert counters["probe_requests_total"] == 1   # shed rows never walked
    twin.assert_equal()


def test_default_deadline_sheds_behind_a_slow_clock():
    """default_deadline_s applies when a probe names none: with the clock
    stepping 1 ms a read, a 2.5 ms deadline expires while queued behind
    another tenant's batch."""
    rng = np.random.default_rng(4)
    limbs, key64, valid = _random_keys(rng, n=40, k=6, card=10)
    twin = Twin(default_deadline_s=0.0025, probe_slots=4)
    for name in ("a", "b"):
        twin.add_tenant(name)
        twin.submit_ingest(name, limbs[:20], key64[:20], valid[:20])
    twin.run()
    for off in range(20, 36, 4):
        twin.submit_probe("a", limbs[off:off + 4], key64[off:off + 4],
                          valid[off:off + 4])
        twin.submit_probe("b", limbs[off:off + 4], key64[off:off + 4],
                          valid[off:off + 4], deadline_s=10.0)
    twin.run()
    statuses = [r.status for r in twin.t.probe_responses]
    assert "expired" in statuses and "ok" in statuses
    twin.assert_equal()


def test_tenant_isolation_and_fair_share():
    rng = np.random.default_rng(5)
    limbs, key64, valid = _random_keys(rng, n=120, k=6, card=15)
    twin = Twin(probe_slots=4)
    twin.add_tenant("a")
    twin.add_tenant("b")
    twin.submit_ingest("a", limbs[:50], key64[:50], valid[:50])
    twin.submit_ingest("b", limbs[50:100], key64[50:100], valid[50:100])
    twin.run()
    svc = twin.t
    assert svc.tenant("a").store.num_records == 50
    assert svc.tenant("b").store.num_records == 50
    ua = twin.submit_probe("a", limbs[:2], key64[:2], valid[:2])
    ub = twin.submit_probe("b", limbs[:2], key64[:2], valid[:2])
    for _ in range(6):   # flood a's read lane behind ua
        twin.submit_probe("a", limbs[:4], key64[:4], valid[:4])
    twin.step()
    twin.step()   # round-robin: b is served on the second step, not last
    done = {r.uid for r in svc.probe_responses}
    assert ua in done and ub in done
    # identical probe, isolated stores: answers come from each tenant's own
    # rows and match that tenant's solo blocker exactly
    by_uid = {r.uid: r for r in svc.probe_responses}
    for name, uid in (("a", ua), ("b", ub)):
        want = svc.tenant(name).blocker.query_keys(key64[:2], valid[:2])
        for qr, w in zip(by_uid[uid].results, want):
            _assert_result_equal(qr, w)
    twin.assert_equal()
    twin.run()
    twin.assert_equal()


def test_mixed_include_probe_modes_keep_fifo_and_split_batches():
    rng = np.random.default_rng(8)
    limbs, key64, valid = _random_keys(rng, n=60, k=6, card=12)
    twin = Twin(probe_slots=16)
    tenant = twin.add_tenant("t")
    twin.submit_ingest("t", limbs[:40], key64[:40], valid[:40])
    twin.run()
    u1 = twin.submit_probe("t", limbs[40:42], key64[40:42], valid[40:42],
                           include_probe=False)
    u2 = twin.submit_probe("t", limbs[42:44], key64[42:44], valid[42:44],
                           include_probe=True)
    u3 = twin.submit_probe("t", limbs[44:46], key64[44:46], valid[44:46],
                           include_probe=False)
    twin.run()
    by_uid = {r.uid: r for r in twin.t.probe_responses}
    for uid, off, mode in ((u1, 40, False), (u2, 42, True), (u3, 44, False)):
        want = tenant.blocker.query_keys(key64[off:off + 2], valid[off:off + 2],
                                         include_probe=mode)
        for qr, w in zip(by_uid[uid].results, want):
            _assert_result_equal(qr, w)
    # the head's mode picks the batch: u1 and u3 walk together, u2 alone
    assert [r.uid for r in twin.t.probe_responses] == [u1, u3, u2]
    assert twin.t.snapshot()["counters"]["probe_batches_total"] == 2
    twin.assert_equal()


def test_coalesced_ingests_split_first_rid():
    """Ingest requests coalesced into one batch share its report; each
    gets the rid of its own first row."""
    rng = np.random.default_rng(6)
    limbs, key64, valid = _random_keys(rng, n=70, k=6, card=14)
    twin = Twin(ingest_slots=32)
    twin.add_tenant("t")
    for lo, hi in ((0, 10), (10, 30), (30, 45), (45, 70)):
        twin.submit_ingest("t", limbs[lo:hi], key64[lo:hi], valid[lo:hi])
    twin.run()
    resp = twin.t.ingest_responses
    assert [(r.first_rid, r.num_rows) for r in resp] == [
        (0, 10), (10, 20), (30, 15), (45, 25)]
    assert resp[0].report is resp[1].report    # 10 + 20 rows in one batch
    assert resp[2].report is not resp[1].report
    twin.assert_equal()


@pytest.mark.parametrize("n_shards", [1, 4])
def test_snapshot_and_clusters_equal_reference(n_shards):
    """Two tenants (fingerprint-sharded stores at n_shards=4), both probe
    modes, shedding, a rejection and refresh_clusters: every response,
    latency and the snapshot equal the JAX service's, key for key."""
    rng = np.random.default_rng(11)
    limbs, key64, valid = _random_keys(rng, n=150, k=6, card=16)
    twin = Twin(n_shards=n_shards, probe_slots=8, max_read_queue=6)
    for name, lo in (("a", 0), ("b", 40)):
        twin.add_tenant(name)
        for off in range(lo, lo + 90, 30):
            twin.submit_ingest(name, limbs[off:off + 30], key64[off:off + 30],
                               valid[off:off + 30])
    twin.run()
    twin.refresh_clusters("a")
    for off in range(100, 130, 5):
        twin.submit_probe("a", limbs[off:off + 5], key64[off:off + 5],
                          valid[off:off + 5], include_probe=bool(off % 2))
    with pytest.raises(BackpressureError):
        twin.t.submit_probe("a", key64[:1], valid[:1])
    with pytest.raises(jserving.BackpressureError):
        twin.j.submit_probe("a", limbs[:1], valid[:1])
    twin.submit_probe("b", limbs[130:140], key64[130:140], valid[130:140],
                      deadline_s=-1.0)
    twin.submit_probe("b", limbs[140:150], key64[140:150], valid[140:150])
    twin.run()
    twin.refresh_clusters("b")
    snap = twin.t.snapshot()
    assert snap["gauges"]["store_shards"] == n_shards
    assert snap["gauges"]["clustered_tenants"] == 2
    assert snap["counters"]["shed_total"] == 1
    assert snap["counters"]["rejected_total"] == 1
    twin.assert_equal()


# ---------------------------------------------------------------------------
# metrics contract
# ---------------------------------------------------------------------------


def test_metrics_contract_and_bucket_ladder_stability():
    rng = np.random.default_rng(9)
    limbs, key64, valid = _random_keys(rng, n=100, k=6, card=15)
    twin = Twin(probe_slots=8, min_bucket=4)
    twin.add_tenant("t")
    twin.submit_ingest("t", limbs[:60], key64[:60], valid[:60])
    twin.run()
    for rep in range(5):
        lo, hi = 60 + 4 * rep, 64 + 4 * rep
        twin.submit_probe("t", limbs[lo:hi], key64[lo:hi], valid[lo:hi])
        twin.run()
    snap = twin.t.snapshot()
    counters = snap["counters"]
    assert counters["probe_requests_total"] == 5
    assert counters["probe_rows_total"] == 20
    assert counters["probe_batches_total"] == 5
    assert counters["ingest_rows_total"] == 60
    # one ladder rung (4 rows -> bucket 4), seen exactly once
    assert counters["bucket_compiles_total"] == 1
    lat = snap["histograms"]["probe_latency_s"]
    assert lat["count"] == 5
    assert 0 <= lat["min"] <= lat["p50"] <= lat["p90"] <= lat["p99"] <= lat["max"]
    occ = snap["histograms"]["batch_occupancy"]
    assert occ["count"] == 5 and occ["max"] == 1.0   # 4 rows in bucket 4
    gauges = snap["gauges"]
    assert gauges["read_queue_depth"] == 0
    assert gauges["write_queue_depth"] == 0
    assert gauges["tenants"] == 1
    twin.assert_equal()
    # walk shapes: repeating warmed shapes adds none
    shapes_after_warm = probe_jit_cache_sizes()
    assert all(v > 0 for v in shapes_after_warm.values())
    for rep in range(3):
        lo, hi = 80 + 4 * rep, 84 + 4 * rep
        twin.t.submit_probe("t", key64[lo:hi], valid[lo:hi])
        twin.t.run()
    assert probe_jit_cache_sizes() == shapes_after_warm
    assert twin.t.snapshot()["counters"]["bucket_compiles_total"] == 1
    # batch sizes 1..4 share the rung: still no new shape
    for b in (1, 2, 3):
        twin.t.submit_probe("t", key64[90:90 + b], valid[90:90 + b])
        twin.t.run()
    assert probe_jit_cache_sizes() == shapes_after_warm


def test_histogram_percentiles_and_reset():
    h = Histogram.log(1e-6, 100.0, per_decade=5)
    for v in (0.001, 0.001, 0.001, 0.001, 0.5):
        h.record(v)
    snap = h.snapshot()
    assert snap["count"] == 5
    assert snap["min"] == 0.001 and snap["max"] == 0.5
    assert 0.0005 <= snap["p50"] <= 0.002    # within the 0.001 bin
    assert snap["p99"] <= 0.5                # clamped to observed max
    h.reset()
    assert h.snapshot()["count"] == 0
    m = Metrics()
    m.counter("x").inc(3)
    m.histogram("y", kind="unit").record(0.5)
    m.reset()
    snap = m.snapshot(g=1)
    assert snap["counters"]["x"] == 0
    assert snap["histograms"]["y"]["count"] == 0
    assert snap["gauges"]["g"] == 1
    with pytest.raises(ValueError):
        Histogram([1.0, 1.0])


@pytest.mark.parametrize("kind", ["latency", "unit", "count"])
def test_metrics_snapshots_equal_reference(kind):
    """The same observations give the reference's snapshot, float for
    float, including under/overflow bins and percentiles after a reset."""
    rng = np.random.default_rng(len(kind))
    scale = {"latency": 1.0, "unit": 1.0, "count": 1e3}[kind]
    obs = np.concatenate([rng.lognormal(-4, 3, 300) * scale, [0.0, -1.0, 1e9]])
    got, want = Metrics(), jmetrics.Metrics()
    for m in (got, want):
        for i, x in enumerate(obs):
            m.histogram("h", kind=kind).record(x)
            m.counter("n").inc(i % 3)
    assert got.snapshot(depth=3) == want.snapshot(depth=3)
    for p in (0, 1, 37.5, 50, 90, 99, 100):
        assert got.histogram("h").percentile(p) == want.histogram("h").percentile(p)
    for m in (got, want):
        m.reset()
        m.histogram("h").record(0.25)
    assert got.snapshot() == want.snapshot()
    for lo, hi, n in ((0.5, 1e6, 4), (1e-6, 100.0, 5), (2.0, 3.0, 1)):
        assert Histogram.log(lo, hi, n).edges == jmetrics.Histogram.log(lo, hi, n).edges
        assert (Histogram.linear(lo, hi, n).edges
                == jmetrics.Histogram.linear(lo, hi, n).edges)


# ---------------------------------------------------------------------------
# shared collation + StreamingEngine satellites
# ---------------------------------------------------------------------------


def test_collate_fifo_skip_scan_fixes_head_of_line():
    queue = [("a", 40), ("b", 100), ("c", 10)]
    taken = collate_fifo(queue, 64, size_fn=lambda e: e[1],
                         group_fn=lambda e: e[0])
    assert [u for u, _ in taken] == ["a", "c"]   # c no longer waits on b
    assert [u for u, _ in queue] == ["b"]
    taken = collate_fifo(queue, 64, size_fn=lambda e: e[1],
                         group_fn=lambda e: e[0])
    assert [u for u, _ in taken] == ["b"]        # oversized head passes alone
    assert queue == []


def test_collate_fifo_preserves_per_group_order():
    queue = [("g", 60), ("g", 10), ("g", 2)]
    taken = collate_fifo(queue, 64, size_fn=lambda e: e[1],
                         group_fn=lambda e: e[0])
    # the 2 must not jump the skipped 10 from the same group
    assert taken == [("g", 60)]
    assert queue == [("g", 10), ("g", 2)]


@dataclasses.dataclass
class _FakeBatch:
    num_records: int


def test_streaming_engine_pad_batch_skip_scan():
    eng = StreamingEngine({}, hdb.HDBConfig(**_CFG), ingest_slots=64, device="cpu")
    u1 = eng.submit_ingest(_FakeBatch(40))
    u2 = eng.submit_ingest(_FakeBatch(100))
    u3 = eng.submit_ingest(_FakeBatch(10))
    taken = eng._pad_batch(eng._ingest_queue, eng.ingest_slots)
    assert [u for u, _ in taken] == [u1, u3]
    taken = eng._pad_batch(eng._ingest_queue, eng.ingest_slots)
    assert [u for u, _ in taken] == [u2]
    assert eng.queue_depth == 0


def test_streaming_engine_run_warns_on_truncated_drain():
    corpus = synthetic.generate(synthetic.SyntheticSpec(num_entities=30, seed=3),
                                device="cpu")
    cfg = hdb.HDBConfig(max_block_size=20, max_iterations=4, cms_width=1 << 10)
    eng = StreamingEngine(corpus.blocking, cfg, ingest_slots=8, device="cpu")
    n = min(corpus.num_records, 24)
    for part in np.array_split(np.arange(n), 3):
        eng.submit_ingest(RecordBatch.from_corpus(corpus, part))
    with pytest.warns(RuntimeWarning, match="still queued"):
        eng.run(max_steps=1)
    assert eng.busy and eng.queue_depth == 2
    ingests, _ = eng.run()   # finishing drain: no warning, queue empty
    assert eng.queue_depth == 0 and not eng.busy
    assert sum(len(r.uids) for r in ingests) == 3
    assert eng.store.num_records == n


def test_service_run_warns_on_truncated_drain_and_needs_a_device(monkeypatch):
    rng = np.random.default_rng(12)
    limbs, key64, valid = _random_keys(rng, n=30, k=6, card=10)
    svc = DedupeService(hdb.HDBConfig(**_CFG), ServiceConfig(ingest_slots=10),
                        device="cpu")
    for off in range(0, 30, 10):
        svc.submit_ingest("t", key64[off:off + 10], valid[off:off + 10])
    with pytest.warns(RuntimeWarning, match="still queued"):
        svc.run(max_steps=1)
    svc.run()
    assert svc.tenant("t").store.num_records == 30
    assert svc.tenant("t").store.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DedupeService(hdb.HDBConfig(**_CFG))


def test_serving_smoke_is_deterministic_and_sharding_invariant():
    """The smoke scenario the card test holds cuda to cpu with: two runs
    agree in everything, and 4 shards answer as 1 shard does (only the
    shard gauges of the snapshot differ)."""
    from repro_torch.serving import smoke
    one = smoke.service_run("cpu", 1)
    assert smoke.differing(one, smoke.service_run("cpu", 1)) == []
    four = smoke.service_run("cpu", 4)
    assert smoke.differing(one, four) == ["snapshot"]
    assert four["snapshot"]["gauges"]["store_shards"] == 4
    assert {r[2] for r in one["probes"]} == {"ok", "expired"}
    assert sum(len(c[0]) for _, _, _, _, res in one["probes"] for c in res) > 0
    assert one["snapshot"]["counters"]["cluster_refreshes_total"] == 2
