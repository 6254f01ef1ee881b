"""Port parity: HDB (CMS, segments, rep dedupe, intersection, driver).

Corpora and keys are made from fixed seeds and given to both packages.
Tolerance: exact equality of every rid, key, mask, size and statistic.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jbase  # noqa: E402
from repro.core import blocks as jblocks  # noqa: E402
from repro.core import hdb as jhdb  # noqa: E402
from repro.core import oracle as joracle  # noqa: E402
from repro.core import segments as jseg  # noqa: E402
from repro.core import sketches as jsk  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import baselines, blocks, hdb, segments, sketches, u64  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

CORPORA = {
    "smoke": (dict(num_entities=150, seed=7),
              dict(max_block_size=50, max_iterations=6, cms_width=1 << 12)),
    "deep": (dict(num_entities=1200, seed=5),
             dict(max_block_size=12, max_iterations=8, cms_width=1 << 12,
                  max_oversize_keys=6)),
}


def _keys(spec):
    jc = jsyn.generate(jsyn.SyntheticSpec(**spec))
    tc = synthetic.generate(synthetic.SyntheticSpec(**spec), device="cpu")
    jk, jv = jblocks.build_keys(jc.columns, jc.blocking)
    tk, tv = blocks.build_keys(tc.columns, tc.blocking)
    return (jk, jv), (tk, tv)


def _limbs(t):
    return tuple(np.moveaxis(u64.to_limbs(t), -1, 0))


def _assert_same_result(jr, tr):
    assert [vars(s) for s in tr.stats] == [vars(s) for s in jr.stats]
    for field in ("rids", "key_hi", "key_lo"):
        assert np.array_equal(getattr(tr, field), getattr(jr, field)), field
    assert tr.num_records == jr.num_records


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_blocking_result_and_stats_bit_identical(name):
    spec, cfg = CORPORA[name]
    (jk, jv), (tk, tv) = _keys(spec)
    jr = jhdb.hashed_dynamic_blocking(jk, jv, jhdb.HDBConfig(**cfg))
    tr = hdb.hashed_dynamic_blocking(tk, tv, hdb.HDBConfig(**cfg), device="cpu")
    _assert_same_result(jr, tr)
    assert len(tr.stats) >= 2 and len(tr.rids) > 0


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_threshold_blocking_bit_identical(name):
    spec, cfg = CORPORA[name]
    (jk, jv), (tk, tv) = _keys(spec)
    jr = jbase.threshold_blocking(jk, jv, cfg["max_block_size"])
    tr = baselines.threshold_blocking(tk, tv, cfg["max_block_size"], device="cpu")
    _assert_same_result(jr, tr)
    assert 0 < len(tr.rids) < int(tv.sum())


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_naive_pair_count_bit_identical(name):
    spec, _ = CORPORA[name]
    (jk, jv), (tk, tv) = _keys(spec)
    got = baselines.naive_pair_count(tk, tv, device="cpu")
    assert got == jbase.naive_pair_count(jk, jv) > 0


def test_rep_capacity_warning_fires_at_the_same_iteration():
    spec, cfg = CORPORA["deep"]
    cfg = dict(cfg, rep_capacity=4)
    (jk, jv), (tk, tv) = _keys(spec)
    with pytest.warns(jhdb.RepCapacityWarning) as jw:
        jr = jhdb.hashed_dynamic_blocking(jk, jv, jhdb.HDBConfig(**cfg))
    with pytest.warns(hdb.RepCapacityWarning) as tw:
        tr = hdb.hashed_dynamic_blocking(tk, tv, hdb.HDBConfig(**cfg), device="cpu")
    _assert_same_result(jr, tr)
    assert len(tw) == len(jw) > 0
    assert tr.rep_overflow_total == jr.rep_overflow_total > 0


def test_cms_build_and_query_bit_identical():
    rng = np.random.default_rng(3)
    v = rng.integers(0, 1 << 63, 4000, dtype=np.uint64) * np.uint64(2)
    v = v[rng.integers(0, 400, 4000)]            # heavy duplicates
    mask = rng.random(4000) < 0.9
    key = u64.from_numpy_u64(v)
    jkey = _limbs(key)
    cfg_j, cfg_t = jsk.CMSConfig(4, 1 << 10), sketches.CMSConfig(4, 1 << 10)
    js = jsk.cms_build(cfg_j, jkey, jnp.asarray(mask))
    ts = sketches.cms_build(cfg_t, key, torch.from_numpy(mask))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(sketches.cms_indices(cfg_t, key).numpy(),
                          np.asarray(jsk.cms_indices(cfg_j, jkey)))
    assert np.array_equal(sketches.cms_query(cfg_t, ts, key).numpy(),
                          np.asarray(jsk.cms_query(cfg_j, js, jkey)))


def test_segment_counts_and_xor_bit_identical():
    rng = np.random.default_rng(4)
    v = np.sort(rng.integers(0, 30, 200).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
    v[-10:] = np.uint64((1 << 64) - 1)           # sentinel tail
    key = u64.from_numpy_u64(np.sort(v))
    val = u64.from_numpy_u64(rng.integers(0, 1 << 63, 200, dtype=np.uint64))
    jkey, jval = _limbs(key), _limbs(val)
    assert np.array_equal(segments.segment_counts(key).numpy(),
                          np.asarray(jax.jit(jseg.segment_counts)(jkey)))
    got = _limbs(segments.segment_xor(key, val))
    want = jax.jit(jseg.segment_xor)(jkey, jval)
    assert all(np.array_equal(g, np.asarray(w)) for g, w in zip(got, want))
    table = key.unique_consecutive()
    hit, vals = segments.lookup_u64(table, torch.arange(table.shape[0]), val[:100], -1)
    jhit, jvals = jseg.lookup_u64(_limbs(table), jnp.arange(table.shape[0]),
                                  _limbs(val[:100]), -1)
    assert np.array_equal(hit.numpy(), np.asarray(jhit))
    assert np.array_equal(vals.numpy(), np.asarray(jvals))


def test_dedupe_oversized_reps_bit_identical():
    rng = np.random.default_rng(5)
    m = 600
    x = rng.integers(0, 40, m).astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9)
    sz = rng.integers(51, 55, m).astype(np.int32)
    k = rng.permutation(m).astype(np.uint64) * np.uint64(0x94D049BB133111EB) + np.uint64(1)
    k[-25:] = np.uint64((1 << 64) - 1)           # invalid lanes
    sz[-25:] = np.iinfo(np.int32).max
    x[-25:] = np.uint64((1 << 64) - 1)
    tx, tk = u64.from_numpy_u64(x), u64.from_numpy_u64(k)
    (t_k, t_sz), n_dup, surv = hdb.dedupe_oversized_reps(tx, torch.from_numpy(sz), tk)
    (jtk, jtsz), jn_dup, jsurv = jhdb.dedupe_oversized_reps(
        *_limbs(tx), jnp.asarray(sz), *_limbs(tk))
    assert int(n_dup) == int(jn_dup) > 0
    assert np.array_equal(surv.numpy(), np.asarray(jsurv))
    assert np.array_equal(u64.to_limbs(t_k), np.stack([np.asarray(a) for a in jtk], -1))
    assert np.array_equal(t_sz.numpy(), np.asarray(jtsz))


def test_intersect_keys_bit_identical():
    rng = np.random.default_rng(6)
    n, k = 200, 9
    v = rng.integers(0, 60, (n, k)).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    key = u64.from_numpy_u64(v)
    survive = rng.random((n, k)) < 0.7
    survive[:5] = True                             # rows past max_keys
    size = rng.integers(10, 20, (n, k)).astype(np.int32)
    cfg = dict(max_oversize_keys=5, max_keys=8)
    tk, tv, tp, tdead = hdb.intersect_keys(hdb.HDBConfig(**cfg), key,
                                           torch.from_numpy(survive),
                                           torch.from_numpy(size))
    (jkh, jkl), jv, jp, jdead = jhdb.intersect_keys(
        jhdb.HDBConfig(**cfg), _limbs(key), jnp.asarray(survive), jnp.asarray(size))
    assert np.array_equal(u64.to_limbs(tk), np.stack([np.asarray(jkh), np.asarray(jkl)], -1))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    # psize carries meaning on valid lanes only
    assert np.array_equal(tp.numpy()[tv.numpy()], np.asarray(jp)[np.asarray(jv)])
    assert int(tdead) == int(jdead) >= 5


def test_rough_classify_float32_boundary():
    cfg = hdb.HDBConfig(max_block_size=10)
    s = torch.tensor([10, 11, 90, 91, 900, 2**31 - 1], dtype=torch.int32)
    psize = torch.tensor([20, 20, 100, 100, 1000, 2**31 - 1], dtype=torch.int32)
    valid = torch.ones(6, dtype=torch.bool)
    got = hdb.rough_classify(cfg, s, valid, psize)
    want = jhdb.rough_classify(jhdb.HDBConfig(max_block_size=10), jnp.asarray(s.numpy()),
                               jnp.asarray(valid.numpy()), jnp.asarray(psize.numpy()))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_no_warning_without_overflow():
    spec, cfg = CORPORA["smoke"]
    _, (tk, tv) = _keys(spec)
    with warnings.catch_warnings():
        warnings.simplefilter("error", hdb.RepCapacityWarning)
        tr = hdb.hashed_dynamic_blocking(tk, tv, hdb.HDBConfig(**cfg), device="cpu")
    assert tr.rep_overflow_total == 0


# ---------------------------------------------------------------------------
# max_oversize_keys <= 2: the reference raises once an iteration starts with
# a zero-column key matrix (``src/repro/core/hdb.py:229``, ROADMAP Queue C),
# so the port is held to the independent oracle instead (the oracle counts
# exactly, so the port runs it at a width where the sketch does not
# over-count)
# ---------------------------------------------------------------------------


def _oracle_accepted(keys, valid, cfg):
    k64 = u64.to_numpy_u64(keys)
    v = valid.numpy()
    record_keys = [set(int(x) for x in k64[r][v[r]]) for r in range(v.shape[0])]
    ocfg = jhdb.HDBConfig(**dict(cfg, cms_width=1 << 20))
    return joracle.oracle_hdb(record_keys, ocfg)


@pytest.mark.parametrize("max_oversize_keys", [1, 2])
def test_few_oversize_keys_batch_matches_oracle(max_oversize_keys):
    tc = synthetic.generate(synthetic.SyntheticSpec(num_entities=600, seed=11),
                            device="cpu")
    tk, tv = blocks.build_keys(tc.columns, tc.blocking)
    cfg = dict(max_block_size=5, max_oversize_keys=max_oversize_keys, cms_width=1 << 12)
    tr = hdb.hashed_dynamic_blocking(tk, tv, hdb.HDBConfig(**cfg), device="cpu")
    key64 = (tr.key_hi.astype(np.uint64) << np.uint64(32)) | tr.key_lo.astype(np.uint64)
    got = set(zip(tr.rids.tolist(), (int(k) for k in key64)))
    want = _oracle_accepted(tk, tv, cfg)
    assert got == want and len(want) > 0
    assert len(tr.rids) == len(got)


@pytest.mark.parametrize("max_oversize_keys", [1, 2])
def test_few_oversize_keys_streaming_matches_oracle(max_oversize_keys):
    from repro_torch.streaming import BlockStore, DeltaBlocker
    tc = synthetic.generate(synthetic.SyntheticSpec(num_entities=600, seed=11),
                            device="cpu")
    tk, tv = blocks.build_keys(tc.columns, tc.blocking)
    cfg = dict(max_block_size=5, max_oversize_keys=max_oversize_keys, cms_width=1 << 12)
    store = BlockStore(hdb.HDBConfig(**cfg), device="cpu")
    blk = DeltaBlocker(store)
    for part in np.array_split(np.arange(tc.num_records), 3):
        idx = torch.from_numpy(part)
        blk.ingest_keys(tk[idx], tv[idx])
    csr = store.accepted_blocks(min_size=1)
    key64 = (csr.key_hi.astype(np.uint64) << np.uint64(32)) | csr.key_lo.astype(np.uint64)
    got = set(zip(csr.members.tolist(), (int(k) for k in np.repeat(key64, csr.size))))
    assert got == _oracle_accepted(tk, tv, cfg)
    assert len(csr.members) == len(got) > 0
    # the reference's streaming path does not raise here: its store agrees
    from repro.streaming import BlockStore as JBlockStore
    from repro.streaming import DeltaBlocker as JDeltaBlocker
    jstore = JBlockStore(jhdb.HDBConfig(**cfg))
    jblk = JDeltaBlocker(jstore)
    limbs, valid = u64.to_limbs(tk), tv.numpy()
    for part in np.array_split(np.arange(tc.num_records), 3):
        jblk.ingest_keys(limbs[part], valid[part])
    want = jstore.accepted_blocks(1)
    for f in ("key_hi", "key_lo", "start", "size", "members"):
        assert np.array_equal(getattr(csr, f), getattr(want, f)), f
    assert np.array_equal(store.led_pack, jstore.led_pack)
