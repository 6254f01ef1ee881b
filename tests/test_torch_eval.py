"""Port parity: the paper's evaluation (enumerate_pairs, the pair bitmap,
pair_covered, lsh_probability, the Jaccard corpus, is_duplicate,
metrics.evaluate) and Parallel Meta-blocking.

The same numpy inputs, made from fixed seeds, go through the JAX package
and the port on the CPU (``device="cpu"``, the kernels' plain versions).
Tolerance: 0 -- every array bit-identical, every float equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_pairs_engine import _random_blocks  # noqa: E402

from repro.core import baselines as jbase  # noqa: E402
from repro.core import blocks as jblocks  # noqa: E402
from repro.core import hdb as jhdb  # noqa: E402
from repro.core import metablocking as jmeta  # noqa: E402
from repro.core import minhash as jminhash  # noqa: E402
from repro.core import pairs as jpairs  # noqa: E402
from repro.data import metrics as jmetrics  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import pairs as jpk  # noqa: E402
from repro_torch.core import baselines, blocks, hdb, metablocking, minhash, pairs  # noqa: E402
from repro_torch.data import metrics, synthetic  # noqa: E402
from repro_torch.kernels import pairs as pk  # noqa: E402


def _port_blocks(blk):
    return pairs.Blocks(blk.key_hi, blk.key_lo, blk.start, blk.size, blk.members)


def _assert_same_chunks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert x.dtype == y.dtype == np.int64
            assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# enumerate_pairs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk_pairs", [1024, 2048, 1 << 20])
def test_enumerate_pairs_chunks_equal_reference_device_order(chunk_pairs):
    blk = _random_blocks(5, 20, 20, universe=200)
    want = list(jpairs.enumerate_pairs(blk, backend="jax", chunk_pairs=chunk_pairs))
    got = list(pairs.enumerate_pairs(_port_blocks(blk), chunk_pairs=chunk_pairs,
                                     device="cpu"))
    _assert_same_chunks(got, want)
    assert sum(len(c[0]) for c in got) == blk.num_pair_slots


@pytest.mark.parametrize("chunk_pairs", [64, 2048])
def test_enumerate_pairs_numpy_stream_equals_reference(chunk_pairs):
    # sizes up to 80 take both of iter_block_pairs' paths (shift and triu)
    blk = _random_blocks(6, 30, 80, universe=300)
    want = list(jpairs.enumerate_pairs(blk, backend="numpy", chunk_pairs=chunk_pairs))
    got = list(pairs.enumerate_pairs(_port_blocks(blk), backend="numpy",
                                     chunk_pairs=chunk_pairs))
    _assert_same_chunks(got, want)


def test_enumerate_pairs_empty_blocks():
    z64, zu = np.zeros((0,), np.int64), np.zeros((0,), np.uint32)
    assert list(jpairs.enumerate_pairs(jpairs.Blocks(zu, zu, z64, z64, z64),
                                       backend="jax")) == []
    for backend in ("auto", "numpy"):
        assert list(pairs.enumerate_pairs(pairs.Blocks(zu, zu, z64, z64, z64),
                                          backend=backend, device="cpu")) == []


def test_enumerate_pairs_beyond_max_block_n_warns_and_streams_numpy(monkeypatch):
    """A block set outside the int32 contract takes the numpy stream with a
    warning in both packages. The contract's block-size bound is lowered
    in both (a real MAX_BLOCK_N + 1 block holds 2**31 slots)."""
    blk = _random_blocks(7, 12, 40, universe=200)
    monkeypatch.setattr(jpk, "MAX_BLOCK_N", 24)
    monkeypatch.setattr(pk, "MAX_BLOCK_N", 24)
    with pytest.warns(RuntimeWarning, match="MAX_BLOCK_N"):
        want = list(jpairs.enumerate_pairs(blk, backend="jax", chunk_pairs=256))
    with pytest.warns(RuntimeWarning, match="MAX_BLOCK_N"):
        got = list(pairs.enumerate_pairs(_port_blocks(blk), chunk_pairs=256,
                                         device="cpu"))
    _assert_same_chunks(got, want)
    assert sum(len(c[0]) for c in got) == blk.num_pair_slots


def test_enumerate_pairs_big_rids_warn_and_stream_numpy():
    blk = _random_blocks(8, 6, 10, universe=100)
    big = jpairs.Blocks(blk.key_hi, blk.key_lo, blk.start, blk.size,
                        blk.members + (1 << 31))
    with pytest.warns(RuntimeWarning, match="int32"):
        want = list(jpairs.enumerate_pairs(big, backend="jax"))
    with pytest.warns(RuntimeWarning, match="int32"):
        got = list(pairs.enumerate_pairs(_port_blocks(big), device="cpu"))
    _assert_same_chunks(got, want)


@pytest.mark.parametrize("backend", ["distributed", "jax", "pallas"])
def test_enumerate_pairs_rejects_backends(backend):
    blk = _port_blocks(_random_blocks(5, 4, 6, universe=50))
    with pytest.raises(ValueError):
        next(pairs.enumerate_pairs(blk, backend=backend, device="cpu"))


# ---------------------------------------------------------------------------
# the pair bitmap
# ---------------------------------------------------------------------------


def test_pair_bitmap_roundtrip_equals_reference():
    n = 23
    rng = np.random.default_rng(1)
    ii, jj = np.triu_indices(n, 1)
    keep = rng.random(len(ii)) < 0.3
    bm = pairs.build_pair_bitmap(n, ii[keep], jj[keep])
    assert np.array_equal(bm, jpairs.build_pair_bitmap(n, ii[keep], jj[keep]))
    gi, gj = pairs.read_pair_bitmap(n, bm)
    wi, wj = jpairs.read_pair_bitmap(n, bm)
    assert np.array_equal(gi, wi) and np.array_equal(gj, wj)
    assert np.array_equal(gi, ii[keep]) and np.array_equal(gj, jj[keep])


def test_pair_bit_index_equals_reference():
    n = 17
    ii, jj = np.triu_indices(n, 1)
    idx = pairs.pair_bit_index(ii, jj, n)
    assert np.array_equal(idx, jpairs.pair_bit_index(ii, jj, n))
    assert np.array_equal(idx, np.arange(n * (n - 1) // 2))
    for got, want in zip(pairs.pair_from_bit_index(idx, n),
                         jpairs.pair_from_bit_index(idx, n)):
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# corpora: HDB results, labels, ground truth
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    """test_metablocking's corpus in both packages, with both key sets."""
    spec = dict(num_entities=1500, seed=9)
    jc = jsyn.generate(jsyn.SyntheticSpec(**spec))
    tc = synthetic.generate(synthetic.SyntheticSpec(**spec), device="cpu")
    jk, jv = jblocks.build_keys(jc.columns, jc.blocking)
    tk, tv = blocks.build_keys(tc.columns, tc.blocking)
    return jc, tc, (jk, jv), (tk, tv)


@pytest.fixture(scope="module")
def results(built):
    """THR, HDB and PMB results of both packages on the same keys."""
    jc, tc, (jk, jv), (tk, tv) = built
    jcfg = jhdb.HDBConfig(max_block_size=40)
    tcfg = hdb.HDBConfig(max_block_size=40)
    return {
        "THR": (jbase.threshold_blocking(jk, jv, 40),
                baselines.threshold_blocking(tk, tv, 40, device="cpu")),
        "HDB": (jhdb.hashed_dynamic_blocking(jk, jv, jcfg),
                hdb.hashed_dynamic_blocking(tk, tv, tcfg, device="cpu")),
        "PMB": (jmeta.meta_blocking_result(jk, jv),
                metablocking.meta_blocking_result(tk, tv, device="cpu")),
    }


def test_is_duplicate_and_labels_equal_reference(built):
    jc, tc, _, _ = built
    assert np.array_equal(tc.entity_id, jc.entity_id)
    la, lb = tc.labeled_pairs()
    rng = np.random.default_rng(3)
    a = rng.integers(0, tc.num_records, 5000)
    b = rng.integers(0, tc.num_records, 5000)
    for x, y in ((la, lb), (a, b)):
        got = tc.is_duplicate(x, y)
        assert got.dtype == bool and np.array_equal(got, jc.is_duplicate(x, y))
    assert tc.is_duplicate(la, lb).all()


@pytest.mark.parametrize("method", ["THR", "HDB", "PMB"])
def test_pair_covered_equals_reference(built, results, method):
    jc, tc, _, _ = built
    jres, tres = results[method]
    la, lb = jc.labeled_pairs()
    rng = np.random.default_rng(4)
    # labelled pairs, random pairs (mostly in no block), a == b, and
    # pairs of records absent from every block
    ra = rng.integers(0, tc.num_records, 3000)
    rb = rng.integers(0, tc.num_records, 3000)
    absent = np.setdiff1d(np.arange(tc.num_records), jres.rids)[:5]
    qa = np.concatenate([la, ra, ra[:50], absent, la[:5]])
    qb = np.concatenate([lb, rb, ra[:50], lb[:5], absent])
    want = jpairs.pair_covered(jres, qa, qb)
    got = pairs.pair_covered(tres, qa, qb, device="cpu")
    assert got.dtype == bool and np.array_equal(got, want)
    assert want.any() and not want.all()


def test_pair_covered_empty_inputs(results):
    jres, tres = results["HDB"]
    z = np.zeros((0,), np.int64)
    assert pairs.pair_covered(tres, z, z, device="cpu").shape == (0,)
    empty = hdb.BlockingResult(z, np.zeros((0,), np.uint32), np.zeros((0,), np.uint32),
                               [], 10)
    got = pairs.pair_covered(empty, np.array([0, 1]), np.array([1, 2]), device="cpu")
    want = jpairs.pair_covered(jhdb.BlockingResult(z, empty.key_hi, empty.key_lo, [], 10),
                               np.array([0, 1]), np.array([1, 2]))
    assert np.array_equal(got, want) and not got.any()


# ---------------------------------------------------------------------------
# the LSH curve and its corpus
# ---------------------------------------------------------------------------


def test_lsh_probability_bits_equal_reference():
    j = np.linspace(0.0, 1.0, 4097, dtype=np.float32)
    for bands in (1, 2, 6, 10, 33):
        for rows in (0, 1, 3, 4, 8, 13):
            want = np.asarray(jminhash.lsh_probability(bands, rows, j))
            got = minhash.lsh_probability(bands, rows, torch.from_numpy(j))
            assert got.dtype == torch.float32
            assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    scalar = minhash.lsh_probability(6, 4, 0.5, device="cpu")
    assert scalar.item() == float(jminhash.lsh_probability(6, 4, 0.5))


@pytest.mark.parametrize("jaccard,set_size,seed", [(0.0, 40, 0), (0.3, 40, 1),
                                                   (0.8, 16, 2), (1.0, 10, 3)])
def test_jaccard_pair_corpus_equals_reference(jaccard, set_size, seed):
    got = synthetic.jaccard_pair_corpus(50, jaccard, set_size, seed)
    want = jsyn.jaccard_pair_corpus(50, jaccard, set_size, seed)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[0].dtype == np.uint32 and got[2] == want[2]


# ---------------------------------------------------------------------------
# metrics.evaluate (paper Table 2's PQ / PC)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["THR", "HDB", "PMB"])
@pytest.mark.parametrize("pair_budget", [30_000_000, 700])
def test_evaluate_equals_reference(built, results, method, pair_budget):
    jc, tc, _, _ = built
    jres, tres = results[method]
    labeled = jc.labeled_pairs()
    want = jmetrics.evaluate(jres, jc, labeled, pair_budget=pair_budget)
    got = metrics.evaluate(tres, tc, labeled, pair_budget=pair_budget, device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row(method) == want.row(method)
    assert got.exact_pairs == (pair_budget > 700)
    assert 0 < got.pq <= 1 and 0 < got.pc <= 1


def test_evaluate_defaults_to_all_labels(built, results):
    jc, tc, _, _ = built
    jres, tres = results["HDB"]
    got = metrics.evaluate(tres, tc, device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(jmetrics.evaluate(jres, jc))


# ---------------------------------------------------------------------------
# Parallel Meta-blocking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["auto", "numpy"])
@pytest.mark.parametrize("cfg", [{}, {"filter_ratio": 1.0},
                                 {"purge_block_size": 30, "min_block_size": 3}])
def test_meta_blocking_equals_reference(built, backend, cfg):
    _, _, (jk, jv), (tk, tv) = built
    wa, wb = jmeta.meta_blocking(jk, jv, jmeta.MetaBlockingConfig(**cfg))
    ga, gb = metablocking.meta_blocking(
        tk, tv, metablocking.MetaBlockingConfig(pairs_backend=backend, **cfg),
        device="cpu")
    assert ga.dtype == np.int64 and np.array_equal(ga, wa) and np.array_equal(gb, wb)
    assert len(ga) > 0 and (ga < gb).all()


def test_meta_blocking_result_equals_reference(results):
    jres, tres = results["PMB"]
    for f in ("rids", "key_hi", "key_lo"):
        assert np.array_equal(getattr(tres, f), getattr(jres, f)), f
    assert [vars(s) for s in tres.stats] == [vars(s) for s in jres.stats]
    assert tres.num_records == jres.num_records


def test_meta_blocking_budget_error_equals_reference():
    spec = dict(num_entities=800, seed=4)
    jc = jsyn.generate(jsyn.SyntheticSpec(**spec))
    tc = synthetic.generate(synthetic.SyntheticSpec(**spec), device="cpu")
    jk, jv = jblocks.build_keys(jc.columns, jc.blocking)
    tk, tv = blocks.build_keys(tc.columns, tc.blocking)
    with pytest.raises(jmeta.MetaBlockingBudgetError) as want:
        jmeta.meta_blocking(jk, jv, jmeta.MetaBlockingConfig(edge_budget=10))
    with pytest.raises(metablocking.MetaBlockingBudgetError) as got:
        metablocking.meta_blocking(tk, tv, metablocking.MetaBlockingConfig(edge_budget=10),
                                   device="cpu")
    assert str(got.value) == str(want.value)


def test_meta_blocking_empty_keys():
    keys = torch.zeros((4, 3), dtype=torch.int64)
    valid = torch.zeros((4, 3), dtype=torch.bool)
    a, b = metablocking.meta_blocking(keys, valid, device="cpu")
    wa, wb = jmeta.meta_blocking(jnp.zeros((4, 3, 2), jnp.uint32),
                                 jnp.zeros((4, 3), bool))
    assert len(a) == len(b) == len(wa) == len(wb) == 0


@pytest.mark.parametrize("backend", ["jnp", "jax", "pallas", "distributed"])
def test_meta_blocking_rejects_reference_only_backends(backend):
    with pytest.raises(ValueError):
        metablocking.MetaBlockingConfig(pairs_backend=backend)

