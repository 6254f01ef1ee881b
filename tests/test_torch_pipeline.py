"""Port parity: the whole slice (keys -> HDB -> pairs -> match -> clusters).

At the ``examples/fused_dedup.py --smoke`` config the port's
``dedup_corpus`` (fused and host back ends, on the CPU; ``blocker="hdb"``
and ``"threshold"``) is held against
``repro.data.pipeline.dedup_corpus(match_backend="pallas")``; clustering
is also held against the union-find oracle. Inputs come from fixed
seeds. Tolerance: exact equality of every label, survivor and count.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import hdb as jhdb  # noqa: E402
from repro.data import components as jcomp  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import baselines, blocks, hdb, pairs  # noqa: E402
from repro_torch.data import components, matcher, pipeline, synthetic  # noqa: E402

SMOKE_SPEC = dict(num_entities=150, seed=7)
SMOKE_CFG = dict(max_block_size=50, max_iterations=6, cms_width=1 << 12)


@pytest.fixture(scope="module")
def smoke():
    jc = jsyn.generate(jsyn.SyntheticSpec(**SMOKE_SPEC))
    jrep = jpipe.dedup_corpus(jc, jhdb.HDBConfig(**SMOKE_CFG), match_backend="pallas")
    tc = synthetic.generate(synthetic.SyntheticSpec(**SMOKE_SPEC), device="cpu")
    return jc, jrep, tc


@pytest.mark.parametrize("backend", ["auto", "host"])
def test_smoke_pipeline_matches_reference(smoke, backend):
    jc, jrep, tc = smoke
    rep = pipeline.dedup_corpus(tc, hdb.HDBConfig(**SMOKE_CFG),
                                match_backend=backend, device="cpu")
    assert np.array_equal(rep.component_of, jrep.component_of)
    assert np.array_equal(rep.survivors, jrep.survivors)
    for field in ("num_records", "num_candidate_pairs", "num_matched_pairs",
                  "num_components", "num_survivors"):
        assert getattr(rep, field) == getattr(jrep, field), field
    assert rep.num_matched_pairs > 0 and rep.num_components < rep.num_records
    assert pipeline.dedup_quality(rep, tc) == jpipe.dedup_quality(jrep, jc)


def test_fused_and_host_back_ends_agree(smoke):
    _, _, tc = smoke
    cfg = hdb.HDBConfig(**SMOKE_CFG)
    fused = pipeline.dedup_corpus(tc, cfg, device="cpu")
    host = pipeline.dedup_corpus(tc, cfg, match_backend="host", device="cpu")
    assert fused.num_matched_pairs == host.num_matched_pairs
    assert np.array_equal(fused.component_of, host.component_of)
    assert np.array_equal(fused.survivors, host.survivors)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_components_match_oracle_and_reference(seed):
    rng = np.random.default_rng(seed)
    n = 400
    a = rng.integers(0, n, 300)
    b = rng.integers(0, n, 300)
    # a shuffled chain: long diameter, converges only by root hooking
    chain = rng.permutation(n)[:120]
    a = np.concatenate([a, chain[:-1]])
    b = np.concatenate([b, chain[1:]])
    want = components.connected_components_oracle(n, a, b)
    assert np.array_equal(want, jcomp.connected_components_oracle(n, a, b))
    got = components.connected_components(n, a, b, device="cpu")
    assert np.array_equal(got, want)
    assert np.array_equal(got, jcomp.connected_components(n, a, b))
    pad = np.zeros(64, np.int32)                  # (0, 0) padding is a no-op
    label, surv, n_surv, converged, rounds = components.cluster_pairs_device(
        n, torch.from_numpy(np.concatenate([a, pad]).astype(np.int32)),
        torch.from_numpy(np.concatenate([b, pad]).astype(np.int32)), device="cpu")
    assert converged and 0 < rounds < 64
    assert label.shape[0] == n and surv.shape[0] == n_surv
    assert np.array_equal(label.numpy(), want)
    assert np.array_equal(surv.numpy(), np.unique(want))


def test_components_truncation_warns():
    n = 300
    chain = np.random.default_rng(3).permutation(n)
    with pytest.warns(RuntimeWarning, match="max_rounds"):
        components.connected_components(n, chain[:-1], chain[1:], max_rounds=1,
                                        device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        components.connected_components(n, chain[:-1], chain[1:], device="cpu")


ENTRY_POINTS = {
    "generate": lambda: synthetic.generate(synthetic.SyntheticSpec(num_entities=5)),
    "dedup_corpus": lambda: pipeline.dedup_corpus(
        synthetic.generate(synthetic.SyntheticSpec(num_entities=5), device="cpu")),
    "hashed_dynamic_blocking": lambda: hdb.hashed_dynamic_blocking(
        torch.zeros((2, 1), dtype=torch.int64), torch.ones((2, 1), dtype=torch.bool)),
    "dedupe_pairs": lambda: pairs.dedupe_pairs(pairs.Blocks(
        *(np.zeros((0,), t) for t in (np.uint32, np.uint32, np.int64, np.int64,
                                      np.int64)))),
    "match_compact": lambda: matcher.match_compact(
        {"name": blocks.TokenColumn(torch.zeros((2, 1), dtype=torch.int64),
                                    torch.ones((2, 1), dtype=torch.bool))},
        np.zeros(1, np.int64), np.ones(1, np.int64)),
    "cluster_pairs_device": lambda: components.cluster_pairs_device(
        4, torch.zeros(2, dtype=torch.int32), torch.ones(2, dtype=torch.int32)),
    "threshold_blocking": lambda: baselines.threshold_blocking(
        torch.zeros((2, 1), dtype=torch.int64), torch.ones((2, 1), dtype=torch.bool)),
    "naive_pair_count": lambda: baselines.naive_pair_count(
        torch.zeros((2, 1), dtype=torch.int64), torch.ones((2, 1), dtype=torch.bool)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()


@pytest.fixture(scope="module")
def smoke_threshold(smoke):
    jc, _, tc = smoke
    jrep = jpipe.dedup_corpus(jc, jhdb.HDBConfig(**SMOKE_CFG), blocker="threshold",
                              match_backend="pallas")
    return jrep, tc


@pytest.mark.parametrize("backend", ["auto", "host"])
def test_threshold_pipeline_matches_reference(smoke_threshold, backend):
    jrep, tc = smoke_threshold
    rep = pipeline.dedup_corpus(tc, hdb.HDBConfig(**SMOKE_CFG), blocker="threshold",
                                match_backend=backend, device="cpu")
    assert np.array_equal(rep.component_of, jrep.component_of)
    assert np.array_equal(rep.survivors, jrep.survivors)
    for field in ("num_candidate_pairs", "num_matched_pairs", "num_components"):
        assert getattr(rep, field) == getattr(jrep, field), field
    assert rep.num_matched_pairs > 0 and rep.num_components < rep.num_records
