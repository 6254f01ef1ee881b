"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and ``nvcc`` (the kernels build from
``src/repro_torch/csrc`` at first use); elsewhere they skip. Run them on
the card with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``. Tolerance: exact equality of every output.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_tri_decode_kernel_matches_plain(dev):
    from repro_torch.kernels.pairs import tri
    rng = np.random.default_rng(0)
    n = rng.integers(0, tri.MAX_BLOCK_N + 1, 10_000).astype(np.int32)
    t = (rng.random(10_000) * np.maximum(n.astype(np.int64) * (n - 1) // 2, 1)).astype(np.int32)
    local, size = torch.from_numpy(t).to(dev), torch.from_numpy(n).to(dev)
    for steps in (1, 9, tri.MAX_SEARCH_STEPS):
        got = tri.tri_decode(local, size, steps)
        want = tri.tri_decode_torch(local, size, steps)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("p", [0, 5, 15])
def test_radix_pass_kernel_matches_plain(dev, p):
    from repro_torch.kernels.sort import radix
    rng = np.random.default_rng(p)
    w = rng.integers(-(1 << 63), (1 << 63) - 1, 64 * 1024, dtype=np.int64)
    w[::7] = -1
    words = torch.from_numpy(w).to(dev)
    got = radix.radix_pass(words, p)
    want = radix.radix_pass_torch(words, p)
    assert all(torch.equal(g, x) for g, x in zip(got, want))


def test_match_kernel_matches_plain(dev):
    from repro_torch.core import u64
    from repro_torch.data import matcher, synthetic
    from repro_torch.kernels.match import match
    corpus = synthetic.generate(synthetic.SyntheticSpec(num_entities=500, seed=1),
                                device=dev)
    tokens, masks, weights = matcher._schema(corpus.columns, matcher.MatcherConfig())
    col_off = [0] + np.cumsum([t.shape[1] for t in tokens]).tolist()
    tok = u64.to_int32_bits(torch.cat(tokens, 1)).contiguous()
    msk = torch.cat(masks, 1).to(torch.uint8).contiguous()
    rng = np.random.default_rng(2)
    n = corpus.num_records
    a = torch.from_numpy(rng.integers(0, n, 4096).astype(np.int32)).to(dev)
    b = torch.from_numpy(rng.integers(0, n, 4096).astype(np.int32)).to(dev)
    b[:512] = a[:512]
    valid = torch.ones(4096, dtype=torch.uint8, device=dev)
    for thr in (0.3, 0.65, 1.0):
        args = (tok, msk, col_off, weights, a, b, valid, thr)
        got = match.match_tiles(*args)
        want = match.match_tiles_torch(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_smoke_pipeline_cuda_equals_cpu(dev):
    from repro_torch.core import hdb
    from repro_torch.data import pipeline, synthetic
    spec = synthetic.SyntheticSpec(num_entities=150, seed=7)
    cfg = hdb.HDBConfig(max_block_size=50, max_iterations=6, cms_width=1 << 12)
    for blocker in ("hdb", "threshold"):
        gpu = pipeline.dedup_corpus(synthetic.generate(spec, device=dev), cfg,
                                    blocker=blocker, device=dev)
        cpu = pipeline.dedup_corpus(synthetic.generate(spec, device="cpu"), cfg,
                                    blocker=blocker, device="cpu")
        assert np.array_equal(gpu.component_of, cpu.component_of)
        assert np.array_equal(gpu.survivors, cpu.survivors)
        assert gpu.num_matched_pairs == cpu.num_matched_pairs


def test_mix64_kernel_matches_plain(dev):
    from repro_torch.core import hashing
    from repro_torch.kernels.hash64 import hash64
    rng = np.random.default_rng(3)
    for n in (1, 1000, (1 << 20) + 3):
        x = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n,
                                          dtype=np.int64)).to(dev)
        assert torch.equal(hash64.mix64_bulk(x), hash64.mix64_torch(x))
    grid = x[: 999 * 3].reshape(999, 3)
    # a strided view goes through hashing.mix64's .contiguous()
    assert torch.equal(hashing.mix64(grid[:, 1]), hash64.mix64_torch(grid[:, 1]))


def test_combine64_kernel_matches_plain(dev):
    from repro_torch.kernels.hash64 import hash64
    rng = np.random.default_rng(4)
    a = rng.integers(-(1 << 63), (1 << 63) - 1, (1000, 120), dtype=np.int64)
    b = rng.integers(-(1 << 63), (1 << 63) - 1, (1000, 120), dtype=np.int64)
    b[::3] = a[::3]                                 # ties: a == b
    b[1::7] = -1                                    # the all-ones key
    a, b = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    got = hash64.combine64(a, b)
    assert torch.equal(got, hash64.combine64_torch(a, b))
    assert torch.equal(got, hash64.combine64(b, a))


@pytest.mark.parametrize("r,t,m", [(1, 1, 1), (257, 129, 32), (20_000, 24, 24),
                                   (300, 8, 1024), (50, 0, 24)])
def test_minhash_kernel_matches_plain(dev, r, t, m):
    from repro_torch.kernels.minhash import minhash
    rng = np.random.default_rng(r + t + m)
    tok = torch.from_numpy(rng.integers(0, 1 << 32, (r, t), dtype=np.int64)).to(dev)
    mask = torch.from_numpy(rng.random((r, t)) < 0.8).to(dev)
    mask[: r // 3] = False                          # empty rows
    got = minhash.minhash(tok, mask, m)
    assert torch.equal(got, minhash.minhash_torch(tok, mask, m))
    if t == 0:
        assert bool((got == 0xFFFFFFFF).all())


@pytest.mark.parametrize("skew", [False, True])
def test_cms_kernel_matches_plain(dev, skew):
    from repro_torch.kernels.cms import cms
    rng = np.random.default_rng(5)
    depth, n, width = 4, 1 << 20, 1 << 12
    idx = rng.integers(0, width, (depth, n))
    if skew:                                        # one bucket per row, most entries
        idx[:, rng.random(n) < 0.9] = rng.integers(0, width, (depth, 1))
    idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    got = cms.cms_update(idx, mask, width)
    assert torch.equal(got, cms.cms_update_torch(idx, mask, width))
    assert int(got[0].sum()) == int(mask.sum())
