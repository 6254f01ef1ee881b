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


def _sort_inputs(seed):
    """Words for the sort kernels: random (with sentinels, over many
    tiles), one digit value everywhere, all sentinels, already sorted,
    reversed, and sizes that are not a tile multiple."""
    rng = np.random.default_rng(seed)
    n = 3 * 4096 + 17
    rand = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    rand[::7] = -1
    ordered = np.sort(rand.view(np.uint64)).view(np.int64)
    big = rng.integers(-(1 << 63), (1 << 63) - 1, (1 << 20) + 3, dtype=np.int64)
    return {"random": rand, "many_tiles": big,
            "one_digit": np.full(n, 0x0101010101010101, np.int64),
            "sentinels": np.full(n, -1, np.int64), "sorted": ordered,
            "reversed": ordered[::-1].copy(), "small": rand[:1000]}


@pytest.mark.parametrize("q,bits", [(0, 8), (3, 4), (5, 8), (7, 8)])
def test_sort_pass_kernel_matches_plain(dev, q, bits):
    from repro_torch.kernels.sort import radix
    for name, w in _sort_inputs(q).items():
        words = torch.from_numpy(w).to(dev)
        counts = radix.digit_counts(words, q + 1, bits)
        assert torch.equal(counts, radix.digit_counts_torch(words, q + 1, bits)), name
        want = radix.sort_pass_torch(words, q, bits)
        assert torch.equal(radix.sort_pass(words, q, bits, counts[q]), want), name


@pytest.mark.parametrize("n_passes", [4, 7, 12, 15, 16])
def test_radix_sort_kernel_matches_torch_sort(dev, n_passes):
    from repro_torch.core import u64
    from repro_torch.kernels.sort import ops as sort_ops
    for name, w in _sort_inputs(n_passes).items():
        words = torch.from_numpy(w).to(dev)
        got = sort_ops.sort_words(words, backend="radix", n_passes=n_passes)
        if n_passes == 16:
            want = u64.sort(words)[0]
        else:
            # bits at and above 4 * n_passes are never compared
            low = words & ((1 << (4 * n_passes)) - 1)
            want = words[torch.sort(low, stable=True)[1]]
        assert torch.equal(got, want), name


def test_radix_sort_one_digit_over_2_30_words(dev):
    """More than 2^30 of 1.14e9 words share one digit value, so a tile's
    look-back prefix passes 30 bits. Word k is ``k << 16 | low``: a stable
    sort by the low 16 bits orders equal lows by k."""
    from repro_torch.kernels.sort import ops as sort_ops
    n = (1 << 30) + (1 << 26) + 17
    gen = torch.Generator(device=dev).manual_seed(0)
    low = torch.randint(0, 1 << 16, (n,), device=dev, dtype=torch.int32,
                        generator=gen)
    low.masked_fill_(torch.rand(n, device=dev, generator=gen) < 0.99, 0)
    words = torch.arange(n, device=dev) << 16 | low
    del low
    got = sort_ops.sort_words(words, backend="radix", n_passes=4)
    # each output word is the input word of its k, and the (low, k) keys
    # rise strictly: every word comes out once, in stable order
    k = got >> 16
    assert torch.equal(words[k], got)
    del words
    key = (got & 0xFFFF) << 32 | k
    assert bool((key[1:] > key[:-1]).all())


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


@pytest.mark.parametrize("widths", [(8, 24, 1, 1, 1), (3, 40, 5)])
def test_match_kernel_token_edge_cases(dev, widths):
    """Repeated tokens (a six-token alphabet), masked slots whose token
    equals a valid one on the other side, an all-masked column, a column
    wider than 32 slots, and invalid lanes."""
    from repro_torch.kernels.match import match
    rng = np.random.default_rng(len(widths))
    col_off = [0] + np.cumsum(widths).tolist()
    n, lanes = 600, 4096
    tok = rng.integers(0, 6, (n, col_off[-1])).astype(np.int32)
    msk = rng.random((n, col_off[-1])) < 0.6
    msk[:, col_off[2]:col_off[3]] = False          # one column masked everywhere
    msk[::5, col_off[1]:col_off[2]] = False        # and one column on some records
    a = rng.integers(0, n, lanes).astype(np.int32)
    b = rng.integers(0, n, lanes).astype(np.int32)
    b[:300] = a[:300]
    b[300:600] = (a[300:600] + 1) % n
    tok[(a[300:600] + 1) % n] = tok[a[300:600]]    # equal tokens, other masks
    valid = (rng.random(lanes) < 0.95).astype(np.uint8)
    weights = tuple(float(w) for w in rng.random(len(widths)) + 0.1)
    args = [torch.from_numpy(x).to(dev) for x in (tok, msk.astype(np.uint8), a, b, valid)]
    for thr in (0.2, 0.5, 0.8, 1.0):
        call = (args[0], args[1], col_off, weights, args[2], args[3], args[4], thr)
        got = match.match_tiles(*call)
        want = match.match_tiles_torch(*call)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert 0 < int(got[0].sum()) < lanes or thr == 1.0


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


@pytest.mark.parametrize("t", [0, 1, 7, 8, 24, 33, 64, 129])
def test_minhash_kernel_widths_and_masks(dev, t):
    """Hash counts from 1 past the old 1024 limit, masks with holes, rows
    with no valid token, the tokens 0 and 0xFFFFFFFF, rows that are not
    16-byte aligned (the generic loop at the template widths), and seeds
    up to 2**64 - 1."""
    from repro_torch.kernels.minhash import minhash
    rng = np.random.default_rng(t)
    r = 3001
    tok = rng.integers(0, 1 << 32, (r, t), dtype=np.int64)
    tok[::5] = 0
    tok[1::7] = 0xFFFFFFFF
    mask = rng.random((r, t)) < 0.6                 # holes, not prefixes
    mask[3::13] = True
    mask[::11] = False                              # rows with no valid token
    for m in (1, 24, 1024, 1500):
        tk = torch.from_numpy(tok).to(dev)
        mk = torch.from_numpy(mask).to(dev)
        got = minhash.minhash(tk, mk, m)
        assert torch.equal(got, minhash.minhash_torch(tk, mk, m)), m
        assert bool((got[::11] == 0xFFFFFFFF).all())
        # one int64 and one byte in: rows start off their 16-byte alignment
        flat = torch.zeros(r * t + 1, dtype=torch.int64, device=dev)
        flat[1:] = tk.reshape(-1)
        fm = torch.zeros(r * t + 1, dtype=torch.bool, device=dev)
        fm[1:] = mk.reshape(-1)
        odd_t, odd_m = flat[1:].view(r, t), fm[1:].view(r, t)
        assert torch.equal(minhash.minhash(odd_t, odd_m, m), got), m
    for seed in (0, 12345, (1 << 64) - 1):          # addends made on the card
        assert torch.equal(minhash.minhash(tk, mk, 24, seed),
                           minhash.minhash_torch(tk, mk, 24, seed)), seed
    with pytest.raises(ValueError):
        minhash.minhash(tk, mk, 0)


def _cms_check(cms, idx, mask, width):
    got = cms.cms_update(idx, mask, width)
    torch.cuda.synchronize()
    assert torch.equal(got, cms.cms_update_torch(idx, mask, width))
    assert int(got.sum()) == idx.shape[0] * int(mask.sum())


@pytest.mark.parametrize("depth", [1, 4, 6])
@pytest.mark.parametrize("log_width", [12, 15, 16, 20, 22])
def test_cms_kernel_widths_depths_sizes(dev, log_width, depth):
    """Sizes around the 16-entry mask loads; a mask with no live entry,
    and one that is not 16-byte aligned (an offset view)."""
    from repro_torch.kernels.cms import cms
    width = 1 << log_width
    gen = torch.Generator(device=dev).manual_seed(log_width * 10 + depth)
    for n in (1, 15, 17, (1 << 24) + 3):
        idx = torch.randint(0, width, (depth, n), device=dev, dtype=torch.int32,
                            generator=gen)
        mask = torch.rand(n + 1, device=dev, generator=gen) < 0.3
        _cms_check(cms, idx, mask[:n], width)
        _cms_check(cms, idx, mask[1:], width)
        _cms_check(cms, idx, torch.zeros(n, dtype=torch.bool, device=dev), width)
    empty = torch.zeros((depth, 0), dtype=torch.int32, device=dev)
    got = cms.cms_update(empty, torch.zeros(0, dtype=torch.bool, device=dev), width)
    assert got.shape == (depth, width) and not bool(got.any())


def test_cms_kernel_one_bucket_holds_every_key(dev):
    """Every live entry of 2^24 in one bucket of each row: every warp's
    atomics fall on one address (the skew of an over-sized block)."""
    from repro_torch.kernels.cms import cms
    n, width = 1 << 24, 1 << 20
    idx = torch.tensor([[7], [width - 1], [0], [123_456]], dtype=torch.int32,
                       device=dev).expand(4, n).contiguous()
    mask = torch.rand(n, device=dev, generator=torch.Generator(device=dev)
                      .manual_seed(1)) < 0.9
    _cms_check(cms, idx, mask, width)
    mask[:] = True
    _cms_check(cms, idx, mask, width)


def test_cms_kernel_iteration_one_layout(dev):
    """The HDB iteration-1 key rows: 120 intersection slots a record with
    a valid prefix of about 15, and keys repeated across records."""
    from repro_torch.kernels.cms import cms
    rng = np.random.default_rng(9)
    records, slots, width = 300_000, 120, 1 << 20
    valid = rng.integers(0, 31, records)
    mask = (np.arange(slots)[None, :] < valid[:, None]).reshape(-1)
    pool = rng.integers(0, width, (4, 50_000))
    pick = rng.integers(0, 50_000, records * slots)
    idx = np.ascontiguousarray(pool[:, pick].astype(np.int32))
    _cms_check(cms, torch.from_numpy(idx).to(dev), torch.from_numpy(mask).to(dev), width)


def test_streaming_smoke_cuda_equals_cpu(dev):
    from repro_torch.streaming import smoke
    gpu, cpu = smoke.smoke_run(dev), smoke.smoke_run("cpu")
    assert smoke.differing(gpu, cpu) == []
    assert gpu["extend auto"][-1][1] > 0 and len(gpu["ledger"][0]) > 0


@pytest.mark.parametrize("n", [0, 1, 31, 100_000])
def test_level_cms_apply_through_kernel(dev, n):
    """The store's sketch fold on the card: the cms kernel builds the
    delta's sketch; +1 then -1 twice equals np.add.at, never negative."""
    from repro_torch.core import sketches
    from repro_torch.kernels.cms import cms
    from repro_torch.streaming.store import LevelKeys
    cfg = sketches.CMSConfig(4, 1 << 18)
    rng = np.random.default_rng(n)
    base = sketches.np_cms_indices(cfg, rng.integers(0, 5000, 200_000, dtype=np.uint64))
    lk = LevelKeys.empty(cfg, dev)
    lk.cms_apply(base, 1)
    want = np.zeros((cfg.depth, cfg.width), np.int32)
    for j in range(cfg.depth):
        np.add.at(want[j], base[j], 1)
    delta = base[:, rng.permutation(base.shape[1])[:n]]
    for sign in (1, -1, -1):
        before = cms.KERNEL.launches
        lk.cms_apply(delta, sign)
        assert cms.KERNEL.launches == before + (1 if n else 0)
        for j in range(cfg.depth):
            np.add.at(want[j], delta[j], sign)
        got = lk.cms.cpu().numpy()
        assert np.array_equal(got, want)
        assert got.min() >= 0
    assert np.array_equal(lk.cms_lookup(base[:, :64]),
                          np.stack([want[j][base[j, :64]] for j in range(cfg.depth)]))


@pytest.mark.parametrize("n_shards", [4, 8])
def test_sharded_smoke_cuda_equals_cpu(dev, n_shards):
    """The smoke corpus through StreamingEngine(n_shards): the shards'
    sketch slices fold through the cms kernel; every report, the ledger,
    the candidate pairs and the probes equal the cpu run and the single
    store's."""
    from repro_torch.kernels.cms import cms
    from repro_torch.streaming import smoke
    before = cms.KERNEL.launches
    gpu = smoke.sharded_run(dev, n_shards)
    assert cms.KERNEL.launches > before
    assert smoke.differing(gpu, smoke.sharded_run("cpu", n_shards)) == []
    assert smoke.differing(gpu, smoke.sharded_run(dev, 1)) == []
    assert len(gpu["ledger"][0]) > 0


def test_evaluate_and_meta_blocking_cuda_equal_cpu(dev):
    """THR, HDB and PMB on a small corpus, evaluated on the card and on
    the CPU: equal metrics field for field, equal PMB pairs; PMB's edge
    enumeration goes through the tri-decode kernel."""
    import dataclasses
    from repro_torch.core import baselines, blocks, hdb, metablocking, pairs
    from repro_torch.data import metrics, synthetic
    from repro_torch.kernels.pairs import tri as td
    spec = synthetic.SyntheticSpec(num_entities=1500, seed=9)
    out = {}
    for d in (dev, torch.device("cpu")):
        corpus = synthetic.generate(spec, device=d)
        keys, valid = blocks.build_keys(corpus.columns, corpus.blocking)
        before = td.KERNEL.launches
        pmb_pairs = metablocking.meta_blocking(keys, valid, device=d)
        if d.type == "cuda":
            assert td.KERNEL.launches > before
        res = {"THR": baselines.threshold_blocking(keys, valid, 40, device=d),
               "HDB": hdb.hashed_dynamic_blocking(keys, valid,
                                                  hdb.HDBConfig(max_block_size=40), device=d),
               "PMB": metablocking.meta_blocking_result(keys, valid, device=d)}
        labeled = corpus.labeled_pairs()
        out[d.type] = (pmb_pairs,
                       {m: dataclasses.asdict(metrics.evaluate(r, corpus, labeled, device=d))
                        for m, r in res.items()},
                       pairs.pair_covered(res["HDB"], *labeled, device=d))
    (ga, gb), gm, gcov = out["cuda"]
    (ca, cb), cm, ccov = out["cpu"]
    assert np.array_equal(ga, ca) and np.array_equal(gb, cb) and len(ga) > 0
    assert gm == cm
    assert np.array_equal(gcov, ccov) and gcov.any()


@pytest.fixture
def one_rank_mesh(dev, tmp_path):
    """A one-rank group in this process (NCCL for CUDA tensors, gloo for
    CPU ones) and its one-dim mesh."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh
    tdist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{tmp_path}/init",
                             rank=0, world_size=1)
    try:
        yield DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("data",))
    finally:
        tdist.destroy_process_group()


def test_one_rank_distributed_hdb_and_routed_dedupe_cuda_equal_cpu(dev, one_rank_mesh):
    """Distributed HDB and the routed dedupe (exact and sampled) on a small
    corpus over a one-rank NCCL mesh, against the same calls on the CPU;
    every kernel of the path launches."""
    from repro_torch.core import blocks, distributed, hdb, pairs
    from repro_torch.data import synthetic
    from repro_torch.kernels.cms import cms
    from repro_torch.kernels.hash64 import hash64
    from repro_torch.kernels.pairs import tri as td
    from repro_torch.kernels.sort import radix
    path = (cms.KERNEL, hash64.MIX_KERNEL, hash64.COMBINE_KERNEL, td.KERNEL,
            radix.PASS_KERNEL, radix.COUNTS_KERNEL)
    cfg = hdb.HDBConfig(max_block_size=40, max_iterations=5)
    out = {}
    for d in (dev, torch.device("cpu")):
        before = [k.launches for k in path]
        corpus = synthetic.generate(synthetic.SyntheticSpec(num_entities=900, seed=11),
                                    device=d)
        keys, valid = blocks.build_keys(corpus.columns, corpus.blocking)
        res = distributed.distributed_hashed_dynamic_blocking(
            keys, valid, cfg, one_rank_mesh, device=d)
        blk = pairs.build_blocks(res, device=d)
        ps = [pairs.dedupe_pairs(blk, budget=budget, backend="distributed",
                                 mesh=one_rank_mesh, device=d)
              for budget in (blk.num_pair_slots + 1, blk.num_pair_slots // 3)]
        if d.type == "cuda":
            assert all(k.launches > b for k, b in zip(path, before))
        out[d.type] = (res, ps)
    (gres, gps), (cres, cps) = out["cuda"], out["cpu"]
    for f in ("rids", "key_hi", "key_lo"):
        assert np.array_equal(getattr(gres, f), getattr(cres, f))
    assert gres.stats == cres.stats and len(gres.rids) > 1000
    for g, c in zip(gps, cps):
        for f in ("a", "b", "src_size"):
            assert np.array_equal(getattr(g, f), getattr(c, f))
        assert (g.exact, g.total_slots) == (c.exact, c.total_slots)
    assert gps[0].exact and not gps[1].exact
