"""Port parity: the mesh half of distributed blocking (``core/distributed``,
``core/routing``, the Bloom half of ``core/sketches``,
``kernels/pairs.pair_route_owner``) over ``torch.distributed``.

The port runs in gloo worlds of 4 and 8 spawned ranks on the CPU, with
``DeviceMesh`` shapes (8,), (2, 4), (2, 2, 2) and (4,); the JAX package
runs the same inputs (``tests/_dist_worker.py``'s corpus and config) on
as many emulated host devices in one subprocess. Tolerance: exact
equality of every accepted assignment, stat, pair and bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_worker as W  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core import sketches as jsketches  # noqa: E402
from repro.kernels.pairs import ops as jpair_ops  # noqa: E402
from repro_torch.core import pairs, routing, sketches, u64  # noqa: E402
from repro_torch.kernels import pairs as pair_kernels  # noqa: E402

# the one-dim mesh whose blocks the pair runs use, and the JAX mesh of the
# same shard count
FIRST = {8: "flat", 4: "flat4"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX reference, {world: per-rank port results}); the reference
    subprocess runs while the port's worlds do."""
    tmp = tmp_path_factory.mktemp("mesh")
    procs = {job: W.reference_process(job, tmp / f"{job}.pkl") for job in ("hdb8", "hdb4")}
    try:
        port = {world: W.run_world("hdb", world, tmp) for world in (8, 4)}
    finally:
        ref = {}
        for job, proc in procs.items():
            ref.update(W.wait_reference(proc, tmp / f"{job}.pkl"))
    return ref, port


def assert_same(got, want, tag):
    """Deep equality of nested dicts, lists, tuples and arrays."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), tag
        for k in want:
            assert_same(got[k], want[k], f"{tag}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), tag
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{tag}[{i}]")
    elif isinstance(want, np.ndarray):
        assert np.array_equal(np.asarray(got), want), tag
    else:
        assert got == want, tag


def _pairs_only(x):
    return {k: x[k] for k in ("a", "b", "src_size", "exact", "total_slots")}


@pytest.mark.parametrize("world,mesh", [(8, "flat"), (8, "pod"), (8, "3axis"),
                                        (4, "flat4")])
def test_distributed_hdb_equals_reference(runs, world, mesh):
    ref, port = runs
    got, want = port[world][0][f"hdb/{mesh}"], ref[f"hdb/{FIRST[world]}"]
    for f in ("rids", "key_hi", "key_lo", "stats"):
        assert np.array_equal(got[f], want[f]), (mesh, f)
    assert got["num_records"] == want["num_records"]
    assert len(got["stats"]) >= 2 and got["stats"][0, 8] > 0  # n_surviving_entries


def test_distributed_hdb_overflow_equals_reference(runs):
    """The fixed-capacity buffers overflow, the CMS over-counts and
    over-sized blocks repeat: the same assignments, the same stats field
    for field, and both warn."""
    ref, port = runs
    got, want = port[4][0]["stress/flat4"], ref["stress/flat4"]
    for f in ("rids", "key_hi", "key_lo", "stats"):
        assert np.array_equal(got[f], want[f]), f
    totals = got["stats"].sum(0)
    # columns: n_right_exact 3, n_duplicate_blocks 6, rep_overflow 9
    assert totals[3] > 0 and totals[6] > 0 and totals[9] > 0
    assert "RepCapacityWarning" in got["warnings"]
    assert got["warnings"] == want["warnings"]


@pytest.mark.parametrize("world,mesh", [(8, "flat"), (4, "flat4")])
def test_checkpoint_cb_gets_the_local_state(runs, world, mesh):
    """One call an iteration, with the rank's slice of the state."""
    _, port = runs
    got = port[world][0][f"hdb/{mesh}"]
    n_loc = got["num_records"] // world
    states = port[world][0][f"checkpoints/{mesh}"]
    assert [it for it, *_ in states] == list(got["stats"][:, 0])
    for _, keys, valid, psize in states:
        assert keys[0] == valid[0] == psize[0] == n_loc
        assert keys == valid == psize


@pytest.mark.parametrize("world,mesh", [(8, "flat"), (8, "pod"), (8, "3axis"),
                                        (4, "flat4")])
def test_distributed_hdb_holds_single_device_rule(runs, world, mesh):
    """The reference's own rule against the single-device port: no extra
    assignment, at most 2 missing (Bloom false positives), equal
    n_surviving_oversized and n_right_cms in every iteration."""
    _, port = runs
    got, single = port[world][0][f"hdb/{mesh}"], port[world][0]["single"]

    def key_set(r):
        return set(zip(r["rids"].tolist(), r["key_hi"].tolist(), r["key_lo"].tolist()))

    ks_single, ks_got = key_set(single), key_set(got)
    assert len(ks_single) > 1000
    assert not ks_got - ks_single
    assert len(ks_single - ks_got) <= 2
    n = min(len(single["stats"]), len(got["stats"]))
    # columns: iteration, live, right_cms, ..., n_surviving_oversized at 7
    assert np.array_equal(got["stats"][:n, [2, 7]], single["stats"][:n, [2, 7]])


@pytest.mark.parametrize("world", [8, 4])
@pytest.mark.parametrize("variant", ["exact", "sampled", "empty", "overflow", "global"])
def test_routed_dedupe_equals_reference_and_single_device(runs, world, variant):
    ref, port = runs
    rank0 = port[world][0]
    assert_same(rank0["blocks"], ref[f"blocks/{FIRST[world]}"], "blocks")
    single = rank0[{"sampled": "single/sampled", "empty": "single/empty"}.get(
        variant, "single/exact")]
    want = ref[f"pairs/{FIRST[world]}"][variant]
    got = rank0[f"pairs/{FIRST[world]}"][variant]
    assert_same(_pairs_only(got), _pairs_only(want), f"{variant} vs reference")
    assert_same(_pairs_only(got), single, f"{variant} vs single device")
    if variant != "global":
        assert got["warnings"] == want["warnings"], variant
    assert single["exact"] == (variant != "sampled")
    assert len(single["a"]) > (0 if variant == "empty" else 100)
    if variant == "overflow":
        assert want["warnings"] == ["RepCapacityWarning"]


@pytest.mark.parametrize("world,mesh", [(8, "flat"), (8, "pod"), (8, "3axis"),
                                        (4, "flat4")])
def test_dedupe_pairs_distributed_backend(runs, world, mesh):
    """dedupe_pairs(backend="distributed") on every mesh shape, against the
    reference's routed dedupe and the single device."""
    ref, port = runs
    got = port[world][0][f"backend/{mesh}"]
    assert_same(got, port[world][0]["single/exact"], mesh)
    assert_same(got, _pairs_only(ref[f"pairs/{FIRST[world]}"]["exact"]), mesh)


@pytest.mark.parametrize("world,mesh", [(8, "flat"), (8, "pod"), (8, "3axis"),
                                        (4, "flat4")])
def test_exchange_row_p_comes_from_shard_p(runs, world, mesh):
    _, port = runs
    assert all(r[f"exchange/{mesh}"] for r in port[world])


@pytest.mark.parametrize("world", [8, 4])
def test_every_rank_returns_the_same_result(runs, world):
    _, port = runs
    for rank, out in enumerate(port[world][1:], 1):
        assert_same(out, port[world][0], f"rank {rank}")


# ---------------------------------------------------------------------------
# in this process, against the JAX functions
# ---------------------------------------------------------------------------


def _limbs(k64):
    return (jnp.asarray((k64 >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((k64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def _pack(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


@pytest.mark.parametrize("n,n_shards,cap", [(1000, 4, 300), (1000, 4, 100),
                                            (500, 1, 600), (700, 70, 4), (0, 3, 5)])
def test_route_buckets_equals_reference(n, n_shards, cap):
    """Bucket contents, payloads and overflow count (the (1000, 4, 100)
    and (700, 70, 4) cases overflow; 70 shards take the reference's
    argsort path)."""
    rng = np.random.default_rng(n + n_shards)
    k64 = rng.integers(0, 1 << 63, n, dtype=np.int64).astype(np.uint64) * np.uint64(3)
    owner = rng.integers(0, n_shards + 1, n).astype(np.int32)   # n_shards: dropped
    pay = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    bhi, blo, (bpay,), ovf = jrouting.route_buckets(
        *_limbs(k64), [jnp.asarray(pay)], jnp.asarray(owner), n_shards, cap)
    gkey, (gpay,), govf = routing.route_buckets(
        u64.from_numpy_u64(k64), [torch.from_numpy(pay)], torch.from_numpy(owner),
        n_shards, cap)
    assert np.array_equal(u64.to_numpy_u64(gkey), _pack(bhi, blo))
    assert np.array_equal(gpay.numpy(), np.asarray(bpay))
    assert int(govf) == int(ovf)
    if cap == 100:
        assert int(ovf) > 0


@pytest.mark.parametrize("capacity", [1, 300, 20_000])
def test_bloom_equals_reference(capacity):
    cfg = jsketches.BloomConfig.for_capacity(capacity)
    pcfg = sketches.BloomConfig.for_capacity(capacity)
    assert (pcfg.num_slots, pcfg.num_hashes) == (cfg.num_slots, cfg.num_hashes)
    rng = np.random.default_rng(capacity)
    k64 = rng.integers(0, 1 << 63, 4 * capacity + 64, dtype=np.int64).astype(np.uint64)
    mask = rng.random(k64.shape[0]) < 0.25
    bits = jsketches.bloom_build(cfg, _limbs(k64), jnp.asarray(mask))
    pbits = sketches.bloom_build(pcfg, u64.from_numpy_u64(k64), torch.from_numpy(mask))
    assert pbits.dtype == torch.uint8
    assert np.array_equal(pbits.numpy(), np.asarray(bits))
    assert np.array_equal(
        sketches.bloom_positions(pcfg, u64.from_numpy_u64(k64)).numpy(),
        np.asarray(jsketches.bloom_positions(cfg, _limbs(k64))))
    query = np.concatenate([k64, k64 ^ np.uint64(0x5555)])
    hit = sketches.bloom_query(pcfg, pbits, u64.from_numpy_u64(query)).numpy()
    assert np.array_equal(hit, np.asarray(jsketches.bloom_query(cfg, bits, _limbs(query))))
    assert hit[: len(k64)][mask].all()      # no false negatives
    other = sketches.bloom_build(pcfg, u64.from_numpy_u64(k64), torch.from_numpy(~mask))
    assert np.array_equal(sketches.bloom_merge(pbits, other).numpy(),
                          np.asarray(jsketches.bloom_merge(bits, jnp.asarray(other.numpy()))))


@pytest.mark.parametrize("n_shards", [1, 3, 8, 64])
def test_pair_route_owner_equals_reference(n_shards):
    rng = np.random.default_rng(n_shards)
    a = rng.integers(0, 1 << 23, 5000).astype(np.int32)
    b = rng.integers(0, 1 << 23, 5000).astype(np.int32)
    valid = rng.random(5000) < 0.9
    want = jpair_ops.pair_route_owner(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid),
                                      n_shards)
    got = pair_kernels.pair_route_owner(torch.from_numpy(a), torch.from_numpy(b),
                                        torch.from_numpy(valid), n_shards)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[~valid] == n_shards).all()


def test_no_process_group_raises():
    blk = W.empty_shard_blocks(pairs.Blocks)
    with pytest.raises(ValueError, match="init_process_group"):
        pairs.dedupe_pairs(blk, backend="distributed", device="cpu")
