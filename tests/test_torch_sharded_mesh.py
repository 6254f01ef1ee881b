"""Port parity: the sharded streaming store on a mesh (``ShardedBlockStore``
with a ``DeviceMesh``, the routed key-delta exchange of ``ShardRouter``
and ``DeltaBlocker``'s routed ledger sync).

The reference's ``tests/_shard_worker.py`` scenarios (flat on 8 ranks,
flat-sub4 as a world of 4, pod, 3axis, and overflow at ``route_slack``
0.01, whose fallback must be loud and lossless) go through the port in
gloo worlds of spawned ranks on the CPU and through the JAX package's
store on as many emulated host devices. Tolerance: exact equality of the
ledger, the accepted blocks, both probe modes of the queries and the
exchange and fallback counters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_worker as W  # noqa: E402
from test_torch_distributed import assert_same  # noqa: E402

from repro_torch.core import hdb, pairs  # noqa: E402
from repro_torch.streaming.store import pack_pair  # noqa: E402

WORLD_OF = {tag: sc[1] for tag, sc in W.SHARD_SCENARIOS.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX reference, {world: per-rank port results})."""
    tmp = tmp_path_factory.mktemp("shard")
    ref_out = tmp / "ref_shard.pkl"
    proc = W.reference_process("shard", ref_out)
    try:
        port = {world: W.run_world("shard", world, tmp) for world in (8, 4)}
    finally:
        ref = W.wait_reference(proc, ref_out)
    return ref, port


def _batch_ledger(key64, valid):
    """One batch HDB + exact dedupe over the union (the reference worker's
    ``batch_ledger``), on the port."""
    cfg = hdb.HDBConfig(**W.SHARD_CFG)
    res = hdb.hashed_dynamic_blocking(torch.from_numpy(key64.view(np.int64)),
                                      torch.from_numpy(valid), cfg, device="cpu")
    blk = pairs.build_blocks(res, device="cpu")
    ps = pairs.dedupe_pairs(blk, budget=blk.num_pair_slots + 1, device="cpu")
    pack = pack_pair(ps.a, ps.b)
    order = np.argsort(pack)
    return pack[order], ps.src_size[order]


def _views(out):
    return {k: out[k] for k in ("led_pack", "led_src", "accepted", "queries")}


@pytest.mark.parametrize("tag", list(W.SHARD_SCENARIOS))
def test_mesh_store_equals_reference_store(runs, tag):
    ref, port = runs
    got, want = port[WORLD_OF[tag]][0][tag], ref[tag]
    assert np.array_equal(got["keys"], want["keys"]), tag
    assert_same(_views(got), _views(want), tag)
    for counter in ("exchange_total", "exchange_fallback_total", "routed_fallback_total",
                    "capacity_warnings"):
        assert got[counter] == want[counter], (tag, counter)


@pytest.mark.parametrize("tag", list(W.SHARD_SCENARIOS))
def test_mesh_store_equals_single_store_and_batch(runs, tag):
    _, port = runs
    got = port[WORLD_OF[tag]][0][tag]
    assert_same(_views(got), _views(got["single"]), tag)
    _, _, _, _, n, card = W.SHARD_SCENARIOS[tag]
    key64, valid = W.port_shard_keys(np.random.default_rng(17), n, 5, card)
    want_pack, want_src = _batch_ledger(key64, valid)
    assert np.array_equal(got["led_pack"], want_pack) and np.array_equal(
        got["led_src"], want_src), tag
    assert len(want_pack) > (20 if tag == "overflow" else 50)


@pytest.mark.parametrize("tag", list(W.SHARD_SCENARIOS))
def test_mesh_store_fallback_is_loud_and_counted(runs, tag):
    _, port = runs
    got = port[WORLD_OF[tag]][0][tag]
    assert got["exchange_total"] > 0
    if W.SHARD_SCENARIOS[tag][3]:
        assert got["exchange_fallback_total"] > 0 and got["capacity_warnings"] > 0
    else:
        assert got["exchange_fallback_total"] == 0 and got["capacity_warnings"] == 0
        assert got["routed_fallback_total"] == 0


@pytest.mark.parametrize("world", [8, 4])
def test_every_rank_holds_the_same_store(runs, world):
    _, port = runs
    for rank, out in enumerate(port[world][1:], 1):
        assert_same(out, port[world][0], f"rank {rank}")
