"""Port parity: the distributed blocking launcher (``repro_torch.launch.block``).

``main`` in this process (a world of one: single-device HDB) and in a
gloo world of two spawned ranks (distributed HDB on a one-dim mesh), each
against the JAX package's ``repro.launch.block`` computation on one and
two emulated host devices. Tolerance: exact equality of the accepted
assignments, in order, and every iteration's stats.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_worker as W  # noqa: E402
from repro_torch.launch import block  # noqa: E402


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """{devices: JAX reference}, the gloo world of two's per-rank results."""
    tmp = tmp_path_factory.mktemp("launch")
    procs = {n: W.reference_process(f"launch{n}", tmp / f"ref{n}.pkl", n_dev=n)
             for n in (1, 2)}
    try:
        world2 = W.run_world("launch", 2, tmp)
    finally:
        ref = {n: W.wait_reference(p, tmp / f"ref{n}.pkl") for n, p in procs.items()}
    return ref, world2


def _assert_result(got, want):
    for f in ("rids", "key_hi", "key_lo", "stats"):
        assert np.array_equal(got[f], want[f]), f
    assert got["num_records"] == want["num_records"]
    assert len(got["rids"]) > 1000


def test_world_of_one_equals_reference(refs, capsys):
    ref, _ = refs
    res = block.main(W.LAUNCH_ARGV + ["--device", "cpu"])
    _assert_result(W.blocking_out(res), ref[1])
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        ref[1]["printed"].strip().splitlines()[-1]


def test_gloo_world_of_two_equals_reference(refs):
    ref, world2 = refs
    for rank_out in world2:
        _assert_result(rank_out, ref[2])
    # both ranks padded the same corpus to an even record count
    assert ref[2]["num_records"] % 2 == 0


@pytest.mark.parametrize("argv,item", [(["--dryrun"], "A10"),
                                       (["--ckpt-dir", "ckpt"], "A11")])
def test_unported_options_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        block.main(W.LAUNCH_ARGV + ["--device", "cpu"] + argv)
