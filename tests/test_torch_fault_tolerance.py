"""Port parity: fault tolerance (``repro_torch.training.checkpoint``,
``stragglers``), every test of ``tests/test_fault_tolerance.py`` ported,
plus checkpoints read across packages and the asynchronous save.

Tolerance: exact equality everywhere (bit patterns for floats): a
checkpoint stores raw bits, and a resumed run repeats the same float
operations on the CPU.
"""
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.training import checkpoint as jcheckpoint  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core import blocks, hdb  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402
from repro_torch.training.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.training.stragglers import (PreemptionHandler, StragglerConfig,  # noqa: E402
                                             StragglerMonitor)
from repro_torch.training.train_loop import (TrainConfig, init_train_state,  # noqa: E402
                                             make_train_step)


def _bits(t):
    """A tensor's raw bits as numpy (bfloat16 as uint16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _tree_equal(a, b):
    la, lb = checkpoint.tree_leaves(a), checkpoint.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and np.array_equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _mixed_tree():
    return {
        "a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "b": torch.ones(4, dtype=torch.bfloat16) * 1.5,
        "c": {"d": torch.tensor([True, False]),
              "e": torch.tensor(3.25, dtype=torch.float32)},
        "f": torch.tensor([1, 2], dtype=torch.uint32),
        "g": [torch.tensor([-7], dtype=torch.int8), torch.full((3,), 0.1)],
    }


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like_tree(v) for v in tree]
    return torch.zeros_like(tree)


def test_checkpoint_roundtrip_mixed_dtypes(tmp_path):
    # int64 too: the port's u64 keys (the reference holds no int64 without x64)
    tree = {**_mixed_tree(), "h": torch.tensor([-1, 1 << 40], dtype=torch.int64)}
    checkpoint.save(str(tmp_path), 7, tree)
    assert checkpoint.latest_step(str(tmp_path)) == 7
    template = _zeros_like_tree(tree)
    got = checkpoint.restore(str(tmp_path), template)
    assert got is template
    assert _tree_equal(tree, got)
    assert got["b"].dtype == torch.bfloat16


def test_checkpoint_detects_corruption(tmp_path):
    tree = {"w": torch.ones(8, 8)}
    path = checkpoint.save(str(tmp_path), 1, tree)
    npz = os.path.join(path, "arrays.npz")
    data = dict(np.load(npz))
    data["leaf_0"] = data["leaf_0"] + 1  # corrupt
    np.savez(npz, **data)
    with pytest.raises(IOError, match="corruption"):
        checkpoint.restore(str(tmp_path), tree)


def test_checkpoint_gc_keeps_latest(tmp_path):
    tree = {"w": torch.zeros(2)}
    for step in range(6):
        checkpoint.save(str(tmp_path), step, tree, keep=2)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(dirs) == 2
    assert checkpoint.latest_step(str(tmp_path)) == 5


def _tiny_trainer():
    cfg = reduced_config("tinyllama-1.1b")
    tcfg = TrainConfig(opt=OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=50))
    model = build_model(cfg, device="cpu")
    return cfg, tcfg, model, init_train_state(model, tcfg)


def test_train_resume_bitwise_identical(tmp_path):
    """kill-after-step-N resume == uninterrupted run (same batches): the
    resumed state is a fresh model's, restored in place."""
    cfg, tcfg, model, s = _tiny_trainer()
    batches = [specs.train_batch(cfg, 16, 2, concrete=True,
                                 rng=np.random.default_rng(i), device="cpu")
               for i in range(6)]
    step = make_train_step(model, tcfg)
    for b in batches:
        s, _ = step(s, b)
    # interrupted at step 3 + resume into a fresh process's state
    _, _, model2, s2 = _tiny_trainer()
    step2 = make_train_step(model2, tcfg)
    for b in batches[:3]:
        s2, _ = step2(s2, b)
    checkpoint.save(str(tmp_path), 3, s2)
    _, _, model3, fresh = _tiny_trainer()
    resumed = checkpoint.restore(str(tmp_path), fresh)
    assert resumed["params"]["embed.table"] is model3.embed.table
    step3 = make_train_step(model3, tcfg)
    for b in batches[3:]:
        resumed, _ = step3(resumed, b)
    assert _tree_equal(s["params"], resumed["params"])
    assert _tree_equal(s["opt"], resumed["opt"])
    assert int(resumed["step"]) == 6


def test_smoke_resume_is_bit_identical_on_the_cpu(tmp_path):
    """The card's resume check (``training.smoke``, run by chip_smoke.py
    and the card tests) on the CPU."""
    from repro_torch.training import smoke
    cfg = reduced_config("tinyllama-1.1b")
    differ, n_leaves = smoke.resume_differs(
        cfg, torch.device("cpu"), smoke.batches(cfg, 4, 2, 16, "cpu"), str(tmp_path))
    # params, mu, nu (embed, lm_head, final norm, 9 a layer), two step counters
    assert differ == [] and n_leaves == 3 * (3 + 9 * cfg.num_layers) + 2


def test_hdb_pipeline_checkpoint_resume(tmp_path):
    """Blocking restarted from iteration-1 state matches the full run."""
    corpus = synthetic.generate(synthetic.SyntheticSpec(num_entities=600, seed=2),
                                device="cpu")
    keys, valid = blocks.build_keys(corpus.columns, corpus.blocking)
    cfg = hdb.HDBConfig(max_block_size=40, max_iterations=5)

    full = hdb.hashed_dynamic_blocking(keys, valid, cfg, device="cpu")

    # run iteration 0 manually, checkpoint the state, resume manually
    psize = torch.full(valid.shape, hdb.INT32_MAX, dtype=torch.int32)
    accepted, (k1, v1, p1), stats = hdb.hdb_iteration(cfg, keys, valid, psize)
    state = {"keys": k1, "valid": v1, "psize": p1}
    checkpoint.save(str(tmp_path), 0, state)
    restored = checkpoint.restore(str(tmp_path), _zeros_like_tree(state))
    assert _tree_equal(state, restored)

    acc_list = [accepted.numpy()]
    k, v, p = restored["keys"], restored["valid"], restored["psize"]
    for _ in range(1, cfg.max_iterations):
        acc, (k, v, p), st = hdb.hdb_iteration(cfg, k, v, p)
        acc_list.append(acc.numpy())
        if st["n_surviving_entries"] == 0:
            break
    resumed_total = sum(a.sum() for a in acc_list)
    assert resumed_total == len(full.rids)


def test_elastic_restore_onto_an_explicit_device(tmp_path):
    """The reference re-places every leaf into a target sharding; here the
    template's device is the target: each leaf is restored onto it, and a
    template of another dtype or shape is refused."""
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    checkpoint.save(str(tmp_path), 0, tree)
    target = torch.device("cpu")
    got = checkpoint.restore(str(tmp_path), {"w": torch.zeros(4, 4, device=target)})
    assert got["w"].device == target
    assert _tree_equal(tree, got)
    with pytest.raises(ValueError, match="leaf 0"):
        checkpoint.restore(str(tmp_path), {"w": torch.zeros(4, 4, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="leaf 0"):
        checkpoint.restore(str(tmp_path), {"w": torch.zeros(16)})
    with pytest.raises(ValueError, match="mismatch"):
        checkpoint.restore(str(tmp_path), {"w": torch.zeros(4, 4), "x": torch.zeros(1)})


def test_straggler_monitor_flags_persistent_slowness():
    mon = StragglerMonitor(StragglerConfig(outlier_factor=2.0, trip_threshold=3))
    flags = []
    for step in range(20):
        dur = 1.0 if step < 10 else 5.0  # becomes 5x slower at step 10
        flags.append(mon.end_step(step, duration=dur))
    assert not any(flags[:10])
    assert any(flags[10:])


def test_straggler_monitor_tolerates_single_blip():
    mon = StragglerMonitor(StragglerConfig(outlier_factor=2.0, trip_threshold=3))
    flags = [mon.end_step(0, duration=1.0)]
    flags.append(mon.end_step(1, duration=9.0))  # one GC pause
    for step in range(2, 10):
        flags.append(mon.end_step(step, duration=1.0))
    assert not any(flags)


def test_preemption_handler_requests_checkpoint():
    h = PreemptionHandler().install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.requested
    finally:
        h.uninstall()


def test_heartbeat_written(tmp_path):
    hb = str(tmp_path / "hb")
    mon = StragglerMonitor(StragglerConfig(heartbeat_path=hb, heartbeat_every=2))
    mon.end_step(0, duration=1.0)
    mon.end_step(1, duration=1.0)
    assert os.path.exists(hb)


# ---------------------------------------------------------------------------
# new here: checkpoints read across packages, the asynchronous save
# ---------------------------------------------------------------------------


def _jax_tree(tree):
    """The reference's tree of the same leaves (bfloat16 through its bits)."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v) for v in tree]
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(_bits(tree).view(jnp.bfloat16))
    return jnp.asarray(tree.numpy())


def _same_bits(port_tree, jax_tree):
    got = checkpoint.tree_leaves(port_tree)
    want = jax.tree_util.tree_leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16
            w = w.view(np.uint16)
        assert g.shape == w.shape and np.array_equal(_bits(g), w)


def test_reference_checkpoint_read_by_the_port(tmp_path):
    tree = _mixed_tree()
    jtree = _jax_tree(tree)
    jcheckpoint.save(str(tmp_path), 4, jtree)
    got = checkpoint.restore(str(tmp_path), _zeros_like_tree(tree))
    _same_bits(got, jtree)
    assert _tree_equal(got, tree)


def test_port_checkpoint_read_by_the_reference(tmp_path):
    tree = _mixed_tree()
    checkpoint.save(str(tmp_path), 4, tree)
    assert jcheckpoint.latest_step(str(tmp_path)) == 4
    template = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            _jax_tree(tree))
    got = jcheckpoint.restore(str(tmp_path), template)
    _same_bits(tree, got)
    assert np.asarray(got["b"]).dtype == jnp.bfloat16


def test_async_save_writes_the_state_before_a_later_update(tmp_path):
    """The optimizer updates its tensors in place; a non-blocking save has
    copied every leaf to the host before it returns, so its writer thread
    publishes the state of the call."""
    w = torch.arange(1 << 16, dtype=torch.float32)
    before = w.clone()
    checkpoint.save(str(tmp_path), 1, {"w": w}, blocking=False)
    w.mul_(-1.0)
    deadline = time.monotonic() + 60
    while checkpoint.latest_step(str(tmp_path)) != 1:
        assert time.monotonic() < deadline, "the writer thread never published"
        time.sleep(0.01)
    got = checkpoint.restore(str(tmp_path), {"w": torch.zeros_like(w)})
    assert torch.equal(got["w"], before)
