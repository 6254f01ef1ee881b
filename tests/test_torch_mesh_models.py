"""Port parity: the models on a mesh (``repro_torch.distributed.sharding``'s
rules, ``distributed.spmd``, ``models/moe.py``'s expert-parallel
dispatches, ``launch/train.main`` on a mesh) against the JAX package.

A gloo world of 8 CPU ranks on the (2, 2, 2) ``("pod", "data", "model")``
mesh runs ``_torch_mesh_worker.job_mesh_models`` while one subprocess runs
``ref_mesh_models`` on 8 emulated host devices under the reference's
``production_rules`` (on an Auto-axes mesh: see ``_auto_mesh``), both
from inputs drawn here with the JAX package. Tolerances:

- the MoE block, both dispatches, at capacity factor 8 (nothing drops)
  and 0.5: each rank's rows within rtol/atol 2e-5 (the reference's own
  bound between its two dispatches, ``tests/_moe_worker.py``), ``aux``
  within rtol 1e-5, ``dropped`` exactly (LM faults 9 and 10: at 0.5 the
  psum dispatch reports 16 and the a2a one 0); the same on 2 rows, which
  do not divide over the 4 data ranks and are replicated (the reference
  sets ``dp = 1``), every rank's output the whole of the reference's;
- the reduced tinyllama and olmoe: the loss and metrics of one batch
  within rtol 1e-5 / atol 2e-4 (``test_torch_models.py``'s bound), then
  two chained train steps' loss, ce, moe_aux, grad_norm and lr within
  rtol 1e-4 and ``moe_dropped`` exactly (``test_torch_training.py``'s
  bounds, ``wq``/``wk`` scaled by 1/4 as there); the reduced olmoe's
  loss and one train step on a batch of 2 rows (replicated) alike;
- the launcher on the reduced olmoe from the reference's initial
  parameters (``wq``/``wk`` scaled by 1/4): the printed step-0 loss
  within rtol 1e-4 plus the print's rounding (5e-5); the step-1
  checkpoint's first moments (0.1 times the clipped gradient) within
  1e-5 of each leaf's largest (the step-1 gradient bound of
  ``test_torch_training.py`` at that scale) and its parameters within
  2 * lr (AdamW's first update moves each weight by about lr whatever
  its gradient's size, so a gradient below float32 noise can move its
  weight either way);
- the launcher's sharded checkpoint resumed from step 1: losses and
  parameters bit-equal;
- LM faults 9 and 10 (ROADMAP Queue C) pinned in both packages: the
  dropped counts of the meshless block and of each data shard's rows
  alone, exactly.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_worker as W  # noqa: E402
from repro.configs import reduced_config as jreduced_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

MOE_TOL = dict(rtol=2e-5, atol=2e-5)
AUX_RTOL = 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=2e-4)
STEP_RTOL = 1e-4
PRINT_ROUNDING = 5e-5
MU_REL = 1e-5
LAUNCH_LR = 3e-4  # the launcher's OptimizerConfig lr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, the 8 ranks' results)."""
    tmp = tmp_path_factory.mktemp("mesh_models")
    W.mesh_model_inputs(tmp / "mesh_inputs.pkl")
    old = os.environ.get("REPRO_TEST_TMP")
    os.environ["REPRO_TEST_TMP"] = str(tmp)
    try:
        proc = W.reference_process("mesh_models", tmp / "ref.pkl", n_dev=8)
        try:
            ranks = W.run_world("mesh_models", 8, tmp)
        finally:
            ref = W.wait_reference(proc, tmp / "ref.pkl")
    finally:
        if old is None:
            os.environ.pop("REPRO_TEST_TMP")
        else:
            os.environ["REPRO_TEST_TMP"] = old
    return ref, ranks


@pytest.mark.parametrize("cf", W.MOE_CAPACITY_FACTORS)
@pytest.mark.parametrize("impl", W.MOE_IMPLS)
def test_moe_dispatch_matches_reference(runs, cf, impl):
    ref, ranks = runs
    want_y, want_aux, want_dropped = ref["moe"][(cf, impl)]
    rows = want_y.shape[0] // 4
    for got in ranks:
        y, aux, dropped = got["moe"][(cf, impl)]
        i = got["rows"]
        np.testing.assert_allclose(y, want_y[i * rows:(i + 1) * rows], **MOE_TOL)
        np.testing.assert_allclose(aux, want_aux, rtol=AUX_RTOL)
        assert dropped == want_dropped
    if cf == 8.0:
        assert want_dropped == 0
    else:
        # LM faults 9 and 10, mirrored
        assert want_dropped == {"psum": 16, "a2a": 0}[impl]


@pytest.mark.parametrize("cf", W.MOE_CAPACITY_FACTORS)
@pytest.mark.parametrize("impl", W.MOE_IMPLS)
def test_moe_on_rows_that_do_not_divide_matches_reference(runs, cf, impl):
    """2 rows over the mesh's 4 data ranks: every rank holds them all and
    dispatches them as the reference's dp = 1 body does."""
    ref, ranks = runs
    key = (W.MESH_SMALL_ROWS, cf, impl)
    want_y, want_aux, want_dropped = ref["moe"][key]
    assert want_y.shape[0] == W.MESH_SMALL_ROWS
    for got in ranks:
        y, aux, dropped = got["moe"][key]
        np.testing.assert_allclose(y, want_y, **MOE_TOL)
        np.testing.assert_allclose(aux, want_aux, rtol=AUX_RTOL)
        assert dropped == want_dropped
    if cf == 8.0:
        assert want_dropped == 0


def _check_train(ref, ranks, key, n_steps):
    want = ref["models"][key]
    for got in ranks:
        g = got["models"][key]
        np.testing.assert_allclose(g["loss"], want["loss"], **LOSS_TOL)
        for k in ("ce", "moe_aux"):
            np.testing.assert_allclose(g["metrics"][k], want["metrics"][k], **LOSS_TOL)
        assert g["metrics"]["moe_dropped"] == want["metrics"]["moe_dropped"]
        assert len(g["steps"]) == len(want["steps"]) == n_steps
        for gs, ws in zip(g["steps"], want["steps"]):
            assert set(gs) == set(ws)
            for k in ("loss", "ce", "moe_aux", "grad_norm", "lr"):
                np.testing.assert_allclose(gs[k], ws[k], rtol=STEP_RTOL, err_msg=k)
            assert gs["moe_dropped"] == ws["moe_dropped"]
    # every rank reports the same global values
    assert all(r["models"][key] == ranks[0]["models"][key] for r in ranks)


@pytest.mark.parametrize("arch", W.MESH_ARCHS)
def test_loss_and_train_steps_match_reference(runs, arch):
    _check_train(*runs, arch, W.MESH_STEPS)


def test_batch_that_does_not_divide_trains_as_reference(runs):
    """The reduced olmoe's loss and a train step on a batch of 2 rows,
    which the 4 data ranks cannot split: replicated, as in the reference
    (the launcher's default batch of 8 on the production mesh's 16 data
    ranks is such a batch)."""
    _check_train(*runs, "replicated", 1)


def test_launcher_on_the_mesh_matches_reference(runs):
    ref, ranks = runs
    got = ranks[0]["launch"]
    printed = ref["launch"]["printed"]
    line = next(ln for ln in printed.splitlines() if ln.startswith("[train] step 0 loss"))
    want0 = float(line.split()[-1])
    assert abs(got["losses"][0] - want0) <= STEP_RTOL * abs(want0) + PRINT_ROUNDING
    assert len(got["losses"]) == 2 and np.isfinite(got["losses"]).all()
    want = ref["launch"]["step1"]
    assert set(got["step1"]["params"]) == set(want["params"])
    for k, w in want["mu"].items():
        assert np.abs(got["step1"]["mu"][k] - w).max() <= MU_REL * np.abs(w).max(), k
    for k, w in want["params"].items():
        assert np.abs(got["step1"]["params"][k] - w).max() <= 2 * LAUNCH_LR, k
    for r in ranks:
        assert r["launch"]["losses"] == got["losses"]


def test_sharded_checkpoint_resumes_equal(runs):
    _, ranks = runs
    for r in ranks:
        got = r["launch"]
        assert got["resumed_start"] == 1
        assert got["resumed_losses"] == got["losses"][1:]
        assert got["resumed_equal"]


def test_moe_dropped_counts_pin_lm_faults_9_and_10(runs):
    """On the reduced olmoe's x (4 rows of 8 tokens) at capacity factor
    0.5 the block drops 32 assignments without a mesh and each data
    shard's row alone drops [8, 10, 9, 10] (37 in all), in both
    packages. On the (2, 2, 2) mesh the reference's psum dispatch reports
    16 (LM fault 9: each EP rank counts every expert's drops of the first
    data shard, and the EP psum doubles them) and its a2a dispatch 0 (LM
    fault 10: its buffers ignore ``capacity_factor``); the port mirrors
    both (``test_moe_dispatch_matches_reference``)."""
    ref, ranks = runs
    jcfg = dataclasses.replace(jreduced_config("olmoe-1b-7b"), capacity_factor=0.5)
    tcfg = dataclasses.replace(reduced_config("olmoe-1b-7b"), capacity_factor=0.5)
    params = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)["moe"]
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (4, 8, jcfg.d_model)))
    block = moe.MoE(tcfg, "cpu", None).requires_grad_(False)
    block.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    counts = []
    for rows in (x, *(x[i:i + 1] for i in range(4))):
        want = int(jax.jit(lambda p, v: jmoe.moe_apply(p, v, jcfg))(params, rows)[2])
        assert int(block(torch.from_numpy(rows))[2]) == want
        counts.append(want)
    assert counts == [32, 8, 10, 9, 10]
    n_ep = 2
    assert ref["moe"][(0.5, "psum")][2] == n_ep * counts[1] == 16
    assert ref["moe"][(0.5, "a2a")][2] == 0
    assert all(r["moe"][(0.5, "psum")][2] == 16 and r["moe"][(0.5, "a2a")][2] == 0
               for r in ranks)
