"""Port parity: the models on a mesh (``repro_torch.distributed.sharding``'s
rules, ``distributed.spmd``, ``models/moe.py``'s expert-parallel
dispatches, ``launch/train.main`` on a mesh) against the JAX package.

A gloo world of 8 CPU ranks on the (2, 2, 2) ``("pod", "data", "model")``
mesh runs ``_torch_mesh_worker.job_mesh_models`` while two subprocesses
run ``ref_mesh_models``'s two shares on 8 emulated host devices each
under the reference's ``production_rules`` (on an Auto-axes mesh: see
``_auto_mesh``), both
from inputs drawn here with the JAX package. The JAX programs compile at
XLA's cheapest LLVM settings (``FAST_COMPILE``: the reduced models' runs
take milliseconds, their compiles the test's time; the results move in
float32's last bit, far inside the bounds). Tolerances:

- the MoE block, both dispatches, at capacity factor 8 (nothing drops)
  and 0.5: each rank's rows within rtol/atol 2e-5 (the reference's own
  bound between its two dispatches, ``tests/_moe_worker.py``), ``aux``
  within rtol 1e-5, ``dropped`` exactly (LM faults 9 and 10: at 0.5 the
  psum dispatch reports 16 and the a2a one 0); the same on 2 rows, which
  do not divide over the 4 data ranks and are replicated (the reference
  sets ``dp = 1``), every rank's output the whole of the reference's;
- every family, reduced: tinyllama and olmoe, deepseek-v3 (MLA, MTP,
  MoE), jamba (its first 4 layers: Mamba+MoE, Mamba+MLP, Mamba+MoE,
  attention+MLP), rwkv6 and whisper: the loss and metrics of one batch
  within rtol 1e-5 / atol 2e-4 (``test_torch_models.py``'s bound), then
  two chained train steps' loss, ce, mtp_ce, moe_aux, grad_norm and lr
  within rtol 1e-4 and ``moe_dropped`` exactly (``test_torch_training.
  py``'s bounds, ``wq``/``wk``/``w_uq``/``w_ukv`` scaled by 1/4 as
  there); after the steps every parameter the rules replicate is
  bit-equal on every rank (a replicated parameter that a rank reads in
  part, or uses for its own heads, gets its gradient summed over the
  "model" dim, or its copies drift apart); the reduced olmoe's loss and
  one train step on a batch of 2 rows (replicated) alike;
- the launcher on the reduced olmoe from the reference's initial
  parameters (``wq``/``wk`` scaled by 1/4): the printed step-0 loss
  within rtol 1e-4 plus the print's rounding (5e-5); the step-1
  checkpoint's first moments (0.1 times the clipped gradient) within
  1e-5 of each leaf's largest (the step-1 gradient bound of
  ``test_torch_training.py`` at that scale) and its parameters within
  2 * lr (AdamW's first update moves each weight by about lr whatever
  its gradient's size, so a gradient below float32 noise can move its
  weight either way);
- the launcher's sharded checkpoint resumed from step 1, for olmoe and
  each family above: losses and parameters bit-equal; AdamW's decayed
  set of the blocks equal to the whole model's;
- the launcher on deepseek-v3, jamba (cut as above) and rwkv6 from the
  reference's scaled initial parameters: the printed step-0 and final
  (step-1) losses within rtol 1e-4 plus the print's rounding;
- ``spmd``'s bfloat16 sums on the (2, 4) ``("pod", "data")`` mesh of the
  same world: over the 2-rank dim in bfloat16, over the 4-rank dim and
  both dims in float32, the reduce-scatter a slab at a time with a small
  slab: each bit-equal to the float32 sum cast to bfloat16 (exact sums
  of multiples of 1/256), the slabs' result to one slab's;
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
        procs = {part: W.reference_process(part, tmp / f"{part}.pkl", n_dev=8,
                                           fast_compile=True)
                 for part in W.MESH_REF_PARTS}
        try:
            ranks = W.run_world("mesh_models", 8, tmp)
        finally:
            parts = [W.wait_reference(proc, tmp / f"{part}.pkl")
                     for part, proc in procs.items()]
        ref = parts[0]
        for other in parts[1:]:
            for key in ("models", "family_launch"):
                ref[key].update(other[key])
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


def _check_metrics(got, want, **tol):
    """The same metric names; ``moe_dropped`` exactly, the others within
    ``tol``."""
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "moe_dropped":
            assert got[k] == w
        else:
            np.testing.assert_allclose(got[k], w, err_msg=k, **tol)


def _check_train(ref, ranks, key, n_steps):
    want = ref["models"][key]
    for got in ranks:
        g = got["models"][key]
        np.testing.assert_allclose(g["loss"], want["loss"], **LOSS_TOL)
        _check_metrics(g["metrics"], want["metrics"], **LOSS_TOL)
        assert len(g["steps"]) == len(want["steps"]) == n_steps
        for gs, ws in zip(g["steps"], want["steps"]):
            _check_metrics(gs, ws, rtol=STEP_RTOL)
    # every rank reports the same global values
    assert all(r["models"][key] == ranks[0]["models"][key] for r in ranks)


@pytest.mark.parametrize("arch", W.MESH_ARCHS)
def test_loss_and_train_steps_match_reference(runs, arch):
    _check_train(*runs, arch, W.MESH_STEPS)


# the replicated parameters each family must keep equal on every rank,
# among others (every parameter whose spec splits no dim is checked)
REPLICATED = {
    "deepseek-v3-671b": ("stack.layers.0.attn.q_norm", "stack.layers.0.attn.kv_norm",
                         "mtp_proj", "mtp.pre_norm", "final_norm"),
    "jamba-1.5-large-398b": ("stack.layers.0.mamba.d_skip", "stack.layers.0.mamba.dt_bias",
                             "stack.layers.0.mamba.w_dt_out", "stack.layers.3.pre_norm"),
    "rwkv6-1.6b": ("stack.layers.0.rwkv.mu", "stack.layers.0.rwkv.w_decay_lora_a",
                   "stack.layers.0.rwkv.w_decay_lora_b", "stack.layers.0.rwkv.decay_base",
                   "stack.layers.0.rwkv.bonus", "stack.layers.0.rwkv.ln_x"),
    "whisper-medium": ("dec.0.cross.wq", "dec.0.cross.wk", "dec.0.cross.wv",
                       "dec.0.cross.wo", "dec.0.ln_cross", "enc.0.mlp.b_up",
                       "enc.0.mlp.b_down", "dec_pos", "enc_ln_b"),
}


@pytest.mark.parametrize("arch", W.MESH_ARCHS)
def test_replicated_parameters_stay_equal_across_ranks(runs, arch):
    _, ranks = runs
    want = ranks[0]["models"][arch]["replicated"]
    assert set(REPLICATED.get(arch, ("final_norm",))) <= set(want)
    for r in ranks[1:]:
        got = r["models"][arch]["replicated"]
        assert got == want, sorted(k for k in want if got.get(k) != want[k])


def _printed_losses(printed):
    lines = printed.splitlines()
    first = next(ln for ln in lines if ln.startswith("[train] step 0 loss"))
    final = next(ln for ln in lines if "final loss" in ln)
    return float(first.split()[-1]), float(final.split()[-1])


@pytest.mark.parametrize("arch", W.MESH_LAUNCH_FAMILIES)
def test_family_launcher_on_the_mesh_matches_reference(runs, arch):
    ref, ranks = runs
    want = _printed_losses(ref["family_launch"][arch])
    got = ranks[0]["family_launch"][arch]
    assert len(got["losses"]) == 2 and got["finite"]
    for g, w in zip(got["losses"], want):
        assert abs(g - w) <= STEP_RTOL * abs(w) + PRINT_ROUNDING, (got["losses"], want)
    for r in ranks:
        assert r["family_launch"][arch]["losses"] == got["losses"]


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


def _check_resumed(got):
    assert got["resumed_start"] == 1
    assert got["resumed_losses"] == got["losses"][1:]
    assert got["resumed_equal"]


def test_sharded_checkpoint_resumes_equal(runs):
    _, ranks = runs
    for r in ranks:
        _check_resumed(r["launch"])


@pytest.mark.parametrize("arch", W.MESH_LAUNCH_FAMILIES)
def test_family_sharded_checkpoint_resumes_equal(runs, arch):
    """Each family's launcher run cut back to its step-1 checkpoint (every
    block gathered to rank 0 and written whole) and resumed: the same
    loss and bit-equal blocks on every rank."""
    _, ranks = runs
    for r in ranks:
        _check_resumed(r["family_launch"][arch])


@pytest.mark.parametrize("arch", W.MESH_ARCHS)
def test_decayed_set_is_the_meshless_one(runs, arch):
    """AdamW decays the same parameters of the blocks as of the whole
    model: a block keeps its rank, so training fault 4 (a scanned unit's
    vectors decayed) holds on the mesh."""
    _, ranks = runs
    meshless, sharded = ranks[0]["models"][arch]["decayed"]
    assert meshless == sharded
    if arch == "jamba-1.5-large-398b":
        # the 4 layers are one scanned unit: its vectors are decayed
        assert "stack.layers.0.mamba.d_skip" in sharded
        assert "final_norm" not in sharded


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _collective_want(op, axes):
    """What ``op`` over ``axes`` of the "pod" mesh gives each rank, in rank
    order: stage by stage as ``spmd`` sums (a 16-bit sum over one 2-rank
    dim in its own type, every other one in float32, each cast back
    once), from the exact float32 sums of ``W.collective_input``."""
    shape, names = W.MESHES["pod"]
    coords = [np.unravel_index(r, shape) for r in range(int(np.prod(shape)))]
    vals = [W.collective_input(r) for r in range(len(coords))]

    def group(r, dims):
        return [q for q, c in enumerate(coords)
                if all(c[i] == coords[r][i] for i in range(len(shape)) if i not in dims)]

    dims = [names.index(a) for a in axes]
    if op == "all_reduce":
        return [_bf16(sum(vals[q] for q in group(r, dims))) for r in range(len(vals))]
    for d in dims:  # the outermost dim first, this rank's block of rows kept
        sums = [_bf16(sum(vals[q] for q in group(r, [d]))) for r in range(len(vals))]
        vals = [np.split(s, shape[d])[coords[r][d]] for r, s in enumerate(sums)]
    return vals


@pytest.mark.parametrize("case", W.COLLECTIVE_CASES)
def test_bf16_sums_equal_float32_sum_then_cast(runs, case):
    """``spmd``'s all-reduce and reduce-scatter of bfloat16 on gloo: the
    sum over the 2-rank "pod" dim, sent in bfloat16, and the sums over
    the 4-rank "data" dim and over both, sent in float32, each bit-equal
    to the float32 sum cast to bfloat16; the reduce-scatter taken a few
    rows a slab (an uneven last slab) bit-equal to one slab."""
    _, ranks = runs
    op, axes = W.COLLECTIVE_CASES[case]
    want = _collective_want(op, axes)
    for r, got in enumerate(ranks):
        y, one_slab = got["collectives"][case]
        np.testing.assert_array_equal(y, want[r], err_msg=f"rank {r}")
        if one_slab is not None:
            np.testing.assert_array_equal(y, one_slab, err_msg=f"rank {r}")


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
