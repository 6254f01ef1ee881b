"""Port parity: training (``repro_torch.training``, ``data/loader``,
``launch/specs``, ``launch/train``) against the JAX package.

The reduced tinyllama (4 layers, float32) runs in both packages from the
reference's ``init_train_state(model, PRNGKey(0), ...)``, carried across
by ``convert.train_state_from_jax``. Tolerances:

- the optimizer, fed the same numpy gradients: parameters and moments
  within rtol 1e-6, with an absolute floor of 1e-6 of the tensor's
  largest magnitude. The global norm is summed in another order, so the
  clip scale, and with it every moment, can lie one float32 ulp apart
  (measured 4.9e-7 relative); where ``b1 * mu + (1 - b1) * g`` cancels,
  that ulp is up to 3% of a moment of 6.1e-8 (1.4e-7 of its tensor's
  largest);
- int8 quantization and loader / batch tokens: exact;
- step-1 gradients: each leaf within 1e-5 of that leaf's max |g|, on the
  reference's init with ``wq`` and ``wk`` scaled by 1/4 (measured
  1.1e-6). The reference's init itself (fan-in = heads for ``wq``,
  = kv heads for ``wk``) makes the attention softmax sharp enough to
  amplify float32 rounding: there the reference's gradients lie up to
  1.4e-4 and the port's up to 8.0e-5 of a leaf's max from a float64
  evaluation of the same weights, and 1.5e-4 apart, so that case holds
  5e-4;
- loss, ce, grad_norm and lr: rtol 1e-4 over 5 chained steps at the
  1/4 scale (measured 2.2e-7), and for the first step on the
  reference's init (measured 1.3e-5). Later steps on that init part:
  AdamW's first update moves every weight by about lr whatever the size
  of its gradient, so a gradient below the float32 noise moves its
  weight in either direction (measured 7.1e-3 by step 3);
- gradient accumulation and compressed training: the reference's own
  bounds (``tests/test_training.py:62-94``);
- remat "none", "full" and "selective": bit-equal gradients (the same
  operations recomputed on the CPU);
- ``compressed_psum_grads`` over a gloo group of two against the
  reference under ``shard_map`` on two host devices: rtol 1e-6.
"""
import contextlib
import io
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_worker as W  # noqa: E402
from repro.configs import reduced_config as jreduced_config  # noqa: E402
from repro.core import hdb as jhdb  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.training import compression as jcompression  # noqa: E402
from repro.training import optimizer as joptimizer  # noqa: E402
from repro.training import train_loop as jtrain_loop  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core import hdb  # noqa: E402
from repro_torch.data import loader, pipeline, synthetic  # noqa: E402
from repro_torch.launch import specs, train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training import compression, optimizer  # noqa: E402
from repro_torch.training.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.training.train_loop import (TrainConfig, init_train_state,  # noqa: E402
                                             make_train_step)

ARCH = "tinyllama-1.1b"
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=100)
OPT_RTOL = 1e-6
# each leaf's max |g|: by the scale of wq and wk (the module docstring)
GRAD_REL = {0.25: 1e-5, 1.0: 5e-4}
STEP_RTOL = 1e-4
# the chained steps held at STEP_RTOL, by the scale of wq and wk
CHAINED_STEPS = {0.25: 5, 1.0: 1}
# the launcher's corpus (launch/train.py): its defaults
LAUNCH_SPEC = dict(num_entities=3000, dup_rate=0.5, seed=13)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _scale_qk(params, qk_scale):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * qk_scale if path[-1].key in ("wq", "wk") else x, params)


def _pair(qk_scale=1.0, **tcfg_changes):
    """(reference model, its state, port model, port state carrying it,
    reference and port TrainConfigs); ``qk_scale`` scales the reference's
    initial ``wq`` and ``wk``."""
    jm = jbuild_model(jreduced_config(ARCH))
    jt = jtrain_loop.TrainConfig(opt=joptimizer.OptimizerConfig(**OPT), **tcfg_changes)
    jstate = jtrain_loop.init_train_state(jm, jax.random.PRNGKey(0), jt)
    jstate["params"] = _scale_qk(jstate["params"], qk_scale)
    cfg = reduced_config(ARCH)
    model = build_model(cfg, device="cpu")
    tt = TrainConfig(opt=OptimizerConfig(**OPT), **tcfg_changes)
    state = init_train_state(model, tt)
    convert.train_state_from_jax(cfg, jax.tree.map(np.asarray, jstate), state)
    return jm, jstate, model, state, jt, tt


def _batches(n, b=4, s=32):
    """(reference, port) train batches, the same numpy draws."""
    out = []
    for i in range(n):
        jb = jspecs.train_batch(jreduced_config(ARCH), s, b, concrete=True,
                                rng=np.random.default_rng(7 + i))
        tb = specs.train_batch(reduced_config(ARCH), s, b, concrete=True,
                               rng=np.random.default_rng(7 + i), device="cpu")
        out.append((jb, tb))
    return out


# ---------------------------------------------------------------------------
# optimizer and compression on shared inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 5, 10, 55, 100, 150])
def test_schedule_matches_reference(step):
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = joptimizer.schedule(joptimizer.OptimizerConfig(**cfg), jnp.asarray(step))
    got = optimizer.schedule(OptimizerConfig(**cfg), torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=OPT_RTOL)


SHAPES = {"w": (8, 16), "t": (4, 3, 5), "b": (16,)}


def _opt_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=OPT_RTOL,
                               atol=OPT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("grad_clip", [1.0, 1e9])
def test_adamw_update_on_shared_gradients(grad_clip):
    """Three updates fed the same numpy gradients; at grad_clip 1.0 every
    step clips (norms of 10-30)."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=grad_clip)
    rng = np.random.default_rng(3)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jcfg, tcfg = joptimizer.OptimizerConfig(**cfg), OptimizerConfig(**cfg)
    js, ts = joptimizer.init_opt_state(jcfg, jp), optimizer.init_opt_state(tcfg, tp)
    for _ in range(3):
        g = {k: (rng.standard_normal(s) * 2).astype(np.float32) for k, s in SHAPES.items()}
        jp, js, jmet = joptimizer.adamw_update(jcfg, jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        tp2, ts2, tmet = optimizer.adamw_update(tcfg, tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        assert tp2 is tp and ts2 is ts   # in place
        for k in SHAPES:
            _opt_close(tp[k], jp[k])
            _opt_close(ts["mu"][k], js["mu"][k])
            _opt_close(ts["nu"][k], js["nu"][k])
        for m in ("grad_norm", "lr"):
            _opt_close(tmet[m], jmet[m])
        assert int(ts["step"]) == int(js["step"])
        assert float(tmet["grad_norm"]) > 1.0   # clipped at grad_clip 1.0


def test_grad_clip_bounds_update():
    """The reference's test: the norm is reported before clipping, and the
    clipped update equals the reference's."""
    cfg = dict(lr=0.1, warmup_steps=0, grad_clip=1.0, weight_decay=0.0)
    tp = {"w": torch.zeros(4)}
    ts = optimizer.init_opt_state(OptimizerConfig(**cfg), tp)
    _, _, metrics = optimizer.adamw_update(OptimizerConfig(**cfg), tp,
                                           {"w": torch.full((4,), 1e6)}, ts)
    assert metrics["grad_norm"] > 1e6
    jp = {"w": jnp.zeros(4)}
    jcfg = joptimizer.OptimizerConfig(**cfg)
    jp, _, _ = joptimizer.adamw_update(jcfg, jp, {"w": jnp.full(4, 1e6)},
                                       joptimizer.init_opt_state(jcfg, jp))
    _opt_close(tp["w"], jp["w"])


def test_quantize_int8_bit_equal():
    """Random rows, and a row whose quotients fall on .5 (round half to
    even in both packages)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 256)) * 3).astype(np.float32)
    x[0, :6] = [127.0, 2.5, -3.5, 0.5, 1.5, -0.5]
    x[0, 6:] = 0.0
    q, s = compression.quantize_int8(torch.from_numpy(x))
    jq, js = jcompression.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    np.testing.assert_array_equal(_np(s), np.asarray(js))
    assert _np(q)[0, :6].tolist() == [127, 2, -4, 0, 2, 0]
    np.testing.assert_array_equal(_np(compression.dequantize_int8(q, s)),
                                  np.asarray(jcompression.dequantize_int8(jq, js)))


def test_compressed_psum_grads_without_a_group():
    grads, efb = W.compress_inputs(0)
    want_g, want_e = jcompression.compressed_psum_grads(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in efb.items()})
    got_g, got_e = compression.compressed_psum_grads(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in efb.items()})
    for k in grads:
        np.testing.assert_array_equal(_np(got_g[k]), np.asarray(want_g[k]))
        np.testing.assert_array_equal(_np(got_e[k]), np.asarray(want_e[k]))


def test_compressed_psum_grads_over_a_gloo_group(tmp_path):
    """Two gloo ranks over a mesh dim's group against the reference under
    shard_map on two emulated host devices: the int32 sum of the int8
    payloads, the mean scale, the division by the group size."""
    proc = W.reference_process("compress", tmp_path / "ref.pkl", n_dev=2)
    try:
        ranks = W.run_world("compress", 2, tmp_path)
    finally:
        ref = W.wait_reference(proc, tmp_path / "ref.pkl")
    for (got_g, got_e), (want_g, want_e) in zip(ranks, ref):
        for k in W.COMPRESS_SHAPES:
            np.testing.assert_allclose(got_g[k], want_g[k], rtol=OPT_RTOL)
            np.testing.assert_allclose(got_e[k], want_e[k], rtol=OPT_RTOL)
    # the summed gradient is the same on both ranks; the error feedback is each rank's
    for k in W.COMPRESS_SHAPES:
        np.testing.assert_array_equal(ranks[0][0][k], ranks[1][0][k])
        assert not np.array_equal(ranks[0][1][k], ranks[1][1][k])


# ---------------------------------------------------------------------------
# gradients and train steps on the reduced tinyllama
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qk_scale", [0.25, 1.0])
def test_step1_gradients_match_jax_grad(qk_scale):
    jm, jstate, model, state, _, _ = _pair(qk_scale)
    (jb, tb), = _batches(1)
    jgrads = jax.jit(jax.grad(lambda p: jm.loss(p, jb)[0]))(jstate["params"])
    want = convert.params_from_jax(model.cfg, jax.tree.map(np.asarray, jgrads))
    loss, _ = model.loss(tb)
    names = list(state["params"])
    got = torch.autograd.grad(loss, [state["params"][k] for k in names])
    assert set(names) == set(want)
    for k, g in zip(names, got):
        w = want[k].numpy()
        assert np.abs(_np(g) - w).max() <= GRAD_REL[qk_scale] * np.abs(w).max(), k


def _close_metrics(got, want, keys=("loss", "ce", "grad_norm", "lr")):
    for k in keys:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=STEP_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("qk_scale", [0.25, 1.0])
def test_chained_train_steps_match_reference(qk_scale):
    jm, jstate, model, state, jt, tt = _pair(qk_scale)
    jstep = jax.jit(jtrain_loop.make_train_step(jm, jt))
    step = make_train_step(model, tt)
    n = CHAINED_STEPS[qk_scale]
    for jb, tb in _batches(n):
        jstate, jmet = jstep(jstate, jb)
        state, met = step(state, tb)
        assert set(met) == set(jmet) == {"loss", "ce", "moe_aux", "moe_dropped",
                                         "grad_norm", "lr"}
        _close_metrics(met, jmet)
        assert float(met["moe_aux"]) == 0.0 and int(met["moe_dropped"]) == 0
    assert int(state["step"]) == int(jstate["step"]) == n
    assert int(state["opt"]["step"]) == n


def test_train_state_carried_mid_run():
    """A compressed reference run's state after two steps (error feedback
    and counters included) carried into the port exactly, then one more
    step in each package."""
    jm, jstate, model, state, jt, tt = _pair(compress_grads=True)
    jstep = jax.jit(jtrain_loop.make_train_step(jm, jt))
    batches = _batches(3)
    for jb, _ in batches[:2]:
        jstate, _ = jstep(jstate, jb)
    convert.train_state_from_jax(model.cfg, jax.tree.map(np.asarray, jstate), state)
    for name in ("params", "error_fb"):
        want = convert.params_from_jax(model.cfg, jax.tree.map(np.asarray, jstate[name]))
        assert all(torch.equal(state[name][k], want[k]) for k in want)
    for m in ("mu", "nu"):
        want = convert.params_from_jax(model.cfg, jax.tree.map(np.asarray, jstate["opt"][m]))
        assert all(torch.equal(state["opt"][m][k], want[k]) for k in want)
    assert int(state["step"]) == int(state["opt"]["step"]) == 2
    assert state["params"]["embed.table"] is model.embed.table
    jstate, jmet = jstep(jstate, batches[2][0])
    state, met = make_train_step(model, tt)(state, batches[2][1])
    _close_metrics(met, jmet)


def test_grad_accum_matches_full_batch():
    """The reference's bounds for 2 microbatches against the full batch,
    and the port's accumulated step against the reference's."""
    jm, jstate, model1, s1, jt, _ = _pair(grad_accum=2)
    _, _, model2, s2, _, _ = _pair()
    (jb, tb), = _batches(1)
    s1b, m1 = make_train_step(model2, TrainConfig(opt=OptimizerConfig(**OPT)))(s2, tb)
    s2b, m2 = make_train_step(model1, TrainConfig(opt=OptimizerConfig(**OPT),
                                                  grad_accum=2))(s1, tb)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=2e-3)
    d = max(float((s1b["params"][k] - s2b["params"][k]).detach().abs().max())
            for k in s1b["params"])
    assert d < 5e-3
    _, jm2 = jax.jit(jtrain_loop.make_train_step(jm, jt))(jstate, jb)
    _close_metrics(m2, jm2)


def test_compressed_training_tracks_uncompressed():
    """int8+EF training must stay close to exact training on a small LM."""
    _, _, pmodel, plain_state, _, pt = _pair()
    _, _, cmodel, comp_state, _, ct = _pair(compress_grads=True)
    plain, comp = make_train_step(pmodel, pt), make_train_step(cmodel, ct)
    (_, batch), = _batches(1)
    for _ in range(10):
        plain_state, mp = plain(plain_state, batch)
        comp_state, mc = comp(comp_state, batch)
    assert float(mc["loss"]) < float(mp["loss"]) * 1.1 + 0.1


@pytest.mark.parametrize("remat", ["full", "selective"])
def test_remat_gives_equal_gradients(remat):
    """Remat changes what autograd keeps, not the values: gradients equal
    to remat "none" to the bit, with fewer bytes saved for the backward."""
    import dataclasses
    (_, tb), = _batches(1)
    grads, saved = {}, {}
    for mode in ("none", remat):
        cfg = dataclasses.replace(reduced_config(ARCH), remat=mode)
        model = build_model(cfg, device="cpu").requires_grad_(True)
        nbytes = []

        def pack(t):
            nbytes.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = model.loss(tb)
        saved[mode] = sum(nbytes)
        grads[mode] = torch.autograd.grad(loss, list(model.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(grads["none"], grads[remat]))
    assert saved[remat] < saved["none"]


# ---------------------------------------------------------------------------
# batches, the loader, the launcher
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpora():
    """The launcher's corpus in each package and each package's own
    dedup_corpus survivors (equal within one numpy version)."""
    jc = jsynthetic.generate(jsynthetic.SyntheticSpec(**LAUNCH_SPEC))
    tc = synthetic.generate(synthetic.SyntheticSpec(**LAUNCH_SPEC), device="cpu")
    jrep = jpipeline.dedup_corpus(jc, jhdb.HDBConfig(max_block_size=100))
    trep = pipeline.dedup_corpus(tc, hdb.HDBConfig(max_block_size=100), device="cpu")
    np.testing.assert_array_equal(trep.survivors, jrep.survivors)
    return jc, tc, jrep, trep


def test_train_batch_matches_reference():
    for rng in (None, np.random.default_rng(11)):
        jb = jspecs.train_batch(jreduced_config(ARCH), 24, 3, concrete=True, rng=rng)
        rng = None if rng is None else np.random.default_rng(11)
        tb = specs.train_batch(reduced_config(ARCH), 24, 3, concrete=True, rng=rng,
                               device="cpu")
        for k in ("tokens", "targets"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(_np(tb[k]), np.asarray(jb[k]))
    meta = specs.train_batch(reduced_config(ARCH), 24, 3)
    assert meta["tokens"].device.type == "meta" and meta["tokens"].shape == (3, 24)
    jb = jspecs.train_batch(jreduced_config("whisper-medium"), 24, 3, concrete=True,
                            rng=np.random.default_rng(11))
    tb = specs.train_batch(reduced_config("whisper-medium"), 24, 3, concrete=True,
                           rng=np.random.default_rng(11), device="cpu")
    assert set(tb) == set(jb) == {"frames", "tokens", "targets"}
    for k in jb:
        np.testing.assert_array_equal(_np(tb[k]), np.asarray(jb[k]))


@pytest.mark.parametrize("deduped", [False, True])
def test_loader_batches_match_reference(corpora, deduped):
    jc, tc, jrep, trep = corpora
    lcfg = dict(batch_size=4, seq_len=64, vocab_size=256)
    jl = jloader.TokenStreamLoader(jc, jloader.LoaderConfig(**lcfg),
                                   survivors=jrep.survivors if deduped else None)
    tl = loader.TokenStreamLoader(tc, loader.LoaderConfig(**lcfg),
                                  survivors=trep.survivors if deduped else None,
                                  device="cpu")
    np.testing.assert_array_equal(tl.stream, jl.stream)
    for step in (0, 1, 7, 10_000):
        for dp_rank, dp_size in ((0, 1), (0, 2), (1, 2)):
            want = jl.batch(step, dp_rank, dp_size)
            got = tl.batch(step, dp_rank, dp_size)
            for g, w in zip(got, want):
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(_np(g), w)
    with pytest.raises(ValueError, match="split"):
        tl.batch(0, 0, 3)


def test_launcher_dedups_trains_and_resumes(corpora, tmp_path):
    """The launcher on the CPU: the reference's dedup counts printed, six
    steps with a checkpoint every three; a run killed after step 3's
    checkpoint resumes to the bit of the uninterrupted run."""
    _launch_and_resume(ARCH, corpora, tmp_path)


def test_launcher_trains_and_resumes_the_moe_family(corpora, tmp_path):
    """The same on the reduced olmoe-1b-7b over a corpus of 500 entities:
    its expert tensors, router and AdamW moments saved and restored, the
    resumed run equal to the bit."""
    full = _launch_and_resume("olmoe-1b-7b", corpora, tmp_path, entities=500)
    assert any(k.endswith("moe.w_gate") for k in full.state["params"])


def _launch_and_resume(arch, corpora, tmp_path, entities=None):
    """``entities`` other than the launcher's default skips the check of the
    printed dedup counts against the reference's (the fixture's corpus)."""
    jc, _, jrep, _ = corpora
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--dedup",
            "--steps", "6", "--ckpt-every", "3"]
    if entities:
        argv += ["--entities", str(entities)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        full = train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    printed = out.getvalue()
    if entities is None:
        assert f"[train] dedup {jc.num_records} -> {jrep.num_survivors}\n" in printed
    assert "[train] dedup " in printed
    assert "[train] step 0 loss" in printed and "final loss" in printed
    assert full.start == 0 and len(full.losses) == 6 and np.isfinite(full.losses).all()
    assert [s for s, _, _ in full.saves] == [3, 6]
    assert int(full.state["step"]) == 6
    # killed after step 3's checkpoint: step 6's never written
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    shutil.rmtree(tmp_path / "b" / "step_0000000006")
    (tmp_path / "b" / "LATEST").write_text("3")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        resumed = train.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert "[train] resumed from step 3" in out.getvalue()
    assert resumed.start == 3 and int(resumed.state["step"]) == 6
    assert resumed.losses == full.losses[3:]
    assert all(torch.equal(resumed.state["params"][k], full.state["params"][k])
               for k in full.state["params"])
    for a, b in zip(resumed.loader.batch(3), full.loader.batch(3)):
        assert torch.equal(a, b)
    return full


def test_launcher_refuses_the_mesh_and_defaults_to_the_card(monkeypatch):
    """Outside a world of the production mesh's size (256 or 512 ranks)
    ``--mesh`` fails with the mesh's own error."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "1"]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for mesh, ranks in (("single", 256), ("multi", 512)):
        with pytest.raises(ValueError, match=f"process group of {ranks} ranks; this one has 1"):
            train.main(argv + ["--device", "cpu", "--mesh", mesh])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv)
