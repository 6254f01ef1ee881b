"""Port parity: the encoder-decoder family (``repro_torch.models.encdec``,
``layers.layer_norm`` and ``GeluMLP``, cross-attention, ``EncDecModel``),
the VLM patch prefix, ``launch/specs`` for every family, and the
``("rwkv", "moe")`` layer kind, against the JAX package, at the reduced
whisper-medium (2 encoder and 2 decoder layers), internvl2-76b (4 layers,
4 patches) and rwkv6-1.6b with 4 experts top-2 configs.

The reference's ``init`` weights are carried across with
``convert.params_from_jax``; the port runs on the CPU in float32.
Tolerances:

- layer norm, the GELU MLP, the layers, encode, the logits, losses and
  caches within rtol 1e-5 / atol 2e-4 (``test_torch_models.py``'s bound),
  except whisper's logits from the frames: atol 5e-4. Its embedding is
  tied and drawn at scale 1, so the logits reach 15, and the encoder's
  rounding passes through the cross-attention: the reduced model's
  logits on a (2, 24)-frame batch lie up to 2.5e-4 (the port) and 3.3e-4
  (the reference) from a float64 evaluation of the same weights;
- one train step's loss, ce, moe_aux, grad_norm and lr within rtol 1e-4
  (the train-step bound of ``test_torch_recurrent.py``);
- the decay set: one AdamW update on zero gradients (weight decay alone)
  within rtol 1e-6, leaf by leaf;
- ``train_batch`` and ``decode_inputs`` bitwise; the dropped counts and
  the parameter counts exactly.

Each reference function is compiled once a module. Three faults of the
reference are pinned in both packages (ROADMAP Queue C): the encdec
``prefill`` decodes the prompt's last token only (LM fault 7), the
``ServingEngine`` cannot serve the encdec family (LM fault 8), and the
training launcher cannot train it (training fault 5).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.training import optimizer as joptimizer  # noqa: E402
from repro.training import train_loop as jtrain_loop  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import convert, encdec, layers  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.training.optimizer import OptimizerConfig, adamw_update  # noqa: E402
from repro_torch.training.train_loop import (TrainConfig, decayed_names,  # noqa: E402
                                             init_train_state, make_train_step)

TOL = dict(rtol=1e-5, atol=2e-4)
WHISPER_LOGITS = dict(rtol=1e-5, atol=5e-4)
STEP_RTOL = 1e-4
DECAY_RTOL = 1e-6
WHISPER, VLM, RWKV = "whisper-medium", "internvl2-76b", "rwkv6-1.6b"
RWKV_MOE = dict(moe_num_experts=4, moe_top_k=2, moe_d_ff=32)
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=100)
# the archs tests/test_models_smoke.py::test_smoke_decode_step runs
DECODE_ARCHS = ["tinyllama-1.1b", RWKV, "olmoe-1b-7b", WHISPER, "jamba-1.5-large-398b",
                "deepseek-v3-671b"]


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree, prefix=""):
    """A nested dict of arrays -> {dotted name: tensor}."""
    return {name: _t(x) for name, x in convert._leaves(tree, prefix)}


def _cfgs(arch, **changes):
    return (dataclasses.replace(jconfigs.reduced_config(arch), **changes),
            dataclasses.replace(configs.reduced_config(arch), **changes))


# ---------------------------------------------------------------------------
# the reference, each function compiled once
# ---------------------------------------------------------------------------

_KEYS = {WHISPER: (), VLM: (), RWKV: tuple(sorted(RWKV_MOE.items()))}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(reference model, its init params as numpy, its compiled functions)
    at the reduced config (rwkv6 with 4 experts top-2)."""
    jcfg, _ = _cfgs(arch, **dict(_KEYS[arch]))
    jm = jbuild_model(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jt = jtrain_loop.TrainConfig(opt=joptimizer.OptimizerConfig(**OPT))
    fns = {"forward": jax.jit(lambda p, b: (jm.apply(p, b), jm.loss(p, b))),
           "decode": jax.jit(jm.decode_step),
           "prefill": jax.jit(jm.prefill),
           "step": jax.jit(jtrain_loop.make_train_step(jm, jt))}
    return jm, params, fns


def _pair(arch):
    jm, params, fns = _reference(arch)
    _, tcfg = _cfgs(arch, **dict(_KEYS[arch]))
    tm = build_model(tcfg, device="cpu")
    tm.load_state_dict(convert.params_from_jax(tcfg, params))
    return jm, params, fns, tm


def _caches_close(cfg, got, want):
    tree = convert.caches_to_numpy(cfg, got, True)
    flat_got, struct_got = jax.tree.flatten(tree)
    flat_want, struct_want = jax.tree.flatten(jax.tree.map(np.asarray, want))
    assert struct_got == struct_want
    for g, w in zip(flat_got, flat_want):
        assert g.shape == w.shape
        if g.dtype.kind == "i":
            assert np.array_equal(g, w)
        else:
            _close(g, w)


def _both(batch):
    """A numpy batch as the reference's arrays and the port's tensors."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


def _whisper_batch(cfg, b=2, frames=24, s=6, seed=0):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((b, frames, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _vlm_batch(cfg, b=2, s=6, seed=0):
    rng = np.random.default_rng(seed)
    return {"patches": rng.standard_normal((b, cfg.num_patches, cfg.d_model)
                                           ).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_layer_norm_and_gelu_mlp_match_reference():
    jcfg, tcfg = _cfgs(WHISPER)
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 5, jcfg.d_model)) + 1.5).astype(np.float32)
    w, b = (rng.standard_normal(jcfg.d_model).astype(np.float32) for _ in range(2))
    want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jcfg.norm_eps)
    _close(layers.layer_norm(_t(x), _t(w), _t(b), tcfg.norm_eps), want)

    p = jlayers.gelu_mlp_init(jax.random.PRNGKey(3), jcfg)["mlp"]
    p = {k: np.asarray(v) + (0.1 if k.startswith("b_") else 0.0) for k, v in p.items()}
    mlp = layers.GeluMLP(tcfg, "cpu", None)
    mlp.load_state_dict(_flat(p))
    want = jlayers.gelu_mlp_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    _close(mlp(_t(x)), want)
    # the tanh approximation: the exact erf GELU parts from it
    h = _t(x) @ mlp.w_up + mlp.b_up
    exact = torch.nn.functional.gelu(h) @ mlp.w_down + mlp.b_down
    assert float((exact - mlp(_t(x))).abs().max()) > 1e-5


def test_encoder_and_decoder_layers_match_reference():
    jcfg, tcfg = _cfgs(WHISPER)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    enc_out = rng.standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    pe = jax.tree.map(np.asarray, jencdec._enc_layer_init(jax.random.PRNGKey(1), jcfg))
    pd = jax.tree.map(np.asarray, jencdec._dec_layer_init(jax.random.PRNGKey(2), jcfg))
    enc_layer = encdec.EncoderLayer(tcfg, "cpu", None)
    enc_layer.load_state_dict(_flat(pe))
    dec_layer = encdec.DecoderLayer(tcfg, "cpu", None)
    dec_layer.load_state_dict(_flat(pd))
    with torch.no_grad():
        _close(enc_layer(_t(x)), jencdec._enc_layer_apply(pe, jnp.asarray(x), jcfg))
        got, cache = dec_layer(_t(x), _t(enc_out))
    want, _ = jencdec._dec_layer_apply(pd, jnp.asarray(x), jnp.asarray(enc_out), jcfg)
    assert cache is None
    _close(got, want)


# ---------------------------------------------------------------------------
# whisper: encode, decode_train, decode steps, prefill, the engine, training
# ---------------------------------------------------------------------------


def test_encode_decode_train_and_loss_match_reference():
    jm, params, fns, tm = _pair(WHISPER)
    jb, tb = _both(_whisper_batch(jm.cfg))
    enc_out = jencdec.encode(params, jb["frames"], jm.cfg)
    got = tm.encode(tb["frames"])
    _close(got, enc_out)
    _close(tm.decode_train(tb["tokens"], got),
           jencdec.decode_train(params, jb["tokens"], enc_out, jm.cfg), **WHISPER_LOGITS)
    (logits, aux), (loss, metrics) = fns["forward"](params, jb)
    tlogits, taux = tm.apply(tb)
    _close(tlogits, logits, **WHISPER_LOGITS)
    assert set(taux) == set(aux) and float(taux["moe_aux"]) == 0.0
    assert taux["moe_dropped"].dtype == torch.int32 and int(taux["moe_dropped"]) == 0
    tloss, tmetrics = tm.loss(tb)
    assert set(tmetrics) == set(metrics) == {"ce"}
    _close(tloss, loss)
    _close(tmetrics["ce"], metrics["ce"])


def test_chained_decode_steps_and_caches_match_reference():
    """Four decode steps over the encoder output into 8-row caches: the
    logits each step and the caches after; the caches round-trip through
    ``convert``; the reference's caches carried into the port give its
    next step."""
    jm, params, fns, tm = _pair(WHISPER)
    batch = _whisper_batch(jm.cfg, s=5, seed=2)
    enc_out = np.asarray(jencdec.encode(params, jnp.asarray(batch["frames"]), jm.cfg))
    jc, tc = jm.init_caches(2, 8), tm.init_caches(2, 8)
    _caches_close(tm.cfg, tc, jc)
    for t in range(4):
        tok = batch["tokens"][:, t:t + 1]
        want, jc = fns["decode"](params, jnp.asarray(tok), jc, {"enc_out": enc_out})
        got, tc = tm.decode_step(_t(tok), tc, {"enc_out": _t(enc_out)})
        _close(got, want)
    _caches_close(tm.cfg, tc, jc)
    assert np.asarray(jc["pos"]).shape == (jm.cfg.decoder_layers,)
    carried = convert.caches_from_jax(tm.cfg, jax.tree.map(np.asarray, jc), "cpu")
    _caches_close(tm.cfg, carried, jc)
    tok = batch["tokens"][:, 4:5]
    want, _ = fns["decode"](params, jnp.asarray(tok), jc, {"enc_out": enc_out})
    _close(tm.decode_step(_t(tok), carried, {"enc_out": _t(enc_out)})[0], want)


def test_prefill_decodes_the_last_prompt_token_only_in_both_packages():
    """LM fault 7: ``prefill`` encodes the frames and decodes
    ``tokens[:, -1:]`` alone, so the caches hold one row and its logits
    equal a single decode step of the last token; stepping the whole
    prompt gives other logits."""
    jm, params, fns, tm = _pair(WHISPER)
    jb, tb = _both(_whisper_batch(jm.cfg, s=5, seed=3))
    want, jc = fns["prefill"](params, jb, jm.init_caches(2, 8))
    got, tc = tm.prefill(tb, tm.init_caches(2, 8))
    _close(got, want)
    _caches_close(tm.cfg, tc, jc)
    assert [c["pos"] for c in tc] == [1] * jm.cfg.decoder_layers
    enc_out = tm.encode(tb["frames"])
    one, _ = tm.decode_step(tb["tokens"][:, -1:], tm.init_caches(2, 8), {"enc_out": enc_out})
    torch.testing.assert_close(got, one, rtol=0, atol=0)
    caches = tm.init_caches(2, 8)
    for t in range(5):
        stepped, caches = tm.decode_step(tb["tokens"][:, t:t + 1], caches,
                                         {"enc_out": enc_out})
    assert float((stepped - got).abs().max()) > 1e-3
    jone, _ = fns["decode"](params, jb["tokens"][:, -1:], jm.init_caches(2, 8),
                            {"enc_out": jencdec.encode(params, jb["frames"], jm.cfg)})
    np.testing.assert_array_equal(np.asarray(want), np.asarray(jone))


def test_serving_engine_cannot_serve_encdec_in_both_packages():
    """LM fault 8: the engine's decode step passes no batch, and the encdec
    ``decode_step`` reads ``batch["enc_out"]``."""
    jm, params, _, tm = _pair(WHISPER)
    prompt = np.array([3, 5, 7], np.int32)
    jeng = JServingEngine(jm, params, batch_slots=2, max_len=16)
    jeng.submit(JRequest(uid=0, prompt=prompt, max_new_tokens=2, eos_id=-1))
    with pytest.raises(TypeError, match="not subscriptable"):
        jeng.run()
    teng = ServingEngine(tm, batch_slots=2, max_len=16)
    teng.submit(Request(uid=0, prompt=prompt, max_new_tokens=2, eos_id=-1))
    with pytest.raises(TypeError, match="not subscriptable"):
        teng.run()


def test_launcher_cannot_train_encdec_in_both_packages(tmp_path):
    """Training fault 5: the launcher feeds ``{"tokens", "targets"}`` only,
    and the encdec ``apply`` reads ``batch["frames"]``."""
    argv = ["--arch", WHISPER, "--reduced", "--steps", "1", "--batch", "2", "--seq",
            "16", "--entities", "40"]
    with pytest.raises(KeyError, match="frames"):
        jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "jax")])
    with pytest.raises(KeyError, match="frames"):
        train.main(argv + ["--ckpt-dir", str(tmp_path / "torch"), "--device", "cpu"])


# ---------------------------------------------------------------------------
# the VLM patch prefix
# ---------------------------------------------------------------------------


def test_vlm_apply_and_loss_match_reference():
    jm, params, fns, tm = _pair(VLM)
    jb, tb = _both(_vlm_batch(jm.cfg))
    (logits, aux), (loss, metrics) = fns["forward"](params, jb)
    got, taux = tm.apply(tb)
    assert got.shape == (2, 6, jm.cfg.vocab_size)
    _close(got, logits)
    tloss, tmetrics = tm.loss(tb)
    assert set(tmetrics) == set(metrics)
    _close(tloss, loss)
    # the patches move every text position's logits
    plain, _ = tm.apply({"tokens": tb["tokens"]})
    assert float((plain - got).abs().max()) > 1e-3


def test_vlm_patch_prefill_then_decode_matches_reference():
    """4 patches and 6 tokens (10 rows) into 16-row caches, then 2 decode
    steps, which take no patches."""
    jm, params, fns, tm = _pair(VLM)
    batch = _vlm_batch(jm.cfg, seed=4)
    jb, tb = _both({k: batch[k] for k in ("patches", "tokens")})
    want, jc = fns["prefill"](params, jb, jm.init_caches(2, 16))
    got, tc = tm.prefill(tb, tm.init_caches(2, 16))
    _close(got, want)
    _caches_close(tm.cfg, tc, jc)
    assert all(c["pos"] == jm.cfg.num_patches + 6 for c in tc)
    for t in range(2):
        tok = batch["targets"][:, t:t + 1]
        want, jc = fns["decode"](params, jnp.asarray(tok), jc, None)
        got, tc = tm.decode_step(_t(tok), tc)
        _close(got, want)
    _caches_close(tm.cfg, tc, jc)


# ---------------------------------------------------------------------------
# training: one step of each family, the decay set
# ---------------------------------------------------------------------------


def _train_pair(arch):
    jm, params, fns, _ = _pair(arch)
    _, tcfg = _cfgs(arch, **dict(_KEYS[arch]))
    jt = jtrain_loop.TrainConfig(opt=joptimizer.OptimizerConfig(**OPT))
    jstate = {"params": jax.tree.map(jnp.asarray, params),
              "opt": joptimizer.init_opt_state(jt.opt, params),
              "step": jnp.zeros((), jnp.int32)}
    model = build_model(tcfg, device="cpu")
    state = init_train_state(model, TrainConfig(opt=OptimizerConfig(**OPT)))
    convert.train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate), state)
    return jm, fns, jstate, model, state


@pytest.mark.parametrize("arch,seq", [(WHISPER, 64), (VLM, 16), (RWKV, 16)])
def test_one_train_step_matches_reference(arch, seq):
    """One step of the reference's ``make_train_step`` and the port's on
    ``train_batch(cfg, seq, 2)``: whisper's 64 frames and 8 tokens,
    internvl's 4 patches and 12 tokens, the rwkv+moe kind's 16 tokens."""
    jm, fns, jstate, model, state = _train_pair(arch)
    jcfg, tcfg = _cfgs(arch, **dict(_KEYS[arch]))
    jb = jspecs.train_batch(jcfg, seq, 2, concrete=True, rng=np.random.default_rng(7))
    tb = specs.train_batch(tcfg, seq, 2, concrete=True, rng=np.random.default_rng(7),
                           device="cpu")
    _, jmet = fns["step"](jstate, jb)
    _, met = make_train_step(model, TrainConfig(opt=OptimizerConfig(**OPT)))(state, tb)
    assert set(met) == set(jmet)
    for k in set(met) - {"moe_dropped"}:
        np.testing.assert_allclose(_np(met[k]), np.asarray(jmet[k]), rtol=STEP_RTOL,
                                   atol=1e-12, err_msg=k)
    if "moe_dropped" in met:
        assert int(met["moe_dropped"]) == int(jmet["moe_dropped"])
    assert int(state["step"]) == 1


def test_weight_decay_set_follows_the_reference_tree():
    """Training fault 4 in the encdec family: the reference stacks ``enc``
    and ``dec`` whatever ``scan_layers`` says, so every layer's norms and
    MLP biases are decayed, and the 1-D final norms not. One AdamW update
    on zero gradients moves only the decayed leaves, by lr x 0.1 x p; the
    port's equals the reference's on every leaf."""
    jm, _, jstate, model, state = _train_pair(WHISPER)
    update = jax.jit(functools.partial(joptimizer.adamw_update,
                                       joptimizer.OptimizerConfig(**OPT)))
    zeros = jax.tree.map(jnp.zeros_like, jstate["params"])
    jparams, _, _ = update(jstate["params"], zeros, jstate["opt"])
    decayed = decayed_names(model)
    params = state["params"]
    adamw_update(OptimizerConfig(**OPT), params,
                 {k: torch.zeros_like(p) for k, p in params.items()}, state["opt"], decayed)
    want = convert.params_from_jax(model.cfg, jax.tree.map(np.asarray, jparams))
    assert set(want) == set(params)
    for k, p in params.items():
        np.testing.assert_allclose(_np(p), want[k].numpy(), rtol=DECAY_RTOL, atol=0,
                                   err_msg=k)
    for k in ("enc.0.ln1", "enc.1.mlp.b_up", "dec.1.ln_cross_b", "dec.0.mlp.b_down",
              "dec_pos", "embed.table", "dec.0.cross.wq"):
        assert k in decayed, k
    assert not decayed & {"enc_ln", "enc_ln_b", "dec_ln", "dec_ln_b"}


# ---------------------------------------------------------------------------
# the ("rwkv", "moe") layer kind
# ---------------------------------------------------------------------------


def test_rwkv_moe_kind_forward_and_decode_match_reference():
    """An ssm config with 4 experts top-2 builds ``("rwkv", "moe")`` layers
    (the reference builds them; no config of the registry has them): the
    forward, the loss with its MoE terms, and 3 chained decode steps."""
    jm, params, fns, tm = _pair(RWKV)
    assert {layer.spec for layer in tm.stack.layers} == {("rwkv", "moe")}
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)
    targets = rng.integers(0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)
    jb, tb = _both({"tokens": tokens, "targets": targets})
    (logits, aux), (loss, metrics) = fns["forward"](params, jb)
    got, taux = tm.apply(tb)
    _close(got, logits)
    _close(taux["moe_aux"], aux["moe_aux"])
    assert int(taux["moe_dropped"]) == int(aux["moe_dropped"])
    tloss, tmetrics = tm.loss(tb)
    _close(tloss, loss)
    assert set(tmetrics) == set(metrics)
    jc, tc = jm.init_caches(2, 8), tm.init_caches(2, 8)
    for t in range(3):
        want, jc = fns["decode"](params, jnp.asarray(tokens[:, t:t + 1]), jc, None)
        got, tc = tm.decode_step(_t(tokens[:, t:t + 1]), tc)
        _close(got, want)
    _caches_close(tm.cfg, tc, jc)


# ---------------------------------------------------------------------------
# launch/specs: train_batch and decode_inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_train_batch_matches_reference_bitwise(arch):
    jcfg, tcfg = _cfgs(arch)
    for seed in (None, 11):
        jb = jspecs.train_batch(jcfg, 48, 3, concrete=True,
                                rng=None if seed is None else np.random.default_rng(seed))
        tb = specs.train_batch(tcfg, 48, 3, concrete=True,
                               rng=None if seed is None else np.random.default_rng(seed),
                               device="cpu")
        assert set(tb) == set(jb)
        for k in jb:
            assert tb[k].dtype == (torch.int32 if k in ("tokens", "targets") else torch.float32)
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
    text = 8 if arch == WHISPER else 48 - tcfg.num_patches
    assert tb["tokens"].shape == (3, text)
    meta = specs.train_batch(tcfg, 48, 3)
    assert all(v.device.type == "meta" and v.shape == tb[k].shape and v.dtype == tb[k].dtype
               for k, v in meta.items())


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_inputs_match_reference(arch):
    """The token, the caches (every ``pos`` at seq_len - 1) and whisper's
    ``enc_out`` equal the reference's bitwise, and one port decode step on
    them gives finite logits; without ``concrete`` the same shapes on the
    meta device."""
    jcfg, tcfg = _cfgs(arch)
    jm = jbuild_model(jcfg)
    tm = build_model(tcfg, device="cpu")
    jtok, jc, jex = jspecs.decode_inputs(jm, 16, 2, concrete=True,
                                         rng=np.random.default_rng(5))
    tok, tc, ex = specs.decode_inputs(tm, 16, 2, concrete=True,
                                      rng=np.random.default_rng(5))
    assert tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert set(ex) == set(jex)
    for k in jex:
        np.testing.assert_array_equal(ex[k].numpy(), np.asarray(jex[k]))
    tree = convert.caches_to_numpy(tcfg, tc, tcfg.scan_layers)
    flat_got, struct_got = jax.tree.flatten(tree)
    flat_want, struct_want = jax.tree.flatten(jax.tree.map(np.asarray, jc))
    assert struct_got == struct_want
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, w)
    logits, _ = tm.decode_step(tok, tc, ex or None)
    assert logits.shape == (2, 1, tcfg.vocab_size) and torch.isfinite(logits).all()
    mtok, mc, mex = specs.decode_inputs(tm, 16, 2)
    assert mtok.device.type == "meta" and all(
        v.device.type == "meta" for c in mc for v in c.values() if isinstance(v, torch.Tensor))
    assert {k: v.shape for k, v in mex.items()} == {k: v.shape for k, v in ex.items()}
