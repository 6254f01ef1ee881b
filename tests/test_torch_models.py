"""Port parity: the dense decoder (``repro_torch.models``, ``configs``) and
the LM ``ServingEngine`` against the JAX package.

The reference's ``model.init`` weights are carried across with
``convert.params_from_jax``; the port runs on the CPU in float32 (the
reduced configs' dtypes). Tolerance: logits, losses and caches within
rtol 1e-5 and atol 2e-4. Float32 products summed in another order, and
XLA's and PyTorch's exp, rsqrt, sin and cos, differ in the last bits, and
the reference's init (fan-in = heads for ``wq``) makes the softmax sharp
enough to amplify them: over 12 decode steps of the reduced tinyllama the
port's logits lie up to 7.5e-5 and the reference's up to 3.5e-5 from a
float64 evaluation of the same weights, so 1e-5 would hold float32
rounding against itself. A bfloat16 computation (eps 7.8e-3) fails by two
orders of magnitude. Greedy tokens, configs and parameter counts are
exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=2e-4)
DENSE = ["tinyllama-1.1b", "stablelm-3b"]


def _pair(arch, port_changes=None, **changes):
    """The reference model with its init params, and the port's model on
    the CPU carrying the same weights (``port_changes`` apply to the port's
    config only)."""
    cfg = dataclasses.replace(jconfigs.reduced_config(arch), **changes)
    tcfg = dataclasses.replace(configs.reduced_config(arch), **changes,
                               **(port_changes or {}))
    jm = jbuild_model(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tm.load_state_dict(convert.params_from_jax(tcfg, jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **TOL)


def _caches_close(cfg, got, want, scan_layers=None):
    scan = cfg.scan_layers if scan_layers is None else scan_layers
    tree = convert.caches_to_numpy(cfg, got, scan)
    flat_got, struct_got = jax.tree.flatten(tree)
    flat_want, struct_want = jax.tree.flatten(jax.tree.map(np.asarray, want))
    assert struct_got == struct_want
    for g, w in zip(flat_got, flat_want):
        assert g.shape == w.shape
        if g.dtype.kind == "i":
            assert np.array_equal(g, w)
        else:
            _close(g, w)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_configs_equal_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in jconfigs.ARCH_IDS:
        for get in ("get_config", "reduced_config"):
            got, want = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, get)
            assert got.q_dim == want.q_dim
            assert got.active_params() == want.active_params()
            assert got.total_params() == want.total_params()
            for i in range(got.num_layers):
                assert got.is_moe_layer(i) == want.is_moe_layer(i)
                assert got.is_attn_layer(i) == want.is_attn_layer(i)
            assert got.pdtype == getattr(torch, got.param_dtype)
            assert got.cdtype == getattr(torch, got.compute_dtype)
    with pytest.raises(KeyError):
        configs.get_config("gpt-unknown")
    assert ({k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()})
    assert shapes.all_cells() == jshapes.all_cells()
    for arch in jconfigs.ARCH_IDS:
        for shape in jshapes.SHAPES:
            assert shapes.applicable(arch, shape) == jshapes.applicable(arch, shape)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "stablelm-3b", "internlm2-20b",
                                  "mistral-nemo-12b"])
def test_parameter_count_at_full_width(arch):
    """On the meta device (nothing allocated): the reference's count plus
    the norm weights it leaves out (two a layer, one final)."""
    cfg = configs.get_config(arch)
    model = build_model(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.total_params() + 2 * cfg.num_layers * cfg.d_model + cfg.d_model
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-76b"])
def test_unsupported_families_raise(arch):
    """The last two families of the registry build (they raised until
    ROADMAP A10b-4): on the meta device, whisper-medium holds the
    reference's ``total_params()`` plus ``dec_pos`` (65,536 x d_model) and
    the norm weights, norm biases and MLP biases it leaves out; the vlm
    internvl2-76b holds the dense count (two norms a layer, one final)."""
    cfg = configs.get_config(arch)
    n = sum(p.numel() for p in build_model(cfg, device="meta").parameters())
    d = cfg.d_model
    if arch == "whisper-medium":
        extra = ((1 << 16) * d + cfg.encoder_layers * (5 * d + cfg.d_ff)
                 + cfg.decoder_layers * (7 * d + cfg.d_ff) + 4 * d)
        assert n == cfg.total_params() + extra == 825_357_312
    else:
        assert n == cfg.total_params() + 2 * cfg.num_layers * d + d


def test_unsupported_options_raise_and_the_card_is_the_default(monkeypatch):
    """MTP, MoE layers, MLA, the hybrid family's Mamba layers and an RWKV
    layer with a MoE FFN (a kind no config has; held against the
    reference in ``test_torch_encdec.py``) build on the dense config and
    run a forward, and so does the enc-dec family on frames; the card is
    the default."""
    cfg = configs.reduced_config("tinyllama-1.1b")
    mla = {k: getattr(configs.reduced_config("deepseek-v3-671b"), k)
           for k in ("q_lora_rank", "kv_lora_rank", "rope_head_dim", "nope_head_dim",
                     "v_head_dim")}
    moe = dict(moe_num_experts=4, moe_top_k=2, moe_d_ff=32)
    for change in (dict(mtp=True), moe, dict(use_mla=True, **mla),
                   dict(family="hybrid", attn_period=2), dict(family="ssm", **moe)):
        model = build_model(dataclasses.replace(cfg, **change), device="cpu")
        tokens = torch.ones((1, 4), dtype=torch.int32)
        logits, aux = model.apply({"tokens": tokens, "targets": tokens})
        assert logits.shape == (1, 4, cfg.vocab_size) and torch.isfinite(logits).all()
        assert ("mtp_logits" in aux) == bool(change.get("mtp"))
    encdec = dataclasses.replace(cfg, family="encdec", encoder_layers=1, decoder_layers=1)
    model = build_model(encdec, device="cpu")
    logits, aux = model.apply({"frames": torch.ones((1, 8, cfg.d_model)),
                               "tokens": torch.ones((1, 4), dtype=torch.int32)})
    assert logits.shape == (1, 4, cfg.vocab_size) and torch.isfinite(logits).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)


# ---------------------------------------------------------------------------
# forward, loss, decode
# ---------------------------------------------------------------------------


def _batch(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return tokens, targets


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("arch", DENSE)
def test_apply_and_loss_match_reference(arch, scan_layers):
    jm, params, tm = _pair(arch, scan_layers=scan_layers)
    tokens, targets = _batch(jm.cfg)
    logits, aux = jm.apply(params, {"tokens": jnp.asarray(tokens)})
    got, taux = tm.apply({"tokens": torch.from_numpy(tokens)})
    _close(got, logits)
    assert float(taux["moe_aux"]) == float(aux["moe_aux"]) == 0.0
    assert int(taux["moe_dropped"]) == int(aux["moe_dropped"]) == 0
    loss, metrics = jm.loss(params, {"tokens": jnp.asarray(tokens),
                                     "targets": jnp.asarray(targets)})
    tloss, tmetrics = tm.loss({"tokens": torch.from_numpy(tokens),
                               "targets": torch.from_numpy(targets)})
    _close(tloss, loss)
    _close(tmetrics["ce"], metrics["ce"])


@pytest.mark.parametrize("arch", DENSE)
def test_chunked_attention_matches_reference(arch):
    """attn_impl="chunked" (4-token chunks of a 12-token sequence) in the
    forward, and a prefill into the cache past attn_chunk_threshold."""
    jm, params, tm = _pair(arch, attn_impl="chunked", attn_chunk_size=4,
                           attn_chunk_threshold=8)
    tokens, _ = _batch(jm.cfg)
    logits, _ = jm.apply(params, {"tokens": jnp.asarray(tokens)})
    _close(tm(torch.from_numpy(tokens)), logits)
    jc = jm.init_caches(2, 16)
    tc = tm.init_caches(2, 16)
    want, jc = jm.prefill(params, {"tokens": jnp.asarray(tokens[:, :8])}, jc)
    got, tc = tm.prefill({"tokens": torch.from_numpy(tokens[:, :8])}, tc)
    _close(got, want)
    _caches_close(tm.cfg, tc, jc)
    # then decode steps on top of the prefilled cache
    for t in range(8, 12):
        want, jc = jm.decode_step(params, jnp.asarray(tokens[:, t:t + 1]), jc, None)
        got, tc = tm.decode_step(torch.from_numpy(tokens[:, t:t + 1]), tc)
        _close(got, want)
    _caches_close(tm.cfg, tc, jc)


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("max_len", [16, 8])
def test_chained_decode_steps_match_reference(arch, scan_layers, max_len):
    """12 chained decode steps: logits each step and the caches after. At
    max_len 8 the run passes the end of the cache: the write clamps to the
    last row while pos keeps growing (ROADMAP Queue C), in both packages.
    The reference is the scanned stack throughout: its unscanned decode
    fails at the second step (next test)."""
    jm, params, tm = _pair(arch, port_changes=dict(scan_layers=scan_layers))
    tokens, _ = _batch(jm.cfg, b=3, s=12, seed=1)
    step = jax.jit(jm.decode_step)
    jc = jm.init_caches(3, max_len)
    tc = tm.init_caches(3, max_len)
    _caches_close(tm.cfg, tc, jc, scan_layers=True)
    for t in range(12):
        want, jc = step(params, jnp.asarray(tokens[:, t:t + 1]), jc, None)
        got, tc = tm.decode_step(torch.from_numpy(tokens[:, t:t + 1]), tc)
        _close(got, want)
    _caches_close(tm.cfg, tc, jc, scan_layers=True)
    assert all(c["pos"] == 12 for c in tc)
    if max_len == 8:
        # the last row holds the last step's keys; row 6 the seventh step's
        k_last = tc[0]["k"][:, -1].clone()
        tm.decode_step(torch.from_numpy(tokens[:, :1]), tc)
        assert not torch.equal(tc[0]["k"][:, -1], k_last)
        assert tc[0]["pos"] == 13


def test_reference_unscanned_decode_fails_at_its_second_step():
    """A fault of the reference (ROADMAP Queue C): with scan_layers=False its
    stack returns the unit caches as [repeat][entry] but reads them as
    [entry][repeat], so a second decode step raises IndexError. The port
    keeps one cache a layer, whatever scan_layers says."""
    jm, params, tm = _pair("tinyllama-1.1b", scan_layers=False)
    tok = jnp.ones((2, 1), jnp.int32)
    _, jc = jm.decode_step(params, tok, jm.init_caches(2, 8), None)
    with pytest.raises(IndexError):
        jm.decode_step(params, tok, jc, None)
    tc = tm.init_caches(2, 8)
    for _ in range(2):
        tm.decode_step(torch.ones((2, 1), dtype=torch.int32), tc)
    assert [c["pos"] for c in tc] == [2] * tm.cfg.num_layers


@pytest.mark.parametrize("arch", DENSE)
def test_caches_round_trip_through_convert(arch):
    jm, params, tm = _pair(arch)
    tokens, _ = _batch(jm.cfg, b=2, s=5, seed=4)
    jc = jm.init_caches(2, 8)
    for t in range(5):
        _, jc = jm.decode_step(params, jnp.asarray(tokens[:, t:t + 1]), jc, None)
    tc = convert.caches_from_jax(tm.cfg, jax.tree.map(np.asarray, jc), "cpu")
    assert [c["pos"] for c in tc] == [5] * tm.cfg.num_layers
    _caches_close(tm.cfg, tc, jc)
    # a step from the carried caches equals the reference's next step
    want, _ = jm.decode_step(params, jnp.asarray(tokens[:, :1]), jc, None)
    got, _ = tm.decode_step(torch.from_numpy(tokens[:, :1]), tc)
    _close(got, want)


def test_decode_rotates_at_position_zero_in_both_packages():
    """Quirk (ROADMAP Queue C): decode passes no positions, so the key a
    token writes at cache row 3 equals the one it writes at row 0 — RoPE
    rotated both at position 0. A rotation at the true position would
    differ."""
    jm, params, tm = _pair("tinyllama-1.1b")
    tok = np.full((1, 1), 7, np.int32)
    jc = jm.init_caches(1, 8)
    tc = tm.init_caches(1, 8)
    for _ in range(4):
        _, jc = jm.decode_step(params, jnp.asarray(tok), jc, None)
        tm.decode_step(torch.from_numpy(tok), tc)
    jk = np.asarray(jc["unit"][0]["k"][0, 0])     # layer 0: (S, KV, hd)
    tk = tc[0]["k"][0].numpy()
    np.testing.assert_array_equal(jk[3], jk[0])
    np.testing.assert_array_equal(tk[3], tk[0])
    # what a true rotation at position 3 would give instead
    from repro_torch.models import layers
    k0 = torch.from_numpy(tk[0:1][None])            # (1, 1, KV, hd), rotated at 0
    at3 = layers.apply_rope(k0, torch.tensor([[3]]), tm.cfg.rope_theta)
    assert not torch.allclose(at3, k0)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


def _requests(cfg, n, max_new, seed=0, lo=2, hi=8):
    """examples/serve_lm.py's traffic."""
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n):
        prompt = rng.integers(1, cfg.vocab_size, rng.integers(lo, hi)).astype(np.int32)
        out.append((uid, prompt))
    return out


@pytest.mark.parametrize("arch", DENSE)
def test_serving_engine_matches_reference(arch):
    """6 requests over 4 slots (examples/serve_lm.py): the same tokens,
    request for request, as the reference engine on the same weights."""
    jm, params, tm = _pair(arch)
    jeng = JServingEngine(jm, params, batch_slots=4, max_len=256)
    teng = ServingEngine(tm, batch_slots=4, max_len=256)
    for uid, prompt in _requests(jm.cfg, 6, 16):
        jeng.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=16, eos_id=-1))
        teng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=16, eos_id=-1))
    want = {r.uid: r.tokens for r in jeng.run()}
    got = {r.uid: r.tokens for r in teng.run()}
    assert got == want
    assert sorted(got) == list(range(6)) and all(len(t) == 16 for t in got.values())
    assert teng.pos == int(np.asarray(jeng.caches["unit"][0]["pos"][0]))


def test_serving_engine_eos_and_truncated_run():
    jm, params, tm = _pair("tinyllama-1.1b")
    reqs = _requests(jm.cfg, 3, 8, seed=2)
    # request 0's first greedy token (in this traffic) as its eos: it then
    # stops after one token
    probe = JServingEngine(jm, params, batch_slots=2, max_len=64)
    for uid, prompt in reqs:
        probe.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=8, eos_id=-1))
    eos = {r.uid: r.tokens for r in probe.run()}[0][0]
    jeng = JServingEngine(jm, params, batch_slots=2, max_len=64)
    teng = ServingEngine(tm, batch_slots=2, max_len=64)
    for uid, prompt in reqs:
        jeng.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=8,
                             eos_id=int(eos) if uid == 0 else -1))
        teng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=8,
                            eos_id=int(eos) if uid == 0 else -1))
    with pytest.warns(RuntimeWarning, match="in-flight"):
        teng.run(max_steps=2)
    with pytest.warns(RuntimeWarning, match="in-flight"):
        jeng.run(max_steps=2)
    got = {r.uid: r.tokens for r in teng.run()}
    want = {r.uid: r.tokens for r in jeng.run()}
    assert got == want
    assert got[0] == [eos]


def test_admission_writes_every_slot_in_both_packages():
    """Quirk (ROADMAP Queue C): admitting one request prefills its prompt
    through the shared decode step with token 0 in the other slots, so
    the idle slot's cache gains the same rows and the shared pos advances
    for both."""
    jm, params, tm = _pair("tinyllama-1.1b")
    prompt = np.array([5, 9, 11, 3, 7], np.int32)
    jeng = JServingEngine(jm, params, batch_slots=2, max_len=16)
    teng = ServingEngine(tm, batch_slots=2, max_len=16)
    jeng.submit(JRequest(uid=0, prompt=prompt))
    teng.submit(Request(uid=0, prompt=prompt))
    jeng._admit()
    teng._admit()
    assert teng.pos == int(np.asarray(jeng.caches["unit"][0]["pos"][0])) == 4
    for c in teng.caches:
        assert c["k"][1, :4].abs().sum(dim=(1, 2)).gt(0).all()   # idle slot written
        assert not c["k"][:, 4:].any()
    _caches_close(tm.cfg, teng.caches, jeng.caches)
