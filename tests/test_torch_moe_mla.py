"""Port parity: the MoE family and MLA with multi-token prediction
(``repro_torch.models.moe``, ``mla``, the MoE/MLA layer kinds of
``transformer``, the MTP head of ``model``) against the JAX package, at
the reduced olmoe-1b-7b (4 layers, 8 experts top-2) and deepseek-v3-671b
(2 dense then 3 MoE MLA layers, 1 shared expert, MTP) configs.

The reference's ``init`` weights are carried across with
``convert.params_from_jax``; the port runs on the CPU in float32.
Tolerances:

- routing: ``top_e`` and the expert ranks exactly; ``top_w`` and the aux
  loss within rtol 1e-5;
- ``moe_dropped``, the greedy tokens of the ``ServingEngine`` and the
  parameter counts exactly;
- the MoE output, MLA on each path, logits, MTP logits, losses and
  caches within rtol 1e-5 / atol 2e-4 (``test_torch_models.py``'s bound,
  for the same reason: float32 products summed in another order under a
  softmax the init sharpens);
- step-1 gradients: each leaf within ``GRAD_REL`` of that leaf's max
  |g|, on the reference's init with the query and key projections
  (``wq``/``wk``, MLA's ``w_uq``/``w_ukv``) scaled by 1/4 (measured
  1.5e-6 olmoe, 2.0e-6 deepseek) and unscaled (2.1e-4, 2.4e-5), the
  fan-in quirk sharpening the softmax as in ``test_torch_training.py``;
- loss, ce, moe_aux, mtp_ce, grad_norm and lr within rtol 1e-4 over 5
  chained train steps at the 1/4 scale (measured 8.6e-7), and one step
  at the reference's init (2.3e-5). Later steps on that init part, as
  the dense decoder's do (olmoe 1.2e-2 at step 3, 0.27 at step 4).
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
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.training import optimizer as joptimizer  # noqa: E402
from repro.training import train_loop as jtrain_loop  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import convert, layers, mla, moe  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.training.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.training.smoke import QK_WEIGHTS  # noqa: E402
from repro_torch.training.train_loop import (TrainConfig, init_train_state,  # noqa: E402
                                             make_train_step)

TOL = dict(rtol=1e-5, atol=2e-4)
ROUTE_RTOL = 1e-5
ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b"]
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=100)
# each leaf's max |g|, by the scale of the query and key projections
GRAD_REL = {0.25: 1e-5, 1.0: 5e-4}
STEP_RTOL = 1e-4
CHAINED_STEPS = {0.25: 5, 1.0: 1}


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _cfgs(arch, **changes):
    return (dataclasses.replace(jconfigs.reduced_config(arch), **changes),
            dataclasses.replace(configs.reduced_config(arch), **changes))


@functools.lru_cache(maxsize=None)
def _init_params(arch):
    """The reference's init params of the reduced config (scanned; numpy
    leaves), drawn once a module."""
    jm = jbuild_model(jconfigs.reduced_config(arch))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _key(arch, changes):
    """``changes`` without the fields the reduced config already has."""
    base = dataclasses.asdict(jconfigs.reduced_config(arch))
    return tuple(sorted((k, v) for k, v in changes.items() if base[k] != v))


@functools.lru_cache(maxsize=None)
def _reference(arch, changes=()):
    """The reference model and params (numpy leaves): the init params, the
    scanned unit split into per-repeat trees where ``scan_layers`` is
    off (the changes tested touch no other parameter shape)."""
    jcfg, _ = _cfgs(arch, **dict(changes))
    params = _init_params(arch)
    if not jcfg.scan_layers:
        n = jbuild_model(jcfg).cfg.num_layers
        prefix = len(params["layers"]["prefix"])
        n_repeat = (n - prefix) // len(params["layers"]["unit"])
        unit = [[jax.tree.map(lambda a, r=r: a[r], entry) for r in range(n_repeat)]
                for entry in params["layers"]["unit"]]
        params = {**params, "layers": {"prefix": params["layers"]["prefix"], "unit": unit}}
    return jbuild_model(jcfg), params


@functools.lru_cache(maxsize=None)
def _jitted(arch, changes=()):
    """The reference's functions on its model, each compiled once."""
    jm, _ = _reference(arch, changes)
    jt = jtrain_loop.TrainConfig(opt=joptimizer.OptimizerConfig(**OPT))
    return {"forward": jax.jit(lambda p, b: (jm.apply(p, b), jm.loss(p, b))),
            "decode": jax.jit(jm.decode_step),
            "prefill": jax.jit(jm.prefill),
            "grad": jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0])),
            "train_step": jax.jit(jtrain_loop.make_train_step(jm, jt))}


def _pair(arch, port_changes=None, **changes):
    """(reference model, its params, the port's model on the CPU with the
    same weights); ``port_changes`` apply to the port's config only."""
    jm, params = _reference(arch, _key(arch, changes))
    _, tcfg = _cfgs(arch, **changes, **(port_changes or {}))
    tm = build_model(tcfg, device="cpu")
    tm.load_state_dict(convert.params_from_jax(tcfg, params))
    return jm, params, tm


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))


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


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    logits = np.random.default_rng(0).standard_normal((37, tcfg.moe_num_experts)) * 3
    # a row of exact ties: both packages pick the lower experts
    logits[0] = np.repeat([1.0, 2.0], tcfg.moe_num_experts // 2)
    logits = logits.astype(np.float32)
    jw, je, jaux = jmoe._route(jnp.asarray(logits), jcfg)
    tw, te, taux = moe.route(torch.from_numpy(logits), tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert te[0].tolist() == list(range(tcfg.moe_num_experts // 2,
                                        tcfg.moe_num_experts // 2 + tcfg.moe_top_k))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=ROUTE_RTOL)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=ROUTE_RTOL)
    assert taux.dtype == torch.float32


@pytest.mark.parametrize("n, experts", [(97, 8), (512, 64), (1, 4)])
def test_expert_ranks_match_reference(n, experts):
    flat_e = np.random.default_rng(n).integers(0, experts, n).astype(np.int32)
    want = np.asarray(jmoe._expert_ranks(jnp.asarray(flat_e), experts))
    got = moe.expert_ranks(torch.from_numpy(flat_e).long())
    np.testing.assert_array_equal(got.numpy(), want)


def _moe_pair(arch, **changes):
    jcfg, tcfg = _cfgs(arch, **changes)
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(3), jcfg)["moe"])
    tmoe = moe.MoE(tcfg, "cpu", None).requires_grad_(False)
    tmoe.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    return jcfg, p, tmoe


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, capacity_factor):
    """The routed output (plus the shared expert for deepseek), the aux loss
    and the dropped count; at capacity factor 0.5 tokens drop."""
    jcfg, p, tmoe = _moe_pair(arch, capacity_factor=capacity_factor)
    x = np.random.default_rng(1).standard_normal((3, 20, jcfg.d_model)).astype(np.float32)
    want, jaux, jdropped = jax.jit(lambda x: jmoe.moe_apply(p, x, jcfg))(jnp.asarray(x))
    got, taux, tdropped = tmoe(torch.from_numpy(x))
    _close(got, want)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=ROUTE_RTOL)
    assert tdropped.dtype == torch.int32 and taux.dtype == torch.float32
    assert int(tdropped) == int(jdropped)
    assert (int(tdropped) > 0) == (capacity_factor < 1)
    assert moe.capacity(60, tmoe.cfg) == int(np.ceil(60 * jcfg.moe_top_k / jcfg.moe_num_experts
                                                     * capacity_factor))


# ---------------------------------------------------------------------------
# MLA's three paths
# ---------------------------------------------------------------------------


def _mla_pair(**changes):
    """(config, the reference's ``mla_apply`` on its params, compiled, the
    port's ``MLA`` on the same weights)."""
    jcfg, tcfg = _cfgs("deepseek-v3-671b", **changes)
    p = jax.tree.map(np.asarray, jmla.mla_init(jax.random.PRNGKey(4), jcfg)["attn"])
    tmla = mla.MLA(tcfg, "cpu", None).requires_grad_(False)
    tmla.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    apply = jax.jit(lambda x, cache=None: jmla.mla_apply(p, x, jcfg, cache=cache))
    return jcfg, apply, tmla


def _cache_close(got, want):
    assert got["pos"] == int(want["pos"])
    _close(got["c_kv"], want["c_kv"])
    _close(got["k_rope"], want["k_rope"])


def test_mla_expanded_path_matches_reference():
    jcfg, apply, tmla = _mla_pair()
    x = np.random.default_rng(2).standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    want, jc = apply(jnp.asarray(x))
    got, tc = tmla(torch.from_numpy(x))
    assert jc is None and tc is None
    _close(got, want)


def test_mla_chunked_prefill_then_absorbed_decode_match_reference():
    """A 8-token prefill into a 16-row latent cache at attn_chunk_threshold
    8 (chunks of 4), then absorbed decode steps past the end of the cache
    (the write clamps to the last row while pos grows)."""
    jcfg, apply, tmla = _mla_pair(attn_chunk_threshold=8, attn_chunk_size=4)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    jc = jmla.init_mla_cache(jcfg, 2, 16)
    tc = mla.init_mla_cache(tmla.cfg, 2, 16, "cpu")
    want, jc = apply(jnp.asarray(x), jc)
    got, tc = tmla(torch.from_numpy(x), cache=tc)
    _close(got, want)
    _cache_close(tc, jc)
    for _ in range(10):
        x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        want, jc = apply(jnp.asarray(x), jc)
        got, tc = tmla(torch.from_numpy(x), cache=tc)
        _close(got, want)
        _cache_close(tc, jc)
    assert tc["pos"] == 18


def test_mla_decode_rotates_query_at_pos_and_key_at_zero_in_both_packages():
    """Quirk (ROADMAP Queue C, LM fault 5): with no positions a decode step
    rotates the new rope key at 0 but the query at its position ``pos``.
    The same input at cache rows 0 and 3 writes the same rope key; the
    step's output differs from what a query rotated at 0 gives."""
    jcfg, apply, tmla = _mla_pair()
    x = np.random.default_rng(5).standard_normal((1, 1, jcfg.d_model)).astype(np.float32)
    jc = jmla.init_mla_cache(jcfg, 1, 8)
    tc = mla.init_mla_cache(tmla.cfg, 1, 8, "cpu")
    for _ in range(4):
        jy, jc = apply(jnp.asarray(x), jc)
        ty, tc = tmla(torch.from_numpy(x), cache=tc)
    jk = np.asarray(jc["k_rope"][0])
    tk = tc["k_rope"][0].numpy()
    np.testing.assert_array_equal(jk[3], jk[0])
    np.testing.assert_array_equal(tk[3], tk[0])
    # the query at pos 3: the latent cache of four equal rows attended by a
    # query rotated at 3, not at 0
    q_nope, q_rope = tmla._project_q(torch.from_numpy(x), torch.tensor([[3]]))
    _, q_rope0 = tmla._project_q(torch.from_numpy(x), torch.tensor([[0]]))
    assert not torch.allclose(q_rope, q_rope0)
    k_at3 = layers.apply_rope(torch.from_numpy(tk[0:1])[None, :, None, :],
                              torch.tensor([[3]]), tmla.cfg.rope_theta)
    assert not torch.allclose(k_at3[0, :, 0], torch.from_numpy(tk[0:1]))
    _close(ty, jy)


# ---------------------------------------------------------------------------
# the model: apply, loss, decode, caches, the serving engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_and_loss_match_reference(arch, scan_layers):
    jm, params, tm = _pair(arch, scan_layers=scan_layers)
    tokens, targets = _tokens(jm.cfg, 2, 12, 0)
    jb = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    tb = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
    (logits, aux), (loss, metrics) = _jitted(arch, _key(arch, dict(scan_layers=scan_layers)))[
        "forward"](params, jb)
    got, taux = tm.apply(tb)
    _close(got, logits)
    assert set(taux) == set(aux)
    np.testing.assert_allclose(_np(taux["moe_aux"]), np.asarray(aux["moe_aux"]),
                               rtol=ROUTE_RTOL)
    assert taux["moe_dropped"].dtype == torch.int32
    assert int(taux["moe_dropped"]) == int(aux["moe_dropped"]) > 0
    if jm.cfg.mtp:
        _close(taux["mtp_logits"], aux["mtp_logits"])
    tloss, tmetrics = tm.loss(tb)
    assert set(tmetrics) == set(metrics)
    _close(tloss, loss)
    for k in metrics:
        if k == "moe_dropped":
            assert int(tmetrics[k]) == int(metrics[k])
        else:
            _close(tmetrics[k], metrics[k])
    assert ("mtp_ce" in tmetrics) == jm.cfg.mtp


@pytest.mark.parametrize("arch", ARCHS)
def test_chained_decode_steps_and_caches_match_reference(arch):
    """12 decode steps into 8-row caches (past the end: the write clamps),
    the logits each step and the caches after; then the reference's caches
    carried into the port give the reference's next step."""
    jm, params, tm = _pair(arch)
    tokens, _ = _tokens(jm.cfg, 3, 12, 1)
    step = _jitted(arch)["decode"]
    jc = jm.init_caches(3, 8)
    tc = tm.init_caches(3, 8)
    _caches_close(tm.cfg, tc, jc)
    for t in range(12):
        want, jc = step(params, jnp.asarray(tokens[:, t:t + 1]), jc, None)
        got, tc = tm.decode_step(torch.from_numpy(tokens[:, t:t + 1]), tc)
        _close(got, want)
    _caches_close(tm.cfg, tc, jc)
    assert all(c["pos"] == 12 for c in tc)
    carried = convert.caches_from_jax(tm.cfg, jax.tree.map(np.asarray, jc), "cpu")
    _caches_close(tm.cfg, carried, jc)
    want, _ = step(params, jnp.asarray(tokens[:, :1]), jc, None)
    got, _ = tm.decode_step(torch.from_numpy(tokens[:, :1]), carried)
    _close(got, want)


def test_deepseek_chunked_prefill_matches_reference():
    """The model's prefill into the latent caches past attn_chunk_threshold,
    then decode steps on top."""
    changes = dict(attn_chunk_threshold=8, attn_chunk_size=4)
    jm, params, tm = _pair("deepseek-v3-671b", **changes)
    fns = _jitted("deepseek-v3-671b", _key("deepseek-v3-671b", changes))
    tokens, _ = _tokens(jm.cfg, 2, 12, 2)
    jc, tc = jm.init_caches(2, 16), tm.init_caches(2, 16)
    want, jc = fns["prefill"](params, {"tokens": jnp.asarray(tokens[:, :8])}, jc)
    got, tc = tm.prefill({"tokens": torch.from_numpy(tokens[:, :8])}, tc)
    _close(got, want)
    _caches_close(tm.cfg, tc, jc)
    for t in range(8, 12):
        want, jc = fns["decode"](params, jnp.asarray(tokens[:, t:t + 1]), jc, None)
        got, tc = tm.decode_step(torch.from_numpy(tokens[:, t:t + 1]), tc)
        _close(got, want)
    _caches_close(tm.cfg, tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_matches_reference(arch):
    """5 requests over 3 slots: the same tokens, request for request."""
    jm, params, tm = _pair(arch)
    jeng = JServingEngine(jm, params, batch_slots=3, max_len=64)
    teng = ServingEngine(tm, batch_slots=3, max_len=64)
    rng = np.random.default_rng(0)
    for uid in range(5):
        prompt = rng.integers(1, jm.cfg.vocab_size, rng.integers(2, 8)).astype(np.int32)
        jeng.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=8, eos_id=-1))
        teng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=8, eos_id=-1))
    want = {r.uid: r.tokens for r in jeng.run()}
    got = {r.uid: r.tokens for r in teng.run()}
    assert got == want
    assert sorted(got) == list(range(5)) and all(len(t) == 8 for t in got.values())
    assert teng.pos == int(np.asarray(jeng.caches["unit"][0]["pos"][0]))


# ---------------------------------------------------------------------------
# gradients and train steps
# ---------------------------------------------------------------------------


def _scale_qk(params, qk_scale):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * qk_scale if path[-1].key in QK_WEIGHTS else x, params)


def _train_pair(arch, qk_scale):
    """(reference model, its train state from its init with the query and
    key projections scaled, the port's model and its state carrying it)."""
    _, tcfg = _cfgs(arch)
    jm, params = _reference(arch)
    jt = jtrain_loop.TrainConfig(opt=joptimizer.OptimizerConfig(**OPT))
    # init_train_state's tree around the reference's init params
    jstate = {"params": _scale_qk(jax.tree.map(jnp.asarray, params), qk_scale),
              "opt": joptimizer.init_opt_state(jt.opt, params),
              "step": jnp.zeros((), jnp.int32)}
    model = build_model(tcfg, device="cpu")
    state = init_train_state(model, TrainConfig(opt=OptimizerConfig(**OPT)))
    convert.train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate), state)
    return jm, jstate, model, state


def _batches(arch, n, b=2, s=16):
    jcfg, tcfg = _cfgs(arch)
    return [(jspecs.train_batch(jcfg, s, b, concrete=True, rng=np.random.default_rng(7 + i)),
             specs.train_batch(tcfg, s, b, concrete=True, rng=np.random.default_rng(7 + i),
                               device="cpu"))
            for i in range(n)]


@pytest.mark.parametrize("qk_scale", [0.25, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_step1_gradients_match_jax_grad(arch, qk_scale):
    jm, jstate, model, state = _train_pair(arch, qk_scale)
    (jb, tb), = _batches(arch, 1)
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    jgrads = _jitted(arch)["grad"](jstate["params"], jb)
    want = convert.params_from_jax(model.cfg, jax.tree.map(np.asarray, jgrads))
    loss, _ = model.loss(tb)
    names = list(state["params"])
    got = torch.autograd.grad(loss, [state["params"][k] for k in names])
    assert set(names) == set(want)
    for k, g in zip(names, got):
        w = want[k].numpy()
        assert np.abs(_np(g) - w).max() <= GRAD_REL[qk_scale] * np.abs(w).max(), k


@pytest.mark.parametrize("qk_scale", [0.25, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_chained_train_steps_match_reference(arch, qk_scale):
    jm, jstate, model, state = _train_pair(arch, qk_scale)
    jstep = _jitted(arch)["train_step"]
    step = make_train_step(model, TrainConfig(opt=OptimizerConfig(**OPT)))
    n = CHAINED_STEPS[qk_scale]
    for jb, tb in _batches(arch, n):
        jstate, jmet = jstep(jstate, jb)
        state, met = step(state, tb)
        assert set(met) == set(jmet)
        for k in ("loss", "ce", "moe_aux", "grad_norm", "lr") + (
                ("mtp_ce",) if jm.cfg.mtp else ()):
            np.testing.assert_allclose(_np(met[k]), np.asarray(jmet[k]), rtol=STEP_RTOL,
                                       err_msg=k)
        assert int(met["moe_dropped"]) == int(jmet["moe_dropped"])
    assert int(state["step"]) == int(jstate["step"]) == n


# ---------------------------------------------------------------------------
# full-width parameter counts, batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_count_at_full_width(arch):
    """On the meta device (nothing allocated): the reference's init leaf
    count (``jax.eval_shape``), which is ``total_params`` plus the norms
    (two a layer, one final), MLA's q_norm and kv_norm a layer, and the
    MTP layer and its projection; and fewer active than total."""
    cfg = configs.get_config(arch)
    model = build_model(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(jbuild_model(jconfigs.get_config(arch)).init,
                            jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    d = cfg.d_model
    mla_norms = cfg.q_lora_rank + cfg.kv_lora_rank if cfg.use_mla else 0
    mtp = 0
    if cfg.mtp:
        mtp = sum(p.numel() for p in model.mtp.parameters()) + 2 * d * d
    assert n == cfg.total_params() + cfg.num_layers * (2 * d + mla_norms) + d + mtp
    assert model.stack.layers[-1].moe.router.dtype == torch.float32
    assert all(p.dtype == torch.bfloat16 for k, p in model.named_parameters()
               if not k.endswith("router"))
    assert cfg.active_params() < cfg.total_params()
    if arch == "deepseek-v3-671b":
        assert cfg.active_params() < 0.12 * cfg.total_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_batch_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jb = jspecs.train_batch(jcfg, 24, 3, concrete=True, rng=np.random.default_rng(11))
    tb = specs.train_batch(tcfg, 24, 3, concrete=True, rng=np.random.default_rng(11),
                           device="cpu")
    for k in ("tokens", "targets"):
        assert tb[k].dtype == torch.int32
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
