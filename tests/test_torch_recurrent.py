"""Port parity: the recurrent mixers (``repro_torch.models.rwkv``,
``mamba``, the ``mamba`` and ``rwkv`` layer kinds of ``transformer``, the
hybrid and ssm families of ``model``) against the JAX package, at the
reduced rwkv6-1.6b (4 RWKV layers) and jamba-1.5-large-398b (8 layers:
Mamba with an attention layer at 3, MoE every other layer) configs.

The reference's ``init`` weights are carried across with
``convert.params_from_jax``; the port runs on the CPU in float32.
Tolerances:

- the associative scan: rtol 1e-6 (measured: equal to the bit, the
  port takes the reference's recursion);
- the WKV forms, RWKV, Mamba on each path, the causal conv, logits,
  losses and caches within rtol 1e-5 / atol 2e-4
  (``test_torch_moe_mla.py``'s bound; measured at most 2.7e-5 on jamba's
  logits, 1.3e-5 on the chunked WKV against the reference's);
- the port's chunked WKV against its own step form within 2e-4, the
  bound of ``tests/test_rwkv_chunked.py``;
- the ``ServingEngine``'s greedy tokens, the dropped counts and the
  parameter counts exactly;
- step-1 gradients: each leaf within ``GRAD_REL`` of that leaf's max
  |g|, jamba's attention ``wq``/``wk`` scaled by 1/4 as in
  ``test_torch_moe_mla.py`` (RWKV has no such weight);
- loss, ce, moe_aux, grad_norm and lr within rtol 1e-4 over 5 chained
  train steps. The reference's step is composed of its compiled
  ``loss``, ``jax.grad`` of it and ``adamw_update``, which is what its
  ``train_step`` runs at ``grad_accum`` 1 without compression; compiling
  that step whole again would add about 16 s of the 8-layer unit's
  compile to the file.

LM fault 6 of ROADMAP Queue C is pinned in both packages: Mamba's cached
path given several tokens steps its state by the first token only.
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
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.training import optimizer as joptimizer  # noqa: E402
from repro.training import train_loop as jtrain_loop  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import convert, mamba, rwkv  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.training.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.training.smoke import QK_WEIGHTS  # noqa: E402
from repro_torch.training.train_loop import (TrainConfig, decayed_names,  # noqa: E402
                                             init_train_state, make_train_step)

TOL = dict(rtol=1e-5, atol=2e-4)
SCAN_RTOL = 1e-6
CHUNK_VS_SCAN = dict(rtol=2e-4, atol=2e-4)
RWKV, JAMBA = "rwkv6-1.6b", "jamba-1.5-large-398b"
ARCHS = [RWKV, JAMBA]
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=100)
QK_SCALE = 0.25
GRAD_REL = 1e-5
STEP_RTOL = 1e-4
CHAINED_STEPS = 5
# tests/test_rwkv_chunked.py's (seq, chunk) cases
WKV_CASES = [(64, 16), (128, 32), (96, 96)]


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _cfgs(arch, **changes):
    return (dataclasses.replace(jconfigs.reduced_config(arch), **changes),
            dataclasses.replace(configs.reduced_config(arch), **changes))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# RWKV: the two WKV forms, the block, its cache
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rwkv_block(**changes):
    """(config, the reference's ``rwkv_apply`` on its init params of key 0,
    compiled, the port's ``RWKV`` on the same weights)."""
    jcfg, tcfg = _cfgs(RWKV, **changes)
    p = jax.tree.map(np.asarray, jrwkv.rwkv_init(jax.random.PRNGKey(0), jcfg)["rwkv"])
    block = rwkv.RWKV(tcfg, "cpu", None).requires_grad_(False)
    block.load_state_dict({k: _t(v) for k, v in p.items()})
    apply = jax.jit(lambda x, cache=None: jrwkv.rwkv_apply(p, x, jcfg, cache=cache))
    return jcfg, apply, block


def _x(cfg, b, s, key=1):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(key), (b, s, cfg.d_model),
                                        jnp.float32))


@pytest.mark.parametrize("seq,chunk", WKV_CASES)
def test_rwkv_chunked_form_matches_reference_and_own_scan(seq, chunk):
    jcfg, apply, block = _rwkv_block(rwkv_impl="chunked", rwkv_chunk=chunk)
    x = _x(jcfg, 2, seq)
    want, _ = apply(jnp.asarray(x))
    got, cache = block(_t(x))
    assert cache is None
    _close(got, want)
    _, _, scan_block = _rwkv_block(rwkv_impl="scan", rwkv_chunk=chunk)
    _close(got, scan_block(_t(x))[0], **CHUNK_VS_SCAN)


@pytest.mark.parametrize("seq,chunk", WKV_CASES)
def test_rwkv_step_form_matches_reference(seq, chunk):
    jcfg, apply, block = _rwkv_block(rwkv_impl="scan", rwkv_chunk=chunk)
    x = _x(jcfg, 2, seq)
    _close(block(_t(x))[0], apply(jnp.asarray(x))[0])


def test_wkv_functions_match_reference_from_a_carried_state():
    """``chunked_wkv`` and ``wkv_scan`` on random r/k/v, decays in (0,1),
    a bonus and a nonzero initial state: outputs and final states."""
    rng = np.random.default_rng(0)
    b, s, h, d = 2, 48, 4, 16
    r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, s, h, d)) - 1)).astype(np.float32)
    u = (0.1 * rng.standard_normal((h, d))).astype(np.float32)
    s0 = rng.standard_normal((b, h, d, d)).astype(np.float32)
    args = [_t(a) for a in (r, k, v, w, u, s0)]
    js, jy = jax.jit(lambda *a: jrwkv._chunked_wkv(*a, 16))(r, k, v, w, u, s0)
    ts, ty = rwkv.chunked_wkv(*args, 16)
    _close(ty, jy)
    _close(ts, js)
    ss, sy = rwkv.wkv_scan(*args)
    _close(sy.reshape(b, s, h * d), ty, **CHUNK_VS_SCAN)
    _close(ss, ts, **CHUNK_VS_SCAN)


def test_rwkv_cache_steps_and_prefill_match_reference():
    """A 5-token step through a fresh cache (the step form over time), then
    6 single-token steps: each output, and the state and x_prev after."""
    jcfg, apply, block = _rwkv_block()
    jc = jrwkv.init_rwkv_cache(jcfg, 2)
    tc = rwkv.init_rwkv_cache(block.cfg, 2, "cpu")
    assert tc["state"].dtype == torch.float32 and tc["state"].shape == jc["state"].shape
    xs = _x(jcfg, 2, 11, key=2)
    for lo, hi in [(0, 5)] + [(t, t + 1) for t in range(5, 11)]:
        want, jc = apply(jnp.asarray(xs[:, lo:hi]), jc)
        got, tc = block(_t(xs[:, lo:hi]), cache=tc)
        _close(got, want)
        _close(tc["state"], jc["state"])
        _close(tc["x_prev"], jc["x_prev"])


# ---------------------------------------------------------------------------
# Mamba: the causal conv, the associative scan, both paths, LM fault 6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    state = rng.standard_normal((2, 3, 24)).astype(np.float32) if with_state else None
    want, jstate = jmamba._causal_conv(jnp.asarray(u), jnp.asarray(w),
                                       None if state is None else jnp.asarray(state))
    got, tstate = mamba.causal_conv(_t(u), _t(w), None if state is None else _t(state))
    _close(got, want)
    _close(tstate, jstate)


def _combine(e1, e2):
    return e1[0] * e2[0], e1[1] * e2[0] + e2[1]


@pytest.mark.parametrize("n", [1, 2, 13, 16, 64])
def test_associative_scan_matches_reference(n):
    rng = np.random.default_rng(n)
    a = rng.random((2, n, 5, 3)).astype(np.float32)
    b = rng.standard_normal((2, n, 5, 3)).astype(np.float32)
    ja, jb = jax.jit(lambda a, b: jax.lax.associative_scan(_combine, (a, b), axis=1))(a, b)
    ta, tb = mamba.associative_scan(_t(a), _t(b), dim=1)
    _close(ta, ja, rtol=SCAN_RTOL)
    _close(tb, jb, rtol=SCAN_RTOL, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _mamba_block(**changes):
    jcfg, tcfg = _cfgs(JAMBA, **changes)
    p = jax.tree.map(np.asarray, jmamba.mamba_init(jax.random.PRNGKey(0), jcfg)["mamba"])
    block = mamba.Mamba(tcfg, "cpu", None).requires_grad_(False)
    block.load_state_dict({k: _t(v) for k, v in p.items()})
    apply = jax.jit(lambda x, cache=None: jmamba.mamba_apply(p, x, jcfg, cache=cache))
    return jcfg, apply, block


@pytest.mark.parametrize("seq", [8, 16, 48])
def test_mamba_chunked_path_matches_reference(seq):
    """One chunk shorter than ``mamba_chunk`` (16), one whole chunk, three
    chunks with the state carried between them."""
    jcfg, apply, block = _mamba_block()
    x = _x(jcfg, 2, seq)
    want, jc = apply(jnp.asarray(x))
    got, tc = block(_t(x))
    assert jc is None and tc is None
    _close(got, want)


def test_mamba_cached_path_matches_reference():
    """10 single-token steps through a fresh cache: each output, and ``h``
    (float32) and ``conv`` after each."""
    jcfg, apply, block = _mamba_block()
    jc = jmamba.init_mamba_cache(jcfg, 2)
    tc = mamba.init_mamba_cache(block.cfg, 2, "cpu")
    assert tc["h"].dtype == torch.float32 and tc["conv"].shape == jc["conv"].shape
    xs = _x(jcfg, 2, 10, key=2)
    for t in range(10):
        want, jc = apply(jnp.asarray(xs[:, t:t + 1]), jc)
        got, tc = block(_t(xs[:, t:t + 1]), cache=tc)
        _close(got, want)
        _close(tc["h"], jc["h"])
        _close(tc["conv"], jc["conv"])


def test_mamba_prefill_steps_state_by_first_token_only_in_both_packages():
    """LM fault 6: four tokens through a fresh cache step ``h`` by token 0
    alone (equal to one step of that token), not by the four (measured
    0.040 apart), and broadcast that one output over the positions; the
    conv state takes all four. Both packages agree."""
    jcfg, apply, block = _mamba_block()
    x = _x(jcfg, 2, 4)
    jc0 = jmamba.init_mamba_cache(jcfg, 2)
    want, jc = apply(jnp.asarray(x), jc0)
    got, tc = block(_t(x), cache=mamba.init_mamba_cache(block.cfg, 2, "cpu"))
    _close(got, want)
    _close(tc["h"], jc["h"])
    _close(tc["conv"], jc["conv"])
    _, one = apply(jnp.asarray(x[:, :1]), jc0)
    np.testing.assert_array_equal(np.asarray(jc["h"]), np.asarray(one["h"]))
    stepped, outs = jc0, []
    tstep = mamba.init_mamba_cache(block.cfg, 2, "cpu")
    for t in range(4):
        y, stepped = apply(jnp.asarray(x[:, t:t + 1]), stepped)
        outs.append(np.asarray(y))
        block(_t(x[:, t:t + 1]), cache=tstep)
    for h in (np.asarray(jc["h"]), _np(tc["h"])):
        assert np.abs(h - np.asarray(stepped["h"])).max() > 0.01
    _close(tstep["h"], stepped["h"])
    # the conv state is the last three inputs' either way
    _close(tc["conv"], stepped["conv"])
    for y in (np.asarray(want), _np(got)):
        assert np.abs(y[:, 1:] - np.concatenate(outs, axis=1)[:, 1:]).max() > 1e-3
        _close(y[:, 0], outs[0][:, 0])


# ---------------------------------------------------------------------------
# the model: apply, loss, prefill, decode, caches, the serving engine
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _init_params(arch):
    jm = jbuild_model(jconfigs.reduced_config(arch))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _key(arch, changes):
    base = dataclasses.asdict(jconfigs.reduced_config(arch))
    return tuple(sorted((k, v) for k, v in changes.items() if base[k] != v))


@functools.lru_cache(maxsize=None)
def _reference(arch, changes=()):
    """The reference model and params (numpy leaves): the init params, the
    scanned unit split into per-repeat trees where ``scan_layers`` is
    off."""
    jcfg, _ = _cfgs(arch, **dict(changes))
    params = _init_params(arch)
    if not jcfg.scan_layers:
        n = jcfg.num_layers
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
            "adamw": jax.jit(functools.partial(joptimizer.adamw_update, jt.opt))}


def _reference_step(arch, state, batch):
    """The reference's train step (``train_loop.make_train_step`` at
    ``grad_accum`` 1): the loss and metrics, the gradients, then AdamW."""
    fns = _jitted(arch)
    _, (loss, metrics) = fns["forward"](state["params"], batch)
    grads = fns["grad"](state["params"], batch)
    params, opt, opt_metrics = fns["adamw"](state["params"], grads, state["opt"])
    return ({**state, "params": params, "opt": opt, "step": state["step"] + 1},
            {"loss": loss, **metrics, **opt_metrics})


def _pair(arch, **changes):
    jm, params = _reference(arch, _key(arch, changes))
    _, tcfg = _cfgs(arch, **changes)
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


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_and_loss_match_reference(arch, scan_layers):
    """32 tokens: two of jamba's Mamba chunks, RWKV's step form."""
    jm, params, tm = _pair(arch, scan_layers=scan_layers)
    tokens, targets = _tokens(jm.cfg, 2, 32, 0)
    jb = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    tb = {"tokens": _t(tokens), "targets": _t(targets)}
    (logits, aux), (loss, metrics) = _jitted(arch, _key(arch, dict(scan_layers=scan_layers)))[
        "forward"](params, jb)
    got, taux = tm.apply(tb)
    _close(got, logits)
    assert set(taux) == set(aux)
    _close(taux["moe_aux"], aux["moe_aux"])
    assert int(taux["moe_dropped"]) == int(aux["moe_dropped"])
    tloss, tmetrics = tm.loss(tb)
    assert set(tmetrics) == set(metrics)
    _close(tloss, loss)
    for k in metrics:
        _close(tmetrics[k], metrics[k])


def test_rwkv_chunked_model_matches_reference():
    """``rwkv_impl="chunked"`` through the whole model (64 tokens in chunks
    of 16): the logits against the reference's chunked model and within
    2e-4 of the port's step form."""
    changes = dict(rwkv_impl="chunked", rwkv_chunk=16)
    jm, params, tm = _pair(RWKV, **changes)
    tokens, targets = _tokens(jm.cfg, 2, 64, 4)
    (logits, _), _ = _jitted(RWKV, _key(RWKV, changes))["forward"](
        params, {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)})
    got, _ = tm.apply({"tokens": _t(tokens), "targets": _t(targets)})
    _close(got, logits)
    _, _, scan_model = _pair(RWKV)
    _close(got, scan_model.apply({"tokens": _t(tokens), "targets": _t(targets)})[0],
           **CHUNK_VS_SCAN)


@pytest.mark.parametrize("arch", ARCHS)
def test_chained_decode_steps_and_caches_match_reference(arch):
    """12 decode steps into fresh caches (jamba's attention cache of 8 rows
    clamps past its end), the logits each step and the caches after; then
    the reference's caches carried into the port give its next step."""
    jm, params, tm = _pair(arch)
    tokens, _ = _tokens(jm.cfg, 3, 12, 1)
    step = _jitted(arch)["decode"]
    jc = jm.init_caches(3, 8)
    tc = tm.init_caches(3, 8)
    _caches_close(tm.cfg, tc, jc)
    for t in range(12):
        want, jc = step(params, jnp.asarray(tokens[:, t:t + 1]), jc, None)
        got, tc = tm.decode_step(_t(tokens[:, t:t + 1]), tc)
        _close(got, want)
    _caches_close(tm.cfg, tc, jc)
    carried = convert.caches_from_jax(tm.cfg, jax.tree.map(np.asarray, jc), "cpu")
    _caches_close(tm.cfg, carried, jc)
    assert all(c[k].dtype == torch.float32 for c in carried for k in ("h", "state")
               if k in c)
    want, _ = step(params, jnp.asarray(tokens[:, :1]), jc, None)
    got, _ = tm.decode_step(_t(tokens[:, :1]), carried)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch):
    """A 6-token prefill through fresh caches (jamba's Mamba layers keep LM
    fault 6), then 4 decode steps (the 8-row attention cache clamps)."""
    jm, params, tm = _pair(arch)
    fns = _jitted(arch)
    tokens, _ = _tokens(jm.cfg, 3, 10, 2)
    jc, tc = jm.init_caches(3, 8), tm.init_caches(3, 8)
    want, jc = fns["prefill"](params, {"tokens": jnp.asarray(tokens[:, :6])}, jc)
    got, tc = tm.prefill({"tokens": _t(tokens[:, :6])}, tc)
    _close(got, want)
    _caches_close(tm.cfg, tc, jc)
    for t in range(6, 10):
        want, jc = fns["decode"](params, jnp.asarray(tokens[:, t:t + 1]), jc, None)
        got, tc = tm.decode_step(_t(tokens[:, t:t + 1]), tc)
        _close(got, want)
    _caches_close(tm.cfg, tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_matches_reference(arch):
    """5 requests over 3 slots: the same tokens, request for request, and
    as many decode steps (admission advances every slot's state)."""
    jm, params, tm = _pair(arch)
    jeng = JServingEngine(jm, params, batch_slots=3, max_len=64)
    jstep, calls = jeng._step, []

    def counted(*args):
        calls.append(1)
        return jstep(*args)

    jeng._step = counted
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
    assert teng.pos == len(calls)


# ---------------------------------------------------------------------------
# gradients and train steps
# ---------------------------------------------------------------------------


def _scale_qk(params, qk_scale):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * qk_scale if path[-1].key in QK_WEIGHTS else x, params)


def _train_pair(arch):
    """(reference model, its train state from its init with jamba's query
    and key projections scaled by QK_SCALE, the port's model and its
    state carrying it)."""
    _, tcfg = _cfgs(arch)
    jm, params = _reference(arch)
    jt = jtrain_loop.TrainConfig(opt=joptimizer.OptimizerConfig(**OPT))
    jstate = {"params": _scale_qk(jax.tree.map(jnp.asarray, params), QK_SCALE),
              "opt": joptimizer.init_opt_state(jt.opt, params),
              "step": jnp.zeros((), jnp.int32)}
    model = build_model(tcfg, device="cpu")
    state = init_train_state(model, TrainConfig(opt=OptimizerConfig(**OPT)))
    convert.train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate), state)
    return jm, jstate, model, state


def _batches(arch, n, b=2, s=32):
    jcfg, tcfg = _cfgs(arch)
    return [(jspecs.train_batch(jcfg, s, b, concrete=True, rng=np.random.default_rng(7 + i)),
             specs.train_batch(tcfg, s, b, concrete=True, rng=np.random.default_rng(7 + i),
                               device="cpu"))
            for i in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_step1_gradients_match_jax_grad(arch):
    jm, jstate, model, state = _train_pair(arch)
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
        assert np.abs(_np(g) - w).max() <= GRAD_REL * np.abs(w).max(), k


@pytest.mark.parametrize("arch", ARCHS)
def test_chained_train_steps_match_reference(arch):
    jm, jstate, model, state = _train_pair(arch)
    step = make_train_step(model, TrainConfig(opt=OptimizerConfig(**OPT)))
    for jb, tb in _batches(arch, CHAINED_STEPS):
        jstate, jmet = _reference_step(arch, jstate, jb)
        state, met = step(state, tb)
        assert set(met) == set(jmet)
        for k in ("loss", "ce", "moe_aux", "grad_norm", "lr"):
            np.testing.assert_allclose(_np(met[k]), np.asarray(jmet[k]), rtol=STEP_RTOL,
                                       atol=1e-12, err_msg=k)
        assert int(met["moe_dropped"]) == int(jmet["moe_dropped"])
    assert int(state["step"]) == int(jstate["step"]) == CHAINED_STEPS


@pytest.mark.parametrize("scan_layers", [True, False])
def test_weight_decay_follows_the_reference_tree(scan_layers):
    """Training fault 4: AdamW decays the leaves of two or more dims of the
    reference's tree, so a scanned unit's vectors are decayed (their leaf
    carries the stack axis) and unscanned ones are not. The decayed names
    equal those of the reference's tree, leaf by leaf."""
    jm, params = _reference(RWKV, _key(RWKV, dict(scan_layers=scan_layers)))
    _, tcfg = _cfgs(RWKV, scan_layers=scan_layers)
    model = build_model(tcfg, device="cpu")
    want = set()
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[:2] == ["stack", "layers"]:
            i, path = int(parts[2]), parts[3:]
            tree = params["layers"]["unit"][0]
            if not scan_layers:
                tree = tree[i]
            for p in path:
                tree = tree[p]
            ndim = np.ndim(tree)
        else:
            tree = params
            for p in parts:
                tree = tree[p]
            ndim = np.ndim(tree)
        if ndim >= 2:
            want.add(name)
    got = decayed_names(model)
    assert got == want
    assert ("stack.layers.2.rwkv.decay_base" in got) == scan_layers
    assert ("stack.layers.2.pre_norm" in got) == scan_layers


# ---------------------------------------------------------------------------
# full-width parameter counts
# ---------------------------------------------------------------------------

# jamba's depth cut on the card: the fewest leading layers holding every
# layer kind, (mamba, moe), (mamba, mlp), (mamba, moe), (attn, mlp)
JAMBA_CUT = 4
EXACT = {RWKV: 1_835_501_568, JAMBA: 23_021_330_432}


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_count_at_full_width(arch):
    """On the meta device (nothing allocated): the reference's init leaf
    count (``jax.eval_shape``) at the published config and at the depth
    the card runs (rwkv6 whole, jamba cut to 4 layers), in bfloat16."""
    for layers in (None, JAMBA_CUT if arch == JAMBA else None):
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
            jcfg = dataclasses.replace(jcfg, num_layers=layers)
        model = build_model(cfg, device="meta")
        n = sum(p.numel() for p in model.parameters())
        shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
        assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
        if arch == RWKV or layers:
            assert n == EXACT[arch]
    assert all(p.dtype == torch.bfloat16 for k, p in model.named_parameters()
               if not k.endswith("router"))
    if arch == JAMBA:
        kinds = [layer.spec for layer in build_model(
            dataclasses.replace(configs.get_config(JAMBA), num_layers=JAMBA_CUT),
            device="meta").stack.layers]
        assert kinds == [("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"), ("attn", "mlp")]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_batch_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jb = jspecs.train_batch(jcfg, 24, 3, concrete=True, rng=np.random.default_rng(11))
    tb = specs.train_batch(tcfg, 24, 3, concrete=True, rng=np.random.default_rng(11),
                           device="cpu")
    for k in ("tokens", "targets"):
        assert tb[k].dtype == torch.int32
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
