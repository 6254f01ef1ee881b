"""Port parity: the logical sharding rules (``repro_torch.distributed.
sharding``) against the JAX package's, as data: no world runs.

The port's meshes here are ``DeviceMesh``es of a ``fake`` process group
(``torch.testing``'s ``FakeStore``: one process stands for every rank,
and no collective runs), the reference's ``AbstractMesh``es of the same
shapes and dim names. Exact equality throughout:

- every parameter's spec at full width, for all ten archs, on the
  production meshes (16 x 16 and 2 x 16 x 16): the port's
  ``param_sharding`` over a meta-device model against the reference's
  over ``jax.eval_shape(model.init)``. A leaf of a scanned unit carries
  the stack axis in the reference and none in the port, so its spec
  there loses its first entry (``_reference_specs``);
- ``production_rules`` (with and without fsdp and seq_shard), ``spec``,
  ``guard_spec`` and ``logical_axes_for`` on the flat, pod and 3-axis
  meshes of ``_torch_mesh_worker.MESHES``;
- each rank's block of every parameter of the families that train on
  the mesh since A10b-6a (deepseek-v3's MLA and MTP, jamba's Mamba,
  rwkv6, whisper) at full width on the (2, 2, 2) mesh: ``shard_model``
  keeps the block shape the reference's spec gives, the replicated
  cross-attention whole and Mamba's ``("ffn", None)`` projections split
  by rows; and serving there (prefill, decode steps, every cached mixer,
  the ``moe_ff`` split) still refuses (ROADMAP A10b-6b);
- ``use_rules``/``active_rules``: nested scopes, unset in another
  thread (autograd's device thread: ``transformer._remat`` re-enters the
  rules); ``block_slices`` at every mesh coordinate (a checkpoint's
  gather to rank 0) tiles each parameter of the production spec table.
"""
import contextlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import _torch_mesh_worker as W  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.models.model import build_model, shard_model  # noqa: E402
from repro_torch.models.transformer import layer_specs, split_prefix_unit  # noqa: E402

PRODUCTION = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` in a fake world of its size, torn
    down on exit."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def _reference_specs(arch, mesh):
    """{port parameter name: spec} of the reference's ``param_sharding``
    at full width (scanned leaves' stack entry dropped, one name per
    layer)."""
    cfg = jconfigs.get_config(arch)
    params = jax.eval_shape(jbuild_model(cfg).init, jax.random.PRNGKey(0))
    shardings = jsharding.param_sharding(params, jsharding.production_rules(mesh))
    flat, _ = jax.tree_util.tree_flatten_with_path(shardings)
    out = {}
    if cfg.family == "encdec":
        counts = {"enc": cfg.encoder_layers, "dec": cfg.decoder_layers}
    else:
        prefix, unit, n_repeat = split_prefix_unit(layer_specs(configs.get_config(arch)))
    for path, sh in flat:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        spec = tuple(sh.spec)
        if keys[0] in ("enc", "dec"):
            for i in range(counts[keys[0]]):
                out[".".join([keys[0], str(i)] + keys[1:])] = spec[1:]
        elif keys[0] != "layers":
            out[".".join(keys)] = spec
        elif keys[1] == "prefix":
            out[".".join(["stack", "layers", keys[2]] + keys[3:])] = spec
        else:
            j = int(keys[2])
            scanned = cfg.scan_layers
            for r in range(n_repeat):
                i = len(prefix) + r * len(unit) + j
                rest = keys[3:] if scanned else keys[4:]
                if not scanned and int(keys[3]) != r:
                    continue
                out[".".join(["stack", "layers", str(i)] + rest)] = (
                    spec[1:] if scanned else spec)
    return out


@pytest.mark.parametrize("which", sorted(PRODUCTION))
def test_param_specs_match_reference_at_full_width(which):
    shape, names = PRODUCTION[which]
    want = {arch: _reference_specs(arch, AbstractMesh(shape, names))
            for arch in configs.ARCH_IDS}
    with fake_mesh(shape, names) as mesh:
        rules = sharding.production_rules(mesh)
        for arch in configs.ARCH_IDS:
            model = build_model(configs.get_config(arch), device="meta")
            got = sharding.param_sharding(model.named_parameters(), rules)
            assert set(got) == set(want[arch]), arch
            bad = {k: (got[k], want[arch][k]) for k in got if got[k] != want[arch][k]}
            assert not bad, (arch, bad)
            if arch == "olmoe-1b-7b":
                # vocab-parallel and FSDP-sharded (whisper's 51865 rows do
                # not divide: replicated there)
                assert got["embed.table"] == ("model", "data")


FAMILY_ARCHS = ("deepseek-v3-671b", "jamba-1.5-large-398b", "rwkv6-1.6b", "whisper-medium")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_local_blocks_match_reference_specs_on_the_small_mesh(arch):
    shape, names = W.MESHES["3axis"]
    want = _reference_specs(arch, AbstractMesh(shape, names))
    cfg = configs.get_config(arch)
    with fake_mesh(shape, names) as mesh:
        model = build_model(cfg, device="meta")
        whole = {k: tuple(p.shape) for k, p in model.named_parameters()}
        specs = shard_model(model, sharding.production_rules(mesh))
        assert specs == want
        for k, p in model.named_parameters():
            block = tuple(n // sharding.axis_size(mesh, ax) for n, ax in zip(whole[k], want[k]))
            assert tuple(p.shape) == block, (k, tuple(p.shape), block)
            assert sharding.sharding_of(p).spec == want[k]
        params = dict(model.named_parameters())
    din = cfg.mamba_expand * cfg.d_model
    if arch == "whisper-medium":
        for k in ("wq", "wk", "wv", "wo"):
            assert want[f"dec.0.cross.{k}"] == (None, None, None)
            assert tuple(params[f"dec.0.cross.{k}"].shape) == whole[f"dec.0.cross.{k}"]
        assert tuple(params["dec.0.attn.wq"].shape) == (512, 8, 64)
    elif arch == "jamba-1.5-large-398b":
        for k in ("w_b", "w_c", "w_dt"):
            assert want[f"stack.layers.0.mamba.{k}"] == ("model", None)
            assert params[f"stack.layers.0.mamba.{k}"].shape[0] == din // 2
        assert tuple(params["stack.layers.0.mamba.w_in"].shape) == (cfg.d_model // 2, din // 2)
    elif arch == "rwkv6-1.6b":
        assert tuple(params["stack.layers.0.rwkv.w_r"].shape) == (1024, 1024)
        assert want["stack.layers.0.rwkv.w_decay_lora_a"] == (None, None)
    else:
        assert want["mtp_proj"] == (None, None)
        assert tuple(params["stack.layers.0.attn.w_uq"].shape) == (1536, 64, 192)
        assert tuple(params["stack.layers.0.attn.w_dq"].shape) == (3584, 1536)


def _serving_refusal(case, rules):
    """Run ``case``'s serving call under ``rules`` on a reduced model
    sharded over the rules' mesh."""
    import dataclasses
    from repro_torch.models import attention, mamba, mla, rwkv
    from repro_torch.models.moe import MoE
    arch = {"prefill": "tinyllama-1.1b", "decode_step": "tinyllama-1.1b",
            "encdec prefill": "whisper-medium", "attention cache": "tinyllama-1.1b",
            "mla cache": "deepseek-v3-671b", "mamba cache": "jamba-1.5-large-398b",
            "rwkv cache": "rwkv6-1.6b", "moe_ff": "olmoe-1b-7b"}[case]
    cfg = configs.reduced_config(arch)
    model = build_model(cfg, device="cpu")
    shard_model(model, rules)
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    x = torch.zeros((2, 4, cfg.d_model))
    layer = model.stack.layers[0] if hasattr(model, "stack") else None
    with sharding.use_rules(rules), torch.no_grad():
        if case == "prefill":
            model.prefill({"tokens": tokens}, model.init_caches(2, 8))
        elif case == "decode_step":
            model.decode_step(tokens[:, :1], model.init_caches(2, 8))
        elif case == "encdec prefill":
            model.prefill({"tokens": tokens, "frames": x}, model.init_caches(2, 8))
        elif case == "attention cache":
            layer.attn(x, cache=attention.init_cache(cfg, 2, 8, "cpu"))
        elif case == "mla cache":
            layer.attn(x, cache=mla.init_mla_cache(cfg, 2, 8, "cpu"))
        elif case == "mamba cache":
            layer.mamba(x, cache=mamba.init_mamba_cache(cfg, 2, "cpu"))
        elif case == "rwkv cache":
            layer.rwkv(x, cache=rwkv.init_rwkv_cache(cfg, 2, "cpu"))
        else:
            block = next(m for m in model.modules() if isinstance(m, MoE))
            ff = dataclasses.replace(rules, rules=rules.rules[:-1] + (("moe_ff", "data"),))
            with sharding.use_rules(ff):
                block(x)


SERVING_CASES = ("prefill", "decode_step", "encdec prefill", "attention cache",
                 "mla cache", "mamba cache", "rwkv cache", "moe_ff")


@pytest.mark.parametrize("case", SERVING_CASES)
def test_serving_on_the_mesh_still_refuses(case):
    """Every family trains on the mesh; serving there (its caches, the
    expert-internal ff split) waits for ROADMAP A10b-6b and raises."""
    shape, names = W.MESHES["3axis"]
    with fake_mesh(shape, names) as mesh:
        rules = sharding.production_rules(mesh)
        assert rules.rules[-1][0] == "moe_ff"
        with pytest.raises(NotImplementedError, match="A10b-6b"):
            _serving_refusal(case, rules)


def _meshes():
    return sorted(W.MESHES)


SHAPES = [(8, 64), (6, 10), (16, 4, 2), (4, 8, 8), (7,), (32, 16, 8, 2)]
LOGICAL = [("batch", None), ("batch", "seq", "heads", None), ("vocab", "fsdp"),
           ("experts", "fsdp", "moe_ff"), ("kv_seq", "kv_heads"), ("embed", "state"),
           (None, "ffn"), ("fsdp",)]


@pytest.mark.parametrize("name", _meshes())
def test_rules_spec_and_guard_match_reference(name):
    shape, names = W.MESHES[name]
    jmesh = AbstractMesh(shape, names)
    with fake_mesh(shape, names) as mesh:
        for kw in ({}, {"fsdp": False}, {"seq_shard": True}):
            got = sharding.production_rules(mesh, **kw)
            want = jsharding.production_rules(jmesh, **kw)
            assert got.rules == want.rules, kw
            for logical in LOGICAL:
                spec = got.spec(*logical)
                assert spec == tuple(want.spec(*logical))
                if any(a not in names for ax in spec for a in sharding.axes_of(ax)):
                    continue  # "model" on a mesh without it: neither guards it
                for s in SHAPES:
                    assert sharding.guard_spec(mesh, s, spec) == tuple(
                        jsharding.guard_spec(jmesh, s, want.spec(*logical))), (logical, s)
        assert sharding.axis_size(mesh, sharding.data_axes(mesh)) == int(np.prod(
            [jmesh.shape[a] for a in names if a in ("pod", "data")]))


def test_logical_axes_for_matches_reference():
    paths = [p.replace("\\", "").replace("$", "").replace("(", "").replace(")", "")
             for p, _ in sharding._PARAM_PATTERNS]
    paths = [p.split("|")[0] for p in paths] + [
        "layers/unit/0/mamba/dt_bias", "layers/unit/0/mamba/a_log",
        "layers/prefix/1/rwkv/time_lora_a", "final_norm", "layers/unit/2/attn/q_norm",
        "mtp_proj", "enc/attn/wq", "dec/cross/wo", "embed/bias", "unknown/w"]
    for path in paths:
        for ndim in range(1, 5):
            assert sharding.logical_axes_for(path, ndim) == tuple(
                jsharding.logical_axes_for(path, ndim)), (path, ndim)
    # the quirk the docstring names: a 1-D dt_bias misses its 2-axis pattern
    assert sharding.logical_axes_for("mamba/dt_bias", 1) == (None,)
    assert sharding.logical_axes_for("mamba/dt_bias", 2) == ("ffn", None)


def test_rules_scope_and_blocks_tile_the_global_tensor():
    import itertools
    import threading
    assert sharding.active_rules() is None
    with fake_mesh((2, 2, 2), ("pod", "data", "model")) as mesh:
        rules = sharding.production_rules(mesh)
        flat = sharding.production_rules(mesh, fsdp=False)
        seen = []
        with sharding.use_rules(rules):
            assert sharding.active_rules() is rules
            with sharding.use_rules(flat):
                assert sharding.active_rules() is flat
            assert sharding.active_rules() is rules
            t = threading.Thread(target=lambda: seen.append(sharding.active_rules()))
            t.start()
            t.join()
        assert seen == [None] and sharding.active_rules() is None
        shapes = {"embed.table": (64, 16), "stack.layers.0.attn.wq": (16, 4, 8),
                  "stack.layers.0.moe.w_down": (8, 32, 16), "final_norm": (16,)}
        specs = sharding.param_sharding(shapes.items(), rules)
        assert specs["embed.table"] == ("model", "data")
        for name, shape in shapes.items():
            sh = sharding.NamedSharding(mesh, specs[name], shape)
            count = np.zeros(shape, np.int64)
            coords = list(itertools.product(*(range(n) for n in mesh.mesh.shape)))
            for coord in coords:
                count[sharding.block_slices(sh, coord)] += 1
            # every element held by as many ranks as the spec replicates it
            assert (count == sh.replicas()).all(), name
            assert len(coords) == 8
            # this rank (0) holds the block at coordinate (0, 0, 0)
            assert sharding.block_slices(sh) == sharding.block_slices(sh, (0, 0, 0))
