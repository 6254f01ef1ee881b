"""The weight and cache carrier between the JAX package and the port.

``params_from_jax`` turns the reference's parameter tree (its
``model.init`` output, leaves as numpy arrays) into the port's
``state_dict``; ``train_state_from_jax`` carries a whole train state
(parameters, AdamW moments, step counters, error feedback) into the
port's; ``caches_from_jax`` and ``caches_to_numpy`` move caches
between the reference's ``{"prefix", "unit"}`` tree and the port's list
of per-layer caches, so tests can feed both packages the same state and
compare what comes out. The reference's layers are a ``prefix`` list and
a repeating ``unit``: scanned (``scan_layers=True``), each unit leaf has a
leading ``n_repeat`` axis; unscanned, ``unit[j]`` is a list of
``n_repeat`` trees. Layer ``len(prefix) + r * len(unit) + j`` is repeat
``r`` of unit entry ``j``. A parameter's name in the port is its path
in the reference's tree joined by dots (layer ``i``'s under
``stack.layers.<i>``, the MTP layer's under ``mtp``), for every layer
kind; matrices keep the reference's orientation. A Mamba layer's
parameters sit under ``mamba``, an RWKV layer's under ``rwkv``, as in the
reference's tree; a scanned ``a_log`` (broadcast over the stack) is
sliced as any other leaf. The encdec family's ``enc`` and ``dec`` are
always stacked: encoder layer ``i``'s leaves are ``enc.<i>.<path>``,
decoder layer ``i``'s ``dec.<i>.<path>`` (its cross-attention under
``cross``), and its decoder caches are one stacked tree whose ``pos`` has
shape ``(decoder_layers,)``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .config import ModelConfig
from .transformer import layer_specs, split_prefix_unit


def _layer_trees(cfg: ModelConfig, stack: Dict) -> List:
    """The per-layer subtrees of a ``{"prefix", "unit"}`` tree, in layer
    order; a scanned unit entry is sliced along its leading axis. For the
    encdec family, ``stack`` is the decoder's stacked tree."""
    if cfg.family == "encdec":
        return [_index(stack, i) for i in range(cfg.decoder_layers)]
    prefix, unit, n_repeat = split_prefix_unit(layer_specs(cfg))
    out = list(stack["prefix"])
    for r in range(n_repeat):
        for j in range(len(unit)):
            entry = stack["unit"][j]
            if isinstance(entry, list):
                out.append(entry[r])
            else:
                out.append(_index(entry, r))
    return out


def _index(tree, r):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def _leaves(tree, prefix: str):
    """(dotted name, array) of every leaf of a nested dict, the name
    ``prefix`` + its keys: a layer's ``attn.wq``, ``moe.shared_gate``,
    MLA's ``attn.q_norm``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, np.asarray(tree)


def params_from_jax(cfg: ModelConfig, tree: Dict) -> Dict[str, torch.Tensor]:
    """The reference's params tree -> the port's ``state_dict`` (CPU
    tensors in the tree's dtypes; ``load_state_dict`` moves them)."""
    def t(x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":  # ml_dtypes bfloat16: no numpy buffer
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(x))

    stacks = {"layers", "enc", "dec"}
    top = {k: v for k, v in tree.items() if k not in stacks}
    sd = {name: t(x) for name, x in _leaves(top, "")}
    if cfg.family == "encdec":
        layers = [(f"{key}.{i}", _index(tree[key], i)) for key, n in (
            ("enc", cfg.encoder_layers), ("dec", cfg.decoder_layers)) for i in range(n)]
    else:
        layers = [(f"stack.layers.{i}", layer)
                  for i, layer in enumerate(_layer_trees(cfg, tree["layers"]))]
    for prefix, layer in layers:
        sd.update((name, t(x)) for name, x in _leaves(layer, prefix))
    return sd


@torch.no_grad()
def train_state_from_jax(cfg: ModelConfig, tree: Dict, state: Dict) -> Dict:
    """Copy the reference's train state (``init_train_state`` /
    ``train_step`` output, leaves as numpy arrays) into the port's
    ``state`` (``training.train_loop.init_train_state``) in place: the
    parameters, ``opt.mu``, ``opt.nu`` and ``error_fb`` (each with the
    parameters' tree) through ``params_from_jax``, ``opt.step`` and
    ``step``. Returns ``state``."""
    trees = [("params",), ("opt", "mu"), ("opt", "nu")]
    if "error_fb" in tree:
        trees.append(("error_fb",))
    for path in trees:
        src, dst = tree, state
        for p in path:
            src, dst = src[p], dst[p]
        sd = params_from_jax(cfg, src)
        if set(sd) != set(dst):
            raise ValueError(f"{'.'.join(path)}: the reference's leaves "
                             f"{sorted(set(sd) ^ set(dst))} have no counterpart")
        for k, v in sd.items():
            dst[k].copy_(v)
    state["opt"]["step"].copy_(torch.from_numpy(np.array(tree["opt"]["step"])))
    state["step"].copy_(torch.from_numpy(np.array(tree["step"])))
    return state


# cache leaves kept in float32 whatever the compute dtype: the recurrent
# states of RWKV and Mamba
_F32_CACHE = ("state", "h")


def caches_from_jax(cfg: ModelConfig, caches: Dict, device) -> List[Dict]:
    """The reference's caches -> the port's list (one cache a layer:
    ``k``/``v`` and ``pos`` for attention, ``c_kv``/``k_rope`` and ``pos``
    for MLA, ``h``/``conv`` for Mamba, ``state``/``x_prev`` for RWKV)."""
    def one(c):
        return {k: int(np.asarray(v)) if k == "pos" else
                torch.from_numpy(np.array(v, np.float32)).to(
                    device, torch.float32 if k in _F32_CACHE else cfg.cdtype)
                for k, v in c.items()}
    return [one(c) for c in _layer_trees(cfg, caches)]


def caches_to_numpy(cfg: ModelConfig, caches: List[Dict], scan_layers: bool) -> Dict:
    """The port's caches -> the reference's ``{"prefix", "unit"}`` tree of
    float32 numpy arrays (scanned: stacked on a leading axis); for the
    encdec family, the decoder's stacked tree."""
    def one(c):
        return {k: np.int32(v) if k == "pos" else v.float().cpu().numpy()
                for k, v in c.items()}

    if cfg.family == "encdec":
        return {k: np.stack([one(c)[k] for c in caches]) for k in caches[0]}
    prefix, unit, n_repeat = split_prefix_unit(layer_specs(cfg))

    out = {"prefix": [one(c) for c in caches[:len(prefix)]], "unit": []}
    for j in range(len(unit)):
        reps = [one(caches[len(prefix) + r * len(unit) + j]) for r in range(n_repeat)]
        if scan_layers:
            out["unit"].append({k: np.stack([c[k] for c in reps]) for k in reps[0]})
        else:
            out["unit"].append(reps)
    return out
