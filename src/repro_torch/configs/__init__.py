"""Architecture registry: ``get_config(arch_id)`` / ``reduced_config(arch_id)``.

One module per assigned architecture; each exports ``CONFIG`` (the exact
assigned spec) and ``reduced()`` (a tiny same-family config for CPU smoke
tests).

The port's own copy of the JAX package's ``configs``: the same data,
field for field, over the port's ``ModelConfig``; ``models/model.build_model``
builds every config of it."""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

ARCH_IDS: List[str] = [
    "deepseek-v3-671b",
    "olmoe-1b-7b",
    "whisper-medium",
    "jamba-1.5-large-398b",
    "internlm2-20b",
    "tinyllama-1.1b",
    "mistral-nemo-12b",
    "stablelm-3b",
    "rwkv6-1.6b",
    "internvl2-76b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")
    return importlib.import_module(f".{_MODULES[arch_id]}", __package__)


def get_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).CONFIG


def reduced_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).reduced()
