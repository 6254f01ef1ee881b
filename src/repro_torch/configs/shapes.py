"""Assigned input shapes and per-(arch x shape) applicability.

  train_4k     seq 4096,   global_batch 256   (train_step)
  prefill_32k  seq 32768,  global_batch 32    (serve prefill)
  decode_32k   seq 32768,  global_batch 128   (serve decode: 1 new token,
                                               KV cache of seq_len)
  long_500k    seq 524288, global_batch 1     (long-context decode; only
                                               sub-quadratic archs)
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from . import ARCH_IDS


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k requires sub-quadratic attention: only ssm/hybrid run it
# (DESIGN.md §Shape skips); full-attention archs skip it.
_SUBQUADRATIC = {"rwkv6-1.6b", "jamba-1.5-large-398b"}


def applicable(arch_id: str, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and arch_id not in _SUBQUADRATIC:
        return False, "long_500k needs sub-quadratic attention (skip per assignment)"
    return True, ""


def all_cells() -> List[Tuple[str, str]]:
    cells = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            ok, _ = applicable(arch, shape)
            if ok:
                cells.append((arch, shape))
    return cells
