"""Gradient compression: int8 row-scaled quantization with error feedback.

Port of the JAX package's ``training/compression.py``. Without a group
the quantize/dequantize still runs (the worst-case noise path of the
convergence tests); with a ``torch.distributed`` process group (for a
mesh dim, ``mesh.get_group(dim)``) the int8 payload travels as an int32
``all_reduce``, the scales are averaged, and the sum is divided by the
group's size: the reference's ``psum`` / ``pmean`` / ``psum(1)``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as tdist


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row (last-axis) int8 quantization. ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    x32 = x.to(torch.float32)
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compressed_psum_grads(grads: Dict[str, torch.Tensor],
                          error_fb: Dict[str, torch.Tensor], group: Optional[object] = None
                          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Quantize (grad + error), (optionally) all-reduce the int8 payload,
    dequantize; returns (gradients in their dtypes, the new error
    feedback in float32)."""
    deq_out, efb_out = {}, {}
    for k, g in grads.items():
        g32 = g.to(torch.float32) + error_fb[k]
        q, scale = quantize_int8(g32)
        if group is not None:
            # int32 accumulate of int8 payloads; scales reduced separately
            n = tdist.get_world_size(group)
            qsum = q.to(torch.int32)
            tdist.all_reduce(qsum, group=group)
            ssum = scale.clone()
            tdist.all_reduce(ssum, group=group)
            deq = qsum.to(torch.float32) * (ssum / n) / n
        else:
            deq = dequantize_int8(q, scale)
        efb_out[k] = g32 - deq
        deq_out[k] = deq.to(g.dtype)
    return deq_out, efb_out
