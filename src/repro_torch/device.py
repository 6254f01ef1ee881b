"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA request without a card raises.

    Nothing continues quietly on the CPU: the caller asks for it by name.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass device='cpu' "
                "to run the plain PyTorch path")
        if dev.index is None:  # compare equal to tensor.device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for queued device work so host timers attribute it correctly."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)  # repro: noqa[R001] the stage-boundary wait its callers ask for
