"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  Raises when the card is asked for and absent — there is
    no silent CPU fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device

