"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another. Raises when no card is present and none was named;
    the port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
