"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU. A
missing card is an error, never a quiet move to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None means "cuda"; a CUDA device without a card raises RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU"
        )
    return dev
