"""Device resolution for every entry point of the port.

The port runs on the CUDA device.  The CPU is used only when the
caller asks for it by name (``device="cpu"``), as the tests do; with no
GPU and no explicit request an entry point raises instead of carrying
on silently on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA device; anything else is taken as given.
    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    return dev
