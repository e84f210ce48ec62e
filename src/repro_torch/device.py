"""Device resolution: the card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means "cuda". A CUDA device that is asked for (by default
    or by name) and is absent raises ``RuntimeError`` — the port never
    moves work to the CPU on its own; pass ``device="cpu"`` to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was requested but no CUDA device is "
            "present; pass device='cpu' explicitly to run on the CPU")
    return dev
