"""Device resolution for every ``device=`` argument of the port.

``None`` means the CUDA card.  Without one the call raises: the port has
no silent CPU path, and a caller who wants the CPU (the tests) says so
with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` a port entry point runs on."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def to_device(x, device: torch.device, dtype=np.int64) -> torch.Tensor:
    """A copy of a host array as a contiguous tensor of ``dtype`` on
    ``device`` (a copy, so read-only posting arrays convert too)."""
    return torch.tensor(np.ascontiguousarray(x, dtype=dtype), device=device)
