"""Device resolution for every ``device=`` argument of the port, and the
dry run's stand-in for the card.

``None`` means the CUDA card.  Without one the call raises: the port has
no silent CPU path, and a caller who wants the CPU (the tests) says so
with ``device="cpu"``.

A dry run (``launch.dryrun``) traces the card's path on a host that may
have no card: its tensors lie on the ``meta`` device (no storage, shapes
only; a CPU build of PyTorch cannot run autograd on fake CUDA tensors)
and stand for the card's.  Every wrapper routes a tensor that is not on
the CPU to its kernel, so they take the card's route; while a dry run
is active (:func:`dry_running`), each hand kernel's wrapper charges its
launch to it instead of launching
(``kernels.cuda_lib.CudaKernel.charged``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]

# the active dry run's counter, process-wide: autograd runs a backward on
# its own thread, where a context variable set by the caller is not seen
_DRY_RUN: list = [None]


@contextlib.contextmanager
def dry_running(counter: Any) -> Iterator[Any]:
    """Make ``counter`` (it has ``charge(name, cost)``) the active dry
    run inside the block; one at a time."""
    if _DRY_RUN[0] is not None:
        raise RuntimeError("a dry run is already active")
    _DRY_RUN[0] = counter
    try:
        yield counter
    finally:
        _DRY_RUN[0] = None


def dry_run() -> Optional[Any]:
    """The active dry run's counter, or None."""
    return _DRY_RUN[0]


def is_fake(t: Any) -> bool:
    """True for a tensor with no data: on the ``meta`` device, or a
    ``FakeTensor``."""
    if not isinstance(t, torch.Tensor):
        return False
    if t.device.type == "meta":
        return True
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


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
