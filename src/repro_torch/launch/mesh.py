"""Production meshes, the port of ``repro.launch.mesh``, as DeviceMeshes
over the default process group.

Single pod:  (16, 16)      axes (data, model)       = 256 ranks
Multi pod:   (2, 16, 16)   axes (pod, data, model)  = 512 ranks

Both are functions, so importing this module touches no device and no
process group.  The default process group must be initialized with the mesh's size
(``torchrun`` gives it to ``torch.distributed.init_process_group``):
another size, or no group, raises a ``ValueError`` that names the size needed, as ``jax.make_mesh``
does.  Ranks run on ``cuda`` unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: DeviceLike = None) -> DeviceMesh:
    """A ``shape`` mesh named ``axes`` over the default process group."""
    need = 1
    for n in shape:
        need *= n
    if not dist.is_initialized():
        raise ValueError(f"a {shape} mesh needs {need} ranks, but no "
                         "process group is initialized")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(
            f"a {shape} mesh needs {need} ranks, but the world has {world}")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device: DeviceLike = None) -> DeviceMesh:
    """The degenerate (1, 1) mesh of one rank."""
    return make_mesh((1, 1), ("data", "model"), device)
