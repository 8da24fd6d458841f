"""Production meshes, the port of ``repro.launch.mesh``, as DeviceMeshes
over the default process group.

Single pod:  (16, 16)      axes (data, model)       = 256 ranks
Multi pod:   (2, 16, 16)   axes (pod, data, model)  = 512 ranks

Both are functions, so importing this module touches no device and no
process group.  The default process group must be initialized with the mesh's size
(``torchrun`` gives it to ``torch.distributed.init_process_group``):
another size, or no group, raises a ``ValueError`` that names the size needed, as ``jax.make_mesh``
does.  Ranks run on ``cuda`` unless the caller asks for the CPU.

``HW`` is the card's table for the roofline (``launch.roofline``), the
counterpart of the reference's TPU v5e table, with its key names where
they mean the same thing.
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


# One NVIDIA H100 SXM and its links in a DGX H100 node: the roofline's
# hardware model (``launch.roofline``), and the peaks the smoke run's
# bounds divide by.  Dense rates, no sparsity, at the 700 W power limit.
HW = {
    "name": "h100-sxm",
    # NVIDIA H100 Tensor Core GPU datasheet (SXM column): BF16 tensor core
    "peak_bf16_flops": 989e12,    # FLOP/s
    # the same datasheet: FP32 outside the tensor cores (also the 32-bit
    # integer compares and adds of the search kernels)
    "peak_f32_flops": 67e12,      # FLOP/s
    # the datasheet's TF32 tensor core rate, 495e12, over the three TF32
    # products of each f32 product in the split-TF32 kernels
    # (csrc/tf32.cuh): 495e12 / 3
    "peak_tf32x3_flops": 165e12,  # FLOP/s
    "hbm_bw": 3.35e12,            # B/s, HBM3 (datasheet)
    "hbm_bytes": 80 * 10 ** 9,    # B, "80GB" (datasheet)
    "l2_bytes": 50 * 2 ** 20,     # B (NVIDIA Hopper architecture whitepaper)
    # NVLink 4: 900 GB/s a GPU, 450 GB/s each way, to every card of the
    # node through the NVSwitches (datasheet; DGX H100 user guide)
    "link_bw": 450e9,             # B/s a direction
    # one ConnectX-7 NDR InfiniBand port of 400 Gb/s a GPU (DGX H100 user
    # guide: eight single-port cards for the compute fabric)
    "net_bw": 50e9,               # B/s a direction
    "gpus_per_node": 8,           # DGX H100 user guide
}
