"""Varint segment sum: the CUDA kernel's wrapper and its plain version.

Step 3 of the byte-parallel LEB128 decode (see ``ref.py``): byte ``k``
carries a shifted payload ``contrib[k]`` and the sorted id ``vid[k]`` of
its varint, and ``values[v] = sum(contrib[k] for vid[k] == v)``.  The CUDA
kernel (``csrc/varint_segment_sum.cu``) ports the Pallas
``varint_unpack_kernel``; the source says how and what bounds it.

Everything is int64: a varint of any width decodes exactly, so the port
has no width gate.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda_lib import CudaKernel, check_operand

VARINT_SEGMENT_SUM = CudaKernel(
    "varint_segment_sum",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
     ctypes.c_longlong],
    source="src/repro_torch/csrc/varint_segment_sum.cu",
    replaces="src/repro/kernels/posting_decode/kernel.py:52",
)


def varint_segment_sum_plain(
    vid: torch.Tensor, contrib: torch.Tensor, n_values: int
) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of the payloads by value id."""
    out = torch.zeros(n_values, dtype=torch.int64, device=vid.device)
    return out.index_add_(0, vid, contrib)


def varint_segment_sum(
    vid: torch.Tensor, contrib: torch.Tensor, n_values: int
) -> torch.Tensor:
    """(n_values,) int64 sums of ``contrib`` by ``vid``.

    ``vid`` and ``contrib`` are (M,) int64 on one device, ``vid`` sorted
    with every id in ``[0, n_values)``.  CUDA tensors go through the
    kernel; CPU tensors through :func:`varint_segment_sum_plain`."""
    check_operand(vid, "vid", torch.int64)
    check_operand(contrib, "contrib", torch.int64)
    if vid.shape != contrib.shape:
        raise ValueError(
            f"vid {tuple(vid.shape)} and contrib {tuple(contrib.shape)} differ"
        )
    if vid.device != contrib.device:
        raise ValueError(f"vid on {vid.device}, contrib on {contrib.device}")
    n_values = int(n_values)
    if n_values < 0:
        raise ValueError(f"n_values must be >= 0, got {n_values}")
    if vid.device.type == "cpu":
        return varint_segment_sum_plain(vid, contrib, n_values)
    # the kernel accumulates with atomics: the output starts at zero
    out = torch.zeros(n_values, dtype=torch.int64, device=vid.device)
    VARINT_SEGMENT_SUM.launch(
        vid.device, (vid.numel(), n_values), vid.data_ptr(), contrib.data_ptr(), vid.numel(),
        out.data_ptr(), n_values,
    )
    return out
