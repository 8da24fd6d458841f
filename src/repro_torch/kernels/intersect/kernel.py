"""Sorted membership mask: the CUDA kernel's wrapper and its plain version.

``mask[i] = a[i] in b`` for sorted int64 doc-id lists — the doc prefilter
of the ``cuda`` window join and of ``decode_member_prefilter``.  The CUDA
kernel (``csrc/sorted_member_mask.cu``) ports the Pallas
``intersect_kernel``; the source says how and what bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda_lib import CudaKernel, check_operand

SORTED_MEMBER_MASK = CudaKernel(
    "sorted_member_mask",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_void_p],
    source="src/repro_torch/csrc/sorted_member_mask.cu",
    replaces="src/repro/kernels/intersect/kernel.py:46",
)


def sorted_member_mask_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.searchsorted`` and an equality test."""
    if b.numel() == 0:
        return torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    idx = torch.searchsorted(b, a).clamp_(max=b.numel() - 1)
    return b[idx] == a


def sorted_member_mask(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N,) bool: ``a[i]`` occurs in ``b``.

    ``a`` (N,) and ``b`` (M,) are sorted int64 on one device, ``b``
    without duplicates.  CUDA tensors go through the kernel; CPU tensors
    through :func:`sorted_member_mask_plain`."""
    check_operand(a, "a", torch.int64)
    check_operand(b, "b", torch.int64)
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.device.type == "cpu":
        return sorted_member_mask_plain(a, b)
    out = torch.empty(a.shape, dtype=torch.bool, device=a.device)
    SORTED_MEMBER_MASK.launch(
        a.device, (a.numel(), b.numel()), a.data_ptr(), a.numel(), b.data_ptr(), b.numel(),
        out.data_ptr(),
    )
    return out
