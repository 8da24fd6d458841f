"""Flash attention: the CUDA kernel's wrapper.

Online-softmax attention over (B, H, S, D) queries and (B, Hkv, S, D) keys
and values, causal or not; query head ``h`` reads KV head ``h // (H //
Hkv)`` (GQA without expanding K/V).  m, l and the accumulator are f32 and
the output has the input dtype, as in the Pallas ``flash_attention_kernel``
that the CUDA kernel (``csrc/flash_attention.cu``) ports; the source says
how and what bounds it.  Any S: the kernel masks the ragged edge itself,
so there is no ``S % bq`` condition.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.cuda_lib import (
    FLOAT_CODES,
    CudaKernel,
    check_float_operand,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

FLASH_ATTENTION = CudaKernel(
    "flash_attention",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
    + [ctypes.c_int, ctypes.c_float],
    source="src/repro_torch/csrc/flash_attention.cu",
    replaces="src/repro/kernels/flash_attention/kernel.py:73",
)

HEAD_DIMS = (8, 16, 32, 64, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """(B, H, S, D) attention output in ``q.dtype``.

    ``q`` is (B, H, S, D); ``k`` and ``v`` are (B, Hkv, S, D) with ``H %
    Hkv == 0``, all of one dtype (f32 or bf16) on one device, each with a
    contiguous last dim (other strides are free).  CUDA tensors go through
    the kernel; CPU tensors through :func:`flash_attention_plain`."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_float_operand(t, name, 4)
    B, H, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, D):
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    Hkv = k.shape[1]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads over {Hkv} KV heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    FLASH_ATTENTION.launch(
        q.device, (B, H, Hkv, S, D),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        FLOAT_CODES[q.dtype], B, H, Hkv, S, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), 1.0 / math.sqrt(D),
    )
    return out
