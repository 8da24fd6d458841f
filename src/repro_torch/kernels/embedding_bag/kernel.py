"""Fixed-size EmbeddingBag: the CUDA kernel's wrapper.

``out[b] = sum_k weights[b, k] * table[ids[b, k]]`` for K ids a bag,
summed in f32 and cast to the table's dtype, as in the Pallas
``embedding_bag_kernel`` that the CUDA kernel (``csrc/embedding_bag.cu``)
ports; the source says how and what bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda_lib import (
    FLOAT_CODES,
    CudaKernel,
    check_float_operand,
)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_fixed_plain

EMBEDDING_BAG = CudaKernel(
    "embedding_bag",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4,
    source="src/repro_torch/csrc/embedding_bag.cu",
    replaces="src/repro/kernels/embedding_bag/kernel.py:40",
)


def embedding_bag_fixed(table: torch.Tensor, ids: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """(B, D) bag sums in ``table.dtype``.

    ``table`` (V, D) is f32 or bf16 and contiguous; ``ids`` (B, K) is
    int32 and ``weights`` (B, K) f32; all on one device.  CUDA tensors go
    through the kernel; CPU tensors through
    :func:`embedding_bag_fixed_plain`.  Ids must lie in ``[0, V)``: the
    kernel does not check them (an id outside reads another row or
    faults), the plain version raises on them, and the reference's
    gather clamps them."""
    check_float_operand(table, "table", 2)
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if not isinstance(ids, torch.Tensor) or ids.dtype != torch.int32:
        raise TypeError("ids must be an int32 tensor")
    if ids.dim() != 2:
        raise ValueError(f"ids must be (B, K), got {tuple(ids.shape)}")
    if not isinstance(weights, torch.Tensor) or weights.dtype != torch.float32:
        raise TypeError("weights must be a float32 tensor")
    if weights.shape != ids.shape:
        raise ValueError(f"weights {tuple(weights.shape)} and ids "
                         f"{tuple(ids.shape)} differ in shape")
    devices = {t.device for t in (table, ids, weights)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    if table.device.type == "cpu":
        return embedding_bag_fixed_plain(table, ids, weights)
    if not (ids.is_contiguous() and weights.is_contiguous()):
        raise ValueError("ids and weights must be contiguous")
    (B, K), D = ids.shape, table.shape[1]
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out
    EMBEDDING_BAG.launch(
        table.device, (B, K, D),
        table.data_ptr(), ids.data_ptr(), weights.data_ptr(), out.data_ptr(),
        FLOAT_CODES[table.dtype], B, K, D,
    )
    return out
