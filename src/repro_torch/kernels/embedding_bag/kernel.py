"""Fixed-size EmbeddingBag: the CUDA kernel's wrapper.

``out[b] = sum_k weights[b, k] * table[ids[b, k]]`` for K ids a bag,
summed in f32 and cast to the table's dtype, as in the Pallas
``embedding_bag_kernel`` that the CUDA kernel (``csrc/embedding_bag.cu``)
ports; the source says how and what bounds it.  Under autograd the bag
is one ``torch.autograd.Function`` whose backward is plain PyTorch on
both devices (:func:`embedding_bag_fixed_backward`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.cuda_lib import (
    FLOAT_CODES,
    CudaKernel,
    check_float_operand,
)
from repro_torch.kernels.embedding_bag.ref import (
    ID_RULES,
    embedding_bag_fixed_plain,
    resolve_ids,
)

EMBEDDING_BAG = CudaKernel(
    "embedding_bag",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6,
    source="src/repro_torch/csrc/embedding_bag.cu",
    replaces="src/repro/kernels/embedding_bag/kernel.py:40",
)


def embedding_bag_fixed(table: torch.Tensor, ids: torch.Tensor,
                        weights: torch.Tensor,
                        id_rule: str = "clip") -> torch.Tensor:
    """(B, D) bag sums in ``table.dtype``, differentiable in ``table`` and
    ``weights``.

    ``table`` (V, D) is f32 or bf16 and contiguous; ``ids`` (B, K) is
    int32 and ``weights`` (B, K) f32; all on one device.  The forward
    takes the kernel for CUDA tensors and :func:`embedding_bag_fixed_plain`
    for CPU tensors; the backward is :func:`embedding_bag_fixed_backward`
    on both.  An id outside ``[0, V)`` is read under ``id_rule``, on the
    card and on the CPU alike (:func:`~.ref.resolve_ids`): ``clip``, the
    rule of the Pallas kernel and its oracle, or ``fill``, the rule of
    ``jnp.take`` that the reference's DLRM lookups follow (a NaN row)."""
    if id_rule not in ID_RULES:
        raise ValueError(f"id_rule must be one of {ID_RULES}, got {id_rule!r}")
    if table.shape[0] == 0 and ids.numel() > 0:
        raise ValueError("ids index a table of no rows")
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
    if table.device.type != "cpu" and not (ids.is_contiguous()
                                           and weights.is_contiguous()):
        raise ValueError("ids and weights must be contiguous")
    return _EmbeddingBagFixed.apply(table, ids, weights, id_rule)


def _launch(table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
            id_rule: str = "clip") -> torch.Tensor:
    (B, K), (V, D) = ids.shape, table.shape
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out
    EMBEDDING_BAG.launch(
        table.device, (B, K, D),
        table.data_ptr(), ids.data_ptr(), weights.data_ptr(), out.data_ptr(),
        FLOAT_CODES[table.dtype], B, K, D, V, ID_RULES.index(id_rule),
    )
    return out


def embedding_bag_fixed_backward(
    grad_out: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
    table_shape: Tuple[int, int], table_dtype: torch.dtype,
    table: Optional[torch.Tensor] = None,
    id_rule: str = "clip",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The bag's gradients, in plain PyTorch on either device:
    ``grad_table = zeros(V, D, f32).index_add_(0, rows, w * grad_out)``
    cast to ``table_dtype`` (the scatter-add that XLA makes of the
    reference's gather gradient), and, when ``table`` is given,
    ``grad_weights[b, k] = sum_d grad_out[b, d] * table[rows[b, k], d]``
    in f32.  ``rows`` are the ids as the forward read them under
    ``id_rule``.  The table's gradient follows the reference's gradients
    under either rule (``jax.grad`` of the oracle's clamping gather and
    of ``take`` alike): a negative id in ``[-V, 0)`` lands on its wrapped
    row, and an id out of range after the wrap adds nothing (its
    scatter is dropped, not clamped).  Its weight's gradient reads the
    row the forward read: the clamped one under ``clip``, NaN under
    ``fill``."""
    V, D = table_shape
    g = grad_out.float()
    rows_idx, ok = resolve_ids(ids, V, id_rule)
    contrib = weights[..., None] * g[:, None, :]
    if id_rule == "clip":
        _, ok_scatter = resolve_ids(ids, V, "fill")
    else:
        ok_scatter = ok
    contrib = torch.where(ok_scatter[..., None], contrib, 0.0)
    contrib = contrib.reshape(-1, D)
    grad_table = torch.zeros(table_shape, dtype=torch.float32,
                             device=grad_out.device)
    grad_table.index_add_(0, rows_idx.reshape(-1), contrib)
    grad_weights = None
    if table is not None:
        rows = table.index_select(0, rows_idx.reshape(-1)).reshape(
            *ids.shape, D).float()
        if ok is not None:
            rows = torch.where(ok[..., None], rows, float("nan"))
        grad_weights = (rows * g[:, None, :]).sum(-1)
    return grad_table.to(table_dtype), grad_weights


class _EmbeddingBagFixed(torch.autograd.Function):
    """The bag under autograd.  The reference differentiates a gather
    (``jnp.take``), whose gradient XLA lowers to a scatter-add outside
    any Pallas kernel, so there is no backward kernel to port: one plain
    backward serves both devices, and the CPU tests run the same
    ``Function`` that the card does."""

    @staticmethod
    def forward(ctx, table, ids, weights, id_rule):
        if table.device.type == "cpu":
            out = embedding_bag_fixed_plain(table, ids, weights,
                                            id_rule=id_rule)
        else:
            out = _launch(table, ids, weights, id_rule)
        ctx.table_shape, ctx.table_dtype = tuple(table.shape), table.dtype
        ctx.id_rule = id_rule
        ctx.save_for_backward(ids, weights,
                              table if ctx.needs_input_grad[2] else None)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        ids, weights, table = ctx.saved_tensors
        grad_table, grad_weights = embedding_bag_fixed_backward(
            grad_out, ids, weights, ctx.table_shape, ctx.table_dtype, table,
            ctx.id_rule)
        return (grad_table if ctx.needs_input_grad[0] else None, None,
                grad_weights, None)
