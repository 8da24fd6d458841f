"""Fixed-size EmbeddingBag: the CUDA kernel's wrapper.

``out[b] = sum_k weights[b, k] * table[ids[b, k]]`` for K ids a bag,
summed in f32 and cast to the table's dtype, as in the Pallas
``embedding_bag_kernel`` that the CUDA kernel (``csrc/embedding_bag.cu``)
ports; the source says how and what bounds it.  One C entry serves any
number of tables of one width and dtype in one launch
(:func:`embedding_bags`, DLRM's lookups into the interaction's input),
each table whole or one rank's block of rows of a table split over a
mesh (its window); :func:`embedding_bag_fixed` is its group of one.  Under autograd each is
one ``torch.autograd.Function`` whose backward is plain PyTorch on both
devices (:func:`embedding_bag_fixed_backward`, once a table).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.costs import bag_launch_cost
from repro_torch.kernels.cuda_lib import (
    FLOAT_CODES,
    CudaKernel,
    check_float_operand,
)
from repro_torch.kernels.embedding_bag.ref import (
    ID_RULES,
    embedding_bag_fixed_plain,
    embedding_bags_plain,
    resolve_ids,
    resolve_window,
)
from repro_torch.obs import span

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
EMBEDDING_BAG = CudaKernel(
    "embedding_bags",
    [_P, _P, _P, _P, _I, _P, _L, _L, _P, _L, _L, _P, _L, _L] + [_I] * 6,
    source="src/repro_torch/csrc/embedding_bag.cu",
    replaces="src/repro/kernels/embedding_bag/kernel.py:40",
)
MAX_TABLES = 64   # tables a launch: csrc/embedding_bag.cu's kMaxTables


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


def _launch(tables: Sequence[torch.Tensor], ids: torch.Tensor,
            weights: torch.Tensor, out: torch.Tensor, id_rule: str,
            windows: Optional[Sequence[Tuple[int, int]]] = None) -> None:
    """One launch over ``tables``: ``ids`` and ``weights`` (T, B, K) and
    ``out`` (T, B, D), views whose last dim is contiguous, each table's
    bags written into ``out[t]``; ``windows`` one ``(first, V)`` a table
    (None: each table whole)."""
    n, B, K = ids.shape
    D = out.shape[2]
    if B == 0 or D == 0:
        return
    if EMBEDDING_BAG.charged(
            (*tables, ids, weights, out), lambda: bag_launch_cost(
                tables, B, K, 4 * _distinct(weights),
                n * B * D * out.element_size())):
        return
    if windows is None:
        windows = [(0, t.shape[0]) for t in tables]
    EMBEDDING_BAG.launch(
        ids.device, (n, B, K, D),
        (ctypes.c_void_p * n)(*[t.data_ptr() for t in tables]),
        (ctypes.c_int * n)(*[t.shape[0] for t in tables]),
        (ctypes.c_int * n)(*[w[0] for w in windows]),
        (ctypes.c_int * n)(*[w[1] for w in windows]), n,
        ids.data_ptr(), ids.stride(0), ids.stride(1),
        weights.data_ptr(), weights.stride(0), weights.stride(1),
        out.data_ptr(), out.stride(0), out.stride(1),
        FLOAT_CODES[tables[0].dtype], FLOAT_CODES[out.dtype], B, K, D,
        ID_RULES.index(id_rule),
    )


def _distinct(t: torch.Tensor) -> int:
    """The elements of ``t`` that lie apart in memory (a dim of stride
    0, as ``expand`` makes, holds one)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def embedding_bag_fixed_backward(
    grad_out: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
    table_shape: Tuple[int, int], table_dtype: torch.dtype,
    table: Optional[torch.Tensor] = None,
    id_rule: str = "clip",
    window: Optional[Tuple[int, int]] = None,
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
    ``fill``.  With ``window`` ``(first, V)`` the table is the block of
    rows ``[first, first + n)`` of a whole table of ``V`` rows
    (:func:`~.ref.resolve_window`): an id adds to the block's gradient
    only where its row lies in the block (no weight gradient is
    given)."""
    n, D = table_shape
    g = grad_out.float()
    if window is not None and table is not None:
        raise ValueError("a windowed bag gives no weight gradient")
    rows_idx, ok, add = resolve_window(ids, n, window, id_rule)
    contrib = weights[..., None] * g[:, None, :]
    # an id out of range after the wrap adds nothing under either rule
    ok_scatter = resolve_ids(ids, n if window is None else window[1],
                             "fill")[1] if id_rule == "clip" else ok
    if add is not None:
        ok_scatter = ok_scatter & add
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
            out = torch.empty((ids.shape[0], table.shape[1]),
                              dtype=table.dtype, device=table.device)
            _launch((table,), ids[None], weights[None], out[None], id_rule)
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


def embedding_bags(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                   weights: torch.Tensor, id_rule: str = "clip", *,
                   dtype: Optional[torch.dtype] = None,
                   head: Optional[torch.Tensor] = None,
                   windows: Optional[Sequence[Tuple[int, int]]] = None
                   ) -> torch.Tensor:
    """The bags of ``T`` tables in one launch: a (B, T, D) result whose
    slot ``t`` is ``sum_k weights[t, b, k] * tables[t][ids[t, b, k]]``,
    summed in f32, rounded to the tables' dtype and converted to
    ``dtype`` (the tables' by default), as
    ``embedding_bag_fixed(tables[t], ids[t], weights[t]).to(dtype)``
    gives it, bit for bit.  With ``head`` (B, D) the result is (B, T + 1,
    D) with ``head`` converted into slot 0 and table ``t`` in slot
    ``t + 1``: DLRM's interaction input, written once.

    ``tables`` are 1 to MAX_TABLES (V_t, D) contiguous tables of one
    dtype (f32 or bf16) and one D; ``ids`` (T, B, K) int32 and
    ``weights`` (T, B, K) f32 may be any views whose K dim is contiguous
    (a stride of 0 shares, as ``ones.expand``; the caller's (B, T) ids
    transposed need no copy).  Ids outside a table follow ``id_rule`` as
    in :func:`embedding_bag_fixed`.  ``windows`` (one ``(first, V)`` a
    table) makes ``tables[t]`` the rows ``[first, first + V_t)`` of a
    whole table of ``V`` rows: its ids resolve against ``V`` under
    ``id_rule`` and an id of a row outside the block adds nothing to its
    bag (so the blocks' bags sum to the whole table's); None, or ``(0,
    V_t)``, is the table whole.  CUDA operands launch the kernel,
    CPU ones take :func:`~.ref.embedding_bags_plain`.  Differentiable in
    the tables and head (weights that need a gradient take
    :func:`embedding_bag_fixed`): the backward is
    :func:`embedding_bag_fixed_backward` once a table, given the
    result's gradient cast back through the output's and the table's
    dtypes, as autograd would through the per-table bag and its cast."""
    if id_rule not in ID_RULES:
        raise ValueError(f"id_rule must be one of {ID_RULES}, got {id_rule!r}")
    tables = tuple(tables)
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(f"1 to {MAX_TABLES} tables a launch, got "
                         f"{len(tables)}")
    first = tables[0]
    check_float_operand(first, "tables[0]", 2)
    D, device = first.shape[1], first.device
    if not isinstance(ids, torch.Tensor) or ids.dtype != torch.int32:
        raise TypeError("ids must be an int32 tensor")
    if ids.dim() != 3 or ids.shape[0] != len(tables):
        raise ValueError(f"ids must be (T, B, K) with T = {len(tables)}, "
                         f"got {tuple(ids.shape)}")
    if not isinstance(weights, torch.Tensor) or weights.dtype != torch.float32:
        raise TypeError("weights must be a float32 tensor")
    if weights.shape != ids.shape:
        raise ValueError(f"weights {tuple(weights.shape)} and ids "
                         f"{tuple(ids.shape)} differ in shape")
    if weights.requires_grad and torch.is_grad_enabled():
        raise ValueError("the grouped bag gives no gradient of its weights; "
                         "call embedding_bag_fixed a table")
    for i, t in enumerate(tables):
        if (not isinstance(t, torch.Tensor) or t.dtype != first.dtype
                or t.dim() != 2 or t.shape[1] != D):
            raise ValueError(f"tables[{i}] is not a (V, {D}) {first.dtype} "
                             "table")
        if not t.is_contiguous():
            raise ValueError(f"tables[{i}] must be contiguous")
        if t.shape[0] >= 2 ** 31 or (t.shape[0] == 0 and ids.numel() > 0):
            raise ValueError(f"tables[{i}] has {t.shape[0]} rows")
    dtype = first.dtype if dtype is None else dtype
    if dtype not in FLOAT_CODES:
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    if head is not None and (not isinstance(head, torch.Tensor)
                             or head.shape != (ids.shape[1], D)):
        raise ValueError(f"head must be ({ids.shape[1]}, {D})")
    if windows is not None:
        windows = tuple((int(f), int(v)) for f, v in windows)
        if len(windows) != len(tables):
            raise ValueError(f"{len(windows)} windows for {len(tables)} "
                             "tables")
        for i, ((f, v), t) in enumerate(zip(windows, tables)):
            if not 0 <= f <= v - t.shape[0] or v >= 2 ** 31:
                raise ValueError(f"tables[{i}] of {t.shape[0]} rows does not "
                                 f"lie at row {f} of a {v}-row table")
    operands = [*tables, ids, weights] + ([] if head is None else [head])
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    if device.type != "cpu" and ids.shape[2] > 1 and (
            ids.stride(2) != 1 or weights.stride(2) != 1):
        raise ValueError("ids and weights must be contiguous along K")
    with span("lookup"):
        return _EmbeddingBags.apply(head, ids, weights, id_rule, dtype,
                                    windows, *tables)


class _EmbeddingBags(torch.autograd.Function):
    """The grouped bag under autograd: one launch forward (the plain
    version on the CPU), the plain backward once a table that needs a
    gradient."""

    @staticmethod
    def forward(ctx, head, ids, weights, id_rule, dtype, windows, *tables):
        n, B, _ = ids.shape
        lead = 0 if head is None else 1
        out = torch.empty((B, n + lead, tables[0].shape[1]), dtype=dtype,
                          device=ids.device)
        if head is not None:
            out[:, 0] = head
        slots = out[:, lead:]
        if ids.device.type == "cpu":
            embedding_bags_plain(tables, ids, weights, id_rule, out=slots,
                                 windows=windows)
        else:
            _launch(tables, ids, weights, slots.transpose(0, 1), id_rule,
                    windows)
        ctx.lead, ctx.id_rule, ctx.windows = lead, id_rule, windows
        ctx.head_dtype = None if head is None else head.dtype
        ctx.tables = [(tuple(t.shape), t.dtype) for t in tables]
        ctx.save_for_backward(ids, weights)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        ids, weights = ctx.saved_tensors
        grad_tables = [
            embedding_bag_fixed_backward(
                grad_out[:, ctx.lead + t].to(dtype), ids[t], weights[t],
                shape, dtype, id_rule=ctx.id_rule,
                window=None if ctx.windows is None else ctx.windows[t])[0]
            if ctx.needs_input_grad[6 + t] else None
            for t, (shape, dtype) in enumerate(ctx.tables)]
        grad_head = None
        if ctx.lead and ctx.needs_input_grad[0]:
            grad_head = grad_out[:, 0].to(ctx.head_dtype)
        return (grad_head, None, None, None, None, None, *grad_tables)
