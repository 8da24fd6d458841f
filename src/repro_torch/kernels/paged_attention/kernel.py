"""Paged decode attention: the CUDA kernel's wrapper and its split rule.

One query token per row attends to the first ``lengths[b]`` tokens of the
pages ``block_table[b, :]`` of a shared (n_pages, page, D) pool; the pool
has no head axis, so all H heads of a row read the same K/V.  m, l and the
accumulator are f32 and the output has the input dtype, as in the Pallas
``paged_attention_kernel`` that the CUDA kernel
(``csrc/paged_attention.cu``) ports; the source says how and what bounds
it.  Page ids must lie in ``[0, n_pages)``; they are not checked on the
device.

On request (``return_lse``) the kernel also writes each row and head's
natural-log log-sum-exp of its scaled scores over its valid tokens, in
f32, :data:`~repro_torch.kernels.paged_attention.ref.LSE_EMPTY` for a row
of length 0: callers that hold a row's tokens in several blocks (a
decode cache whose sequence is split over ranks) merge their outputs by
it.  The output is the same with it and without it.

The kernel splits each row's tokens over several blocks;
:func:`paged_split` sets the pages a split covers from static shapes
only (it never reads ``lengths``, which would wait for the device).
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Dict, Tuple, Union

import torch

from repro_torch.kernels.costs import paged_cost
from repro_torch.kernels.cuda_lib import (
    FLOAT_CODES,
    CudaKernel,
    check_float_operand,
    require_no_grad,
    stream_handle,
)
from repro_torch.kernels.paged_attention.ref import paged_attention_plain

PAGED_ATTENTION = CudaKernel(
    "paged_attention",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float],
    source="src/repro_torch/csrc/paged_attention.cu",
    replaces="src/repro/kernels/paged_attention/kernel.py:75",
)

SMS = 132                 # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 16        # blocks a full-length launch asks for, per SM
MIN_SPLIT_TOKENS = 128    # below this a split's fill and combine dominate
MAX_SPLIT_PAGES = 256     # the table slice a block stages (kMaxSplitPages)


def head_group(H: int) -> int:
    """Heads of one block: 1, 2, 4 or 8, the least that is >= min(H, 8)."""
    return next(g for g in (1, 2, 4, 8) if g >= min(H, 8))


@lru_cache(maxsize=256)
def paged_split(B: int, H: int, max_pages: int, page: int) -> int:
    """Table entries (pages) one block covers: enough splits of each row
    that a full-length launch of ``B`` rows asks for ``BLOCKS_PER_SM``
    blocks on each SM, splits of at least ``MIN_SPLIT_TOKENS`` tokens and
    at most ``MAX_SPLIT_PAGES`` pages, and one split when a row fits in
    it.  The launch has ``ceil(max_pages / pages)`` splits a row."""
    groups = B * -(-H // head_group(H))
    splits = -(-BLOCKS_PER_SM * SMS // groups)
    pages = max(-(-max_pages // splits), -(-MIN_SPLIT_TOKENS // page))
    return min(pages, max_pages, MAX_SPLIT_PAGES)


class _Combine:
    """The split partials and tickets of the launches on one stream; the
    tickets are zeroed when allocated and every launch leaves them zero."""

    def __init__(self, n_part: int, n_tickets: int, device: torch.device):
        self.part = torch.empty(n_part, dtype=torch.float32, device=device)
        self.tickets = torch.zeros(n_tickets, dtype=torch.int32,
                                   device=device)


_scratch: Dict[Tuple[torch.device, int], _Combine] = {}


def _combine_scratch(device: torch.device, stream: int, n_part: int,
                     n_tickets: int) -> _Combine:
    sc = _scratch.get((device, stream))
    if (sc is None or sc.part.numel() < n_part
            or sc.tickets.numel() < n_tickets):
        grow = (sc.part.numel(), sc.tickets.numel()) if sc else (0, 0)
        sc = _scratch[(device, stream)] = _Combine(
            max(n_part, grow[0]), max(n_tickets, grow[1]), device)
    return sc


HEAD_DIMS = (8, 16, 32, 64, 128)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor, return_lse: bool = False
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """(B, H, D) decode attention output in ``q.dtype``; with
    ``return_lse`` also its (B, H) f32 log-sum-exp.

    ``q`` (B, H, D) and the pools (n_pages, page, D) share one dtype (f32
    or bf16) and are contiguous; ``block_table`` (B, max_pages) and
    ``lengths`` (B,) are int32; all on one device.  CUDA tensors go
    through the kernel, which has no backward: under grad mode an operand
    that requires grad raises.  CPU tensors go through
    :func:`paged_attention_plain`, which differentiates."""
    check_float_operand(q, "q", 3)
    check_float_operand(k_pool, "k_pool", 3)
    check_float_operand(v_pool, "v_pool", 3)
    B, H, D = q.shape
    if k_pool.shape != v_pool.shape or k_pool.shape[2] != D:
        raise ValueError(f"q {tuple(q.shape)}, k_pool {tuple(k_pool.shape)}, "
                         f"v_pool {tuple(v_pool.shape)}")
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise TypeError(
            f"dtypes differ: {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    for name, t, shape in (("block_table", block_table, None),
                           ("lengths", lengths, (B,))):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"{name} must be an int32 tensor")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(
            f"block_table must be ({B}, max_pages), got "
            f"{tuple(block_table.shape)}")
    devices = {t.device for t in (q, k_pool, v_pool, block_table, lengths)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_table, lengths,
                                     return_lse=return_lse)
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    require_no_grad("paged_attention", q, k_pool, v_pool,
                    hint="it serves decode only: call it under torch.no_grad()")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    page, max_pages = k_pool.shape[1], block_table.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    result = (out, lse) if return_lse else out
    if B == 0 or H == 0:
        return result
    # a dry run has no lengths: it charges every row its whole table
    if PAGED_ATTENTION.charged(
            (q, k_pool, v_pool, block_table, lengths), lambda: paged_cost(
                B, H, D, B * max_pages * page, B * max_pages, q.dtype,
                lse=return_lse)):
        return result
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the pools must be 16-byte aligned")
    pages = paged_split(B, H, max_pages, page)
    part = tickets = None
    stream = None
    if pages < max_pages:
        hg = head_group(H)
        n_groups = B * -(-H // hg)
        stream = stream_handle(q.device)
        sc = _combine_scratch(q.device, stream,
                              n_groups * -(-max_pages // pages) * hg * (D + 2),
                              n_groups)
        part, tickets = sc.part.data_ptr(), sc.tickets.data_ptr()
    PAGED_ATTENTION.launch(
        q.device, (B, H, max_pages, page, D),
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), part, tickets,
        FLOAT_CODES[q.dtype], B, H, D, page, max_pages, pages,
        1.0 / math.sqrt(D), stream=stream,
    )
    return result
