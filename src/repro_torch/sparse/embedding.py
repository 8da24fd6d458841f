"""Sparse embedding ops, the port of ``repro.sparse.embedding``.

The reference builds them from ``jnp.take`` and ``jax.ops.segment_*``;
here they are ``index_select``, ``index_add_`` and ``scatter_reduce``.
None of them is a Pallas kernel in the reference, so plain PyTorch is
their port.  The fused fixed-size bag that DLRM's lookups go through is
``repro_torch.kernels.embedding_bag``.

Out-of-range ids give the reference's values, with one compare and
select an id and no host check: a lookup follows ``jnp.take``'s fill rule
(an id in ``[-vocab, 0)`` wraps, any other id outside the table reads a
NaN row), and a segment id outside ``[0, num_segments)`` is dropped, as
``jax.ops.segment_sum`` drops it.  ``segment_softmax`` takes any segment
id and returns what the reference returns.
"""

from __future__ import annotations

from typing import Optional

import torch


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain row gather: ``(...)`` ids -> ``(..., dim)`` in ``dtype``, an
    id in ``[-vocab, 0)`` wrapped and a row of NaN for any other id
    outside the table (``jnp.take``'s fill rule)."""
    V = table.shape[0]
    i = ids.reshape(-1).long()
    i = torch.where(i < 0, i + V, i)
    ok = (i >= 0) & (i < V)
    rows = table.index_select(0, torch.where(ok, i, 0)).to(dtype)
    rows = torch.where(ok[:, None], rows, float("nan"))
    return rows.reshape(*ids.shape, table.shape[1])


def embedding_bag(
    table: torch.Tensor,        # (vocab, dim)
    ids: torch.Tensor,          # (n_ids,) flat indices
    segment_ids: torch.Tensor,  # (n_ids,) output row per id, any order
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
    mode: str = "sum",
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """EmbeddingBag over ragged bags given by explicit segment ids: rows
    (:func:`embedding_lookup`'s) are cast to ``dtype`` before the
    weights, as in the reference, and summed into their segment in
    ``dtype``; ``mean`` divides by the bag's size (at least 1, so an
    empty bag stays zero).  An id whose segment lies outside
    ``[0, num_segments)``, negative included, is dropped from both the
    sum and the count (it lands in one extra row that is cut off)."""
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    rows = embedding_lookup(table, ids, dtype)
    if weights is not None:
        rows = rows * weights[:, None].to(dtype)
    n = num_segments
    seg = segment_ids.long()
    seg = torch.where((seg >= 0) & (seg < n), seg, n)
    out = torch.zeros((n + 1, table.shape[1]), dtype=dtype,
                      device=table.device).index_add_(0, seg, rows)[:n]
    if mode == "mean":
        cnt = torch.zeros(n + 1, dtype=dtype, device=table.device)
        cnt.index_add_(0, seg, torch.ones_like(seg, dtype=dtype))
        out = out / cnt[:n].clamp(min=1)[:, None]
    return out


def segment_softmax(
    logits: torch.Tensor,       # (n,) or (n, h)
    segment_ids: torch.Tensor,  # (n,)
    num_segments: int,
) -> torch.Tensor:
    """Softmax within segments (GAT-style attention over ragged
    neighbours), with a floor of 1e-20 on each denominator.

    A segment id outside ``[0, num_segments)`` gives the reference's
    answer, that of JAX's segment reductions and gather: it is left out
    of every segment's max and sum (here it lands in one extra row that
    is cut off), and the read-back clamps an id past the end and wraps a
    negative one.  So such an entry is divided by the segment it is read
    from, ``inf`` where that segment is empty; nothing raises or asserts."""
    seg = segment_ids.long()
    n = num_segments
    dropped = torch.where((seg >= 0) & (seg < n), seg, n)
    read = torch.where(seg < 0, seg + n, seg).clamp(0, n - 1)
    idx = dropped.reshape(-1, *([1] * (logits.dim() - 1))).expand_as(logits)
    shape = (n + 1, *logits.shape[1:])
    mx = torch.full(shape, float("-inf"), dtype=logits.dtype,
                    device=logits.device)
    mx = mx.scatter_reduce(0, idx, logits, "amax", include_self=True)[:n]
    z = torch.exp(logits - mx[read])
    denom = torch.zeros(shape, dtype=z.dtype, device=z.device)
    denom = denom.index_add_(0, dropped, z)[:n]
    return z / torch.clamp(denom[read], min=1e-20)
