"""The plain PyTorch version of the fixed-size EmbeddingBag: the function
that ``repro.kernels.embedding_bag`` computes (an f32 sum of weighted
rows, cast to the table's dtype), in the CUDA kernel's arithmetic.  The
wrapper in ``kernel.py`` takes it for CPU tensors; the card's checks
hold the kernel against it."""

from __future__ import annotations

import torch


ID_RULES = ("clip", "fill")


def resolve_ids(ids: torch.Tensor, V: int, id_rule: str = "clip"):
    """``(rows, ok)``: the table row each id reads under ``id_rule``, and
    for ``fill`` a mask of the ids that read one (None for ``clip``).

    ``clip`` is the rule of the Pallas kernel and its oracle: a negative
    id wraps once by ``V``, then is clamped to ``[0, V)``.  ``fill`` is
    ``jnp.take``'s: an id in ``[-V, 0)`` wraps, any other id outside the
    table reads a NaN row (its entry of ``rows`` is 0, masked out)."""
    if id_rule not in ID_RULES:
        raise ValueError(f"id_rule must be one of {ID_RULES}, got {id_rule!r}")
    i = ids.long()
    i = torch.where(i < 0, i + V, i)
    if id_rule == "clip":
        return i.clamp(0, V - 1), None
    ok = (i >= 0) & (i < V)
    return torch.where(ok, i, 0), ok


def embedding_bag_fixed_plain(
    table: torch.Tensor,    # (V, D)
    ids: torch.Tensor,      # (B, K)
    weights: torch.Tensor,  # (B, K)
    mode: str = "sum",
    id_rule: str = "clip",
) -> torch.Tensor:
    """``out[b] = sum_k w[b, k] * table[ids[b, k]]`` in f32, cast to
    ``table.dtype``, each id read under ``id_rule`` (:func:`resolve_ids`;
    a NaN row in ``fill`` mode makes its bag NaN).  ``mode="mean"``
    divides the f32 sum by ``max(sum_k w[b, k], 1e-9)`` first, the
    oracle of ``repro.kernels.embedding_bag.ref``; the kernel computes
    ``sum``."""
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    rows_idx, ok = resolve_ids(ids, table.shape[0], id_rule)
    rows = table[rows_idx].float()
    if ok is not None:
        rows = torch.where(ok[..., None], rows, float("nan"))
    out = (rows * weights[..., None].float()).sum(1)
    if mode == "mean":
        out = out / weights.float().sum(1).clamp(min=1e-9)[:, None]
    return out.to(table.dtype)


def embedding_bags_plain(tables, ids: torch.Tensor, weights: torch.Tensor,
                         id_rule: str = "clip", *, dtype=None, head=None,
                         out=None) -> torch.Tensor:
    """The grouped bag of :func:`~.kernel.embedding_bags` in plain
    PyTorch: table ``t``'s bags, :func:`embedding_bag_fixed_plain` of
    ``tables[t]``, ``ids[t]`` and ``weights[t]`` (rounded to the table's
    dtype), converted into slot ``t`` of a (B, T, D) result in ``dtype``
    (the tables' by default), or slot ``t + 1`` of a (B, T + 1, D) one
    whose slot 0 is ``head`` (B, D).  ``out`` takes the result in place
    of a new tensor.  Differentiable in the tables, weights and head by
    autograd."""
    lead = 0 if head is None else 1
    if out is None:
        out = torch.empty(
            (ids.shape[1], len(tables) + lead, tables[0].shape[1]),
            dtype=dtype or tables[0].dtype, device=ids.device)
    if head is not None:
        out[:, 0] = head
    for t, table in enumerate(tables):
        out[:, lead + t] = embedding_bag_fixed_plain(
            table, ids[t], weights[t], id_rule=id_rule)
    return out
