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


def resolve_window(ids: torch.Tensor, n: int, window, id_rule: str = "clip"):
    """``(rows, ok, add)`` for a block of ``n`` rows that is the rows
    ``[first, first + n)`` of a whole table of ``V`` rows (``window`` is
    ``(first, V)``): each id resolved against ``V`` under ``id_rule``
    (:func:`resolve_ids`), ``rows`` its row of the block (0 where it has
    none), ``ok`` the ``fill`` mask (None for ``clip``) and ``add`` the
    ids that add to their bag, those whose row lies in the block and,
    under ``fill``, those outside the whole table (a NaN row on every
    block).  ``add`` is None where ``window`` is None (every id adds)."""
    if window is None:
        rows, ok = resolve_ids(ids, n, id_rule)
        return rows, ok, None
    first, V = window
    rows, ok = resolve_ids(ids, V, id_rule)
    at = rows - first
    here = (at >= 0) & (at < n)
    add = here if ok is None else here | ~ok
    return torch.where(here, at, 0), ok, add


def embedding_bag_fixed_plain(
    table: torch.Tensor,    # (V, D)
    ids: torch.Tensor,      # (B, K)
    weights: torch.Tensor,  # (B, K)
    mode: str = "sum",
    id_rule: str = "clip",
    window=None,
) -> torch.Tensor:
    """``out[b] = sum_k w[b, k] * table[ids[b, k]]`` in f32, cast to
    ``table.dtype``, each id read under ``id_rule`` (:func:`resolve_ids`;
    a NaN row in ``fill`` mode makes its bag NaN).  With ``window``
    ``(first, V)``, ``table`` is the block of rows ``[first, first + n)``
    of a whole table of ``V`` rows: ids resolve against ``V`` and those
    of rows outside the block add nothing (:func:`resolve_window`).
    ``mode="mean"`` divides the f32 sum by ``max(sum_k w[b, k], 1e-9)``
    first, the oracle of ``repro.kernels.embedding_bag.ref``; the kernel
    computes ``sum``."""
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    rows_idx, ok, add = resolve_window(ids, table.shape[0], window, id_rule)
    rows = table[rows_idx].float()
    if ok is not None:
        rows = torch.where(ok[..., None], rows, float("nan"))
    terms = rows * weights[..., None].float()
    if add is not None:
        terms = torch.where(add[..., None], terms, 0.0)
    out = terms.sum(1)
    if mode == "mean":
        out = out / weights.float().sum(1).clamp(min=1e-9)[:, None]
    return out.to(table.dtype)


def embedding_bags_plain(tables, ids: torch.Tensor, weights: torch.Tensor,
                         id_rule: str = "clip", *, dtype=None, head=None,
                         out=None, windows=None) -> torch.Tensor:
    """The grouped bag of :func:`~.kernel.embedding_bags` in plain
    PyTorch: table ``t``'s bags, :func:`embedding_bag_fixed_plain` of
    ``tables[t]``, ``ids[t]`` and ``weights[t]`` (rounded to the table's
    dtype), converted into slot ``t`` of a (B, T, D) result in ``dtype``
    (the tables' by default), or slot ``t + 1`` of a (B, T + 1, D) one
    whose slot 0 is ``head`` (B, D).  ``out`` takes the result in place
    of a new tensor; ``windows`` (one ``(first, V)`` a table, or None)
    makes each table a block of a whole one, as in
    :func:`embedding_bag_fixed_plain`.  Differentiable in the tables,
    weights and head by autograd."""
    lead = 0 if head is None else 1
    if out is None:
        out = torch.empty(
            (ids.shape[1], len(tables) + lead, tables[0].shape[1]),
            dtype=dtype or tables[0].dtype, device=ids.device)
    if head is not None:
        out[:, 0] = head
    for t, table in enumerate(tables):
        out[:, lead + t] = embedding_bag_fixed_plain(
            table, ids[t], weights[t], id_rule=id_rule,
            window=None if windows is None else windows[t])
    return out
