"""The plain PyTorch version of the fixed-size EmbeddingBag: the function
that ``repro.kernels.embedding_bag`` computes (an f32 sum of weighted
rows, cast to the table's dtype), in the CUDA kernel's arithmetic.  The
wrapper in ``kernel.py`` takes it for CPU tensors; the card's checks
hold the kernel against it."""

from __future__ import annotations

import torch


def embedding_bag_fixed_plain(
    table: torch.Tensor,    # (V, D)
    ids: torch.Tensor,      # (B, K)
    weights: torch.Tensor,  # (B, K)
    mode: str = "sum",
) -> torch.Tensor:
    """``out[b] = sum_k w[b, k] * table[ids[b, k]]`` in f32, cast to
    ``table.dtype``.  ``mode="mean"`` divides the f32 sum by
    ``max(sum_k w[b, k], 1e-9)`` first, the oracle of
    ``repro.kernels.embedding_bag.ref``; the kernel computes ``sum``."""
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    out = (table[ids.long()].float() * weights[..., None].float()).sum(1)
    if mode == "mean":
        out = out / weights.float().sum(1).clamp(min=1e-9)[:, None]
    return out.to(table.dtype)
