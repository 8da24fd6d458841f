"""The plain PyTorch version of paged decode attention: the function that
``repro.kernels.paged_attention.ref`` states, gathering through the block
table as it does, in the CUDA kernel's arithmetic.  The wrapper in
``kernel.py`` takes it for CPU tensors; the card's checks hold the kernel
against it."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention_plain(
    q: torch.Tensor,            # (B, H, D) one query token per row
    k_pool: torch.Tensor,       # (n_pages, page, D) shared page pool
    v_pool: torch.Tensor,       # (n_pages, page, D)
    block_table: torch.Tensor,  # (B, max_pages) int32 page ids
    lengths: torch.Tensor,      # (B,) int32 valid tokens per row
) -> torch.Tensor:
    """Gather the table's pages, then f32 scores scaled by ``1/sqrt(D)``
    with positions ``>= lengths[b]`` masked, exact softmax, f32 ``p @ v``,
    cast to ``q.dtype``.  A row of length 0 reads nothing and yields
    zeros, as in both kernels (the jnp oracle averages the masked row
    instead)."""
    B, H, D = q.shape
    page = k_pool.shape[1]
    max_pages = block_table.shape[1]
    idx = block_table.long()
    k = k_pool[idx].reshape(B, max_pages * page, D).float()
    v = v_pool[idx].reshape(B, max_pages * page, D).float()
    s = torch.einsum("bhd,btd->bht", q.float(), k) * (1.0 / math.sqrt(D))
    pos = torch.arange(max_pages * page, device=q.device)
    s = s.masked_fill((pos[None, :] >= lengths.long()[:, None])[:, None],
                      NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bht,btd->bhd", p, v)
    return out.masked_fill((lengths <= 0)[:, None, None], 0.0).to(q.dtype)
