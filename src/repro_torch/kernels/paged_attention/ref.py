"""The plain PyTorch version of paged decode attention: the function that
``repro.kernels.paged_attention.ref`` states, gathering through the block
table as it does, in the CUDA kernel's arithmetic.  The wrapper in
``kernel.py`` takes it for CPU tensors; the card's checks hold the kernel
against it."""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

NEG_INF = -1e30
# the log-sum-exp of a row of length 0 (``csrc/paged_attention.cu``'s
# kLseEmpty): finite, so a merge of partial outputs weighs it
# exp(LSE_EMPTY - max) = 0 beside any row that holds a token
LSE_EMPTY = -1e30


def paged_attention_plain(
    q: torch.Tensor,            # (B, H, D) one query token per row
    k_pool: torch.Tensor,       # (n_pages, page, D) shared page pool
    v_pool: torch.Tensor,       # (n_pages, page, D)
    block_table: torch.Tensor,  # (B, max_pages) int32 page ids
    lengths: torch.Tensor,      # (B,) int32 valid tokens per row
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Gather the table's pages, then f32 scores scaled by ``1/sqrt(D)``
    with positions ``>= lengths[b]`` masked, exact softmax, f32 ``p @ v``,
    cast to ``q.dtype``.  A row of length 0 reads nothing and yields
    zeros, as in both kernels (the jnp oracle averages the masked row
    instead).  With ``return_lse`` also the (B, H) f32 ``logsumexp`` of
    the masked scores, :data:`LSE_EMPTY` for a row of length 0."""
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
    empty = (lengths <= 0)[:, None]
    out = out.masked_fill(empty[..., None], 0.0).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(s, dim=-1).masked_fill(empty, LSE_EMPTY)
