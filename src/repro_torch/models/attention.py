"""Attention of the LM serving path, the port of ``repro.models.attention``.

  * ``mha``               — full materialized scores, plain PyTorch (kept
                            as the reference's small-S oracle; not on the
                            serving path)
  * ``attention``         — prefill and training: causal attention
                            through the flash kernel under its
                            ``autograd.Function``
                            (``kernels.flash_attention``)
  * ``decode_attention``  — one query token against a (B, S_max, n_kv, D)
                            slot cache with a valid-length mask, through
                            the paged kernel (``kernels.paged_attention``)
  * ``slot_decode_attention`` — the same on the head-major (B, n_kv, S_max,
                            D) cache that the port's transformer keeps,
                            with no copy of the cache (on a block of its
                            sequence too, with the log-sum-exp that
                            merges the blocks' outputs)

The reference dispatched between ``mha`` and a chunked ``flash_ref`` at
S = 4096; both computed the same function, and so does the flash kernel
at every S, so ``flash_ref`` and the threshold are gone.  GQA is handled
by grouping query heads over KV heads: head ``h`` reads KV head
``h // G`` with ``G = H // n_kv``.

How decode reaches the paged kernel: the kernel's pool has no head axis,
so a head-major cache (B, n_kv, S_max, D) is viewed as a pool of
(B * n_kv * S_max / page, page, D) pages, row ``b * n_kv + n`` of a fixed
slot block table holds the pages of slot ``b`` and KV head ``n``, and the
G query heads of that KV head are the row's heads.  One kernel call covers
a layer.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.distributed.hooks import constrain
from repro_torch.kernels.flash_attention.ops import (
    flash_attention_differentiable,
)
from repro_torch.kernels.paged_attention.ops import paged_attention

NEG_INF = -1e30


def expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, n_kv, D) -> (B, S, H, D): GQA expansion to one flat head
    dimension (query head ``h`` sees KV head ``h // G``)."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=2)


def mha(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, n_kv, D)
    v: torch.Tensor,  # (B, Sk, n_kv, D)
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    B, Sq, H, D = q.shape
    k = constrain(expand_kv(k, H), "batch", None, "model", None)
    v = constrain(expand_kv(v, H), "batch", None, "model", None)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(D)
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        scores = scores.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", w, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """(B, S, H, D) queries over (B, S, n_kv, D) keys and values through
    the flash kernel; (B, S, H, D) out, differentiable (the kernel's
    ``autograd.Function``, whose backward is the hand kernel of
    ``csrc/flash_attention_bwd.cu`` on the card).  The kernel
    reads the (B, H, S, D) views through their strides, so nothing is
    transposed in memory on the way in.  K and V are constrained as the
    reference's flash path constrains them, unexpanded: the kernel groups
    query heads over KV heads."""
    k = constrain(k, "batch", None, "model", None)
    v = constrain(v, "batch", None, "model", None)
    out = flash_attention_differentiable(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal)
    return out.transpose(1, 2)


def slot_page(s_max: int, page_size: int) -> int:
    """The page of the slot pool view: ``page_size`` when it divides
    ``s_max``, else their greatest common divisor."""
    return math.gcd(int(s_max), int(page_size))


def slot_block_table(batch: int, n_kv: int, s_max: int, page: int,
                     device) -> torch.Tensor:
    """(batch * n_kv, s_max // page) int32: row ``b * n_kv + n`` lists the
    pages of slot ``b``, KV head ``n`` in the head-major pool view."""
    per_row = s_max // page
    return torch.arange(batch * n_kv * per_row, dtype=torch.int32,
                        device=device).reshape(batch * n_kv, per_row)


def slot_decode_attention(
    q: torch.Tensor,        # (B, 1, H, D) new-token queries
    k_cache: torch.Tensor,  # (B, n_kv, S_max, D) head-major, contiguous
    v_cache: torch.Tensor,  # (B, n_kv, S_max, D)
    lengths: torch.Tensor,  # (B,) valid cache lengths (including new token)
    page: int,
    table: Optional[torch.Tensor] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Decode attention on a head-major slot cache: one paged-kernel call
    over the cache's pool view.  ``table`` is
    :func:`slot_block_table` for these shapes (built when omitted).  The
    cache may be a block of each row's sequence (``S_max`` is then the
    block's length, ``page`` and ``table`` made for it, and ``lengths``
    the tokens of each row within it); ``return_lse`` adds the (B, H) f32
    log-sum-exp of each row and head's scores over those tokens
    (``kernels.paged_attention``), by which the blocks' outputs merge."""
    B, _, H, D = q.shape
    _, n_kv, s_max, _ = k_cache.shape
    if s_max % page:
        raise ValueError(f"page {page} does not divide S_max {s_max}")
    if table is None:
        table = slot_block_table(B, n_kv, s_max, page, q.device)
    n_pages = B * n_kv * s_max // page
    out = paged_attention(
        q.reshape(B * n_kv, H // n_kv, D).contiguous(),
        k_cache.view(n_pages, page, D),
        v_cache.view(n_pages, page, D),
        table,
        lengths.to(torch.int32).repeat_interleave(n_kv),
        return_lse=return_lse,
    )
    if return_lse:
        out, lse = out
        return out.reshape(B, 1, H, D), lse.reshape(B, H)
    return out.reshape(B, 1, H, D)


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, D) new-token queries
    k_cache: torch.Tensor,  # (B, S_max, n_kv, D) (RoPE already applied)
    v_cache: torch.Tensor,  # (B, S_max, n_kv, D)
    lengths: torch.Tensor,  # (B,) valid cache lengths (including new token)
) -> torch.Tensor:
    """The reference's contract and layout: the cache is copied head-major
    once and served by :func:`slot_decode_attention` in pages of
    ``slot_page(S_max, 16)`` tokens.  The transformer keeps its cache
    head-major and calls that function directly."""
    s_max = k_cache.shape[1]
    return slot_decode_attention(
        q,
        k_cache.permute(0, 2, 1, 3).contiguous(),
        v_cache.permute(0, 2, 1, 3).contiguous(),
        lengths,
        slot_page(s_max, 16),
    )
