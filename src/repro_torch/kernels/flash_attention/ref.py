"""The plain PyTorch version of flash attention: the function that
``repro.kernels.flash_attention.ref`` states, in the CUDA kernel's
arithmetic.  The wrapper in ``kernel.py`` takes it for CPU tensors; the
card's checks hold the kernel against it."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """f32 scores of (B, H, S, D) queries over (B, Hkv, S, D) keys scaled by
    ``1/sqrt(D)`` (head ``h`` reads KV head ``h // (H // Hkv)``), exact
    softmax, f32 ``p @ v``, cast to ``q.dtype``."""
    H, S, D = q.shape[1], q.shape[2], q.shape[3]
    group = H // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kf) * (1.0 / math.sqrt(D))
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, vf).to(q.dtype)
