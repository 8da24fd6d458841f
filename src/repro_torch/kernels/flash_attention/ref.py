"""The plain PyTorch version of flash attention: the function that
``repro.kernels.flash_attention.ref`` states, in the CUDA kernel's
arithmetic, and of its gradient.  The wrapper in ``kernel.py`` takes
them for CPU tensors; the card's checks hold the forward kernels and the
backward kernel (``csrc/flash_attention_bwd.cu``) against them.  The
reference differentiates its jnp attention with ``jax.grad`` and has no
backward kernel: :func:`flash_attention_backward_plain` is the gradient
that the port's attention ``autograd.Function`` takes on the CPU."""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, return_lse: bool = False):
    """f32 scores of (B, H, S, D) queries over (B, Hkv, S, D) keys scaled by
    ``1/sqrt(D)`` (head ``h`` reads KV head ``h // (H // Hkv)``), exact
    softmax, f32 ``p @ v``, cast to ``q.dtype``.  With ``return_lse`` also
    each row's log-sum-exp of its scaled, masked scores in base 2, f32
    (B, H, S), as the kernels write it for the backward."""
    H, S, D = q.shape[1], q.shape[2], q.shape[3]
    group = H // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kf) * (1.0 / math.sqrt(D))
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p, vf).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1) * LOG2E
    return out


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, grad_out: torch.Tensor,
                                   causal: bool = True, rows: int = 512,
                                   out: Optional[torch.Tensor] = None):
    """The gradient of :func:`flash_attention_plain`: ``(dq, dk, dv)`` in
    the operands' dtypes, from the saved operands (and the saved output
    ``out``, where given).

    P is recomputed in f32 (the forward's scores, mask and exact
    softmax); then ``dv = P^T dO``, ``dS = P * (dO V^T - delta)``, ``dq =
    dS K / sqrt(D)`` and ``dk = dS^T q / sqrt(D)``, all in f32 and cast
    once; a KV head's ``dk`` and ``dv`` sum over the query heads of its
    group.  ``delta = rowsum(dO * O)`` takes O from ``out`` when it is
    given, as the backward kernel does (its row pass reads the saved
    output), else recomputes O = P V in f32; in f32 the two agree.  The
    query rows go ``rows`` at a time, so no (S, S) tensor of a whole head
    is held: causal chunks read only the keys up to their last row.  The
    (rows, S) passes run in place where they can: the backward's time is
    those passes."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, G, S, D)
    dof = grad_out.float().reshape(B, Hkv, G, S, D)
    of = None if out is None else out.float().reshape(B, Hkv, G, S, D)
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    pos = torch.arange(S, device=q.device)
    for i0 in range(0, S, rows):
        i1 = min(S, i0 + rows)
        t1 = i1 if causal else S
        qi, doi = qf[:, :, :, i0:i1], dof[:, :, :, i0:i1]
        kj, vj = kf[:, :, :t1], vf[:, :, :t1]
        s = torch.einsum("bngsd,bntd->bngst", qi, kj).mul_(scale)
        if causal:
            s.masked_fill_(pos[None, :t1] > pos[i0:i1, None], NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        oi = (torch.einsum("bngst,bntd->bngsd", p, vj) if of is None
              else of[:, :, :, i0:i1])
        delta = (doi * oi).sum(-1, keepdim=True)
        dv[:, :, :t1] += torch.einsum("bngst,bngsd->bntd", p, doi)
        ds = torch.einsum("bngsd,bntd->bngst", doi, vj).sub_(delta).mul_(p)
        del p
        dq[:, :, :, i0:i1] = torch.einsum("bngst,bntd->bngsd", ds, kj) * scale
        dk[:, :, :t1] += torch.einsum("bngst,bngsd->bntd", ds, qi) * scale
    return (dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
