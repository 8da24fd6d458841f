"""A plain PyTorch decoder-only LM: the loss whose gradients the
benchmark's LM training cells are held to.

No kernels of the port, nothing cached.  The architecture is the one the
port trains: token embedding, per layer RMSNorm, grouped-query causal
attention with half-split rotary embeddings on q and k (scale 1/sqrt(head
size)), a residual add, RMSNorm and a SwiGLU MLP, another residual add; a
final RMSNorm, the tied unembedding and the mean next-token
cross-entropy over labels that are not -1.  Granite's embedding,
attention, residual and logit multipliers are not part of it; the
configuration files list them as changed.

Precision: f32 master weights, cast to the configuration's dtype ``dt``
where they are used; activations, products and residual sums held in
``dt``; norms and rotary embeddings computed in f32 and cast back;
attention's scores, softmax and weighted sum in f32 from ``dt`` q, k and
v; the cross-entropy in f32.  With ``dt`` float32 the whole model is f32
(TF32 off).

Each layer is recomputed in the backward pass (``checkpoint``), and
attention takes 512 queries at a time over the keys they may see, so
that 4,096-token sequences fit beside the state: memory, not values.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.precision import DTYPES, linear

QUERY_BLOCK = 512


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
            * g).to(x.dtype)


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """(B, S, heads, D) rotated by position, the two halves of D as the
    pairs, in f32."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    pos = torch.arange(S, dtype=torch.float32, device=x.device)
    ang = pos[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half].float(), x[..., half:].float()
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1).to(x.dtype)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """q (B, H, S, D), k and v (B, Hkv, S, D): query head h reads KV head
    h // (H / Hkv); (B, H, S, D) out in q's dtype, computed in f32."""
    H, S, D = q.shape[1], q.shape[2], q.shape[3]
    g = H // k.shape[1]
    qf = q.float()
    k = k.float().repeat_interleave(g, 1)
    v = v.float().repeat_interleave(g, 1)
    out = []
    for s0 in range(0, S, QUERY_BLOCK):
        s1 = min(s0 + QUERY_BLOCK, S)
        sc = qf[:, :, s0:s1] @ k[:, :, :s1].transpose(-1, -2) / math.sqrt(D)
        qi = torch.arange(s0, s1, device=q.device)[:, None]
        kj = torch.arange(s1, device=q.device)[None, :]
        sc = sc.masked_fill(kj > qi, float("-inf"))
        out.append(torch.softmax(sc, -1) @ v[:, :, :s1])
    return torch.cat(out, 2).to(q.dtype)


def _layer(cfg: dict, mm: str, x, ln1, ln2, wq, wk, wv, wo, wg, wu, wd):
    B, S, _ = x.shape
    H, Hkv, D = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    dt = x.dtype
    h = rms_norm(x, ln1, cfg["rms_eps"])
    q = rotary(linear(h, wq, dt, mm).view(B, S, H, D), cfg["rope_theta"])
    k = rotary(linear(h, wk, dt, mm).view(B, S, Hkv, D), cfg["rope_theta"])
    v = linear(h, wv, dt, mm).view(B, S, Hkv, D)
    o = causal_attention(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2)).transpose(1, 2)
    x = x + linear(o.reshape(B, S, H * D), wo, dt, mm)
    h = rms_norm(x, ln2, cfg["rms_eps"])
    return x + linear(F.silu(linear(h, wg, dt, mm)) * linear(h, wu, dt, mm),
                      wd, dt, mm)


LAYER_LEAVES = ("block/ln1", "block/ln2", "block/wq/w", "block/wk/w",
                "block/wv/w", "block/wo/w", "block/mlp/wg/w",
                "block/mlp/wu/w", "block/mlp/wd/w")


def loss(p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
         cfg: dict, mm: str = "none") -> torch.Tensor:
    """Mean cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` under the weights ``p`` (by leaf name), computed
    in ``cfg["dtype"]``; ``mm`` rounds the linear layers' operands
    further (a control)."""
    dt = DTYPES[cfg["dtype"]]
    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    x = p["embed/table"][tokens].to(dt)
    per_layer = [p[name].unbind(0) for name in LAYER_LEAVES]
    for layer in zip(*per_layer):
        x = checkpoint(_layer, cfg, mm, x, *layer, use_reentrant=False)
    h = rms_norm(x, p["ln_f"], cfg["rms_eps"])
    logits = linear(h, p["embed/table"].t(), dt, mm).float()
    return F.cross_entropy(logits.flatten(0, 1), labels.flatten(),
                           ignore_index=-1)
