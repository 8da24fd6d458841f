"""Minimal functional NN substrate, the port of ``repro.nn.layers``.

Parameters are nested dicts of tensors; initialisers draw from an explicit
``torch.Generator`` (JAX's PRNG keys have no counterpart: the same seed
gives other numbers, so tests hand both packages the same numpy weights).
Norms and rotary embeddings compute in f32 and cast back, as the
reference does; ``dense`` and ``mlp_apply`` take their products in the
compute dtype; ``softmax_xent`` is the masked f32 cross-entropy of the
losses.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

Params = Dict[str, Any]
NORM_KEYS = ("ln1", "ln2", "ln_f")   # norm gains: held in f32


def cast_params(tree, dtype: torch.dtype, device=None, key: str = ""):
    """Every leaf of a parameter tree (nested dicts and lists of tensors
    or arrays) as a tensor of ``dtype`` on ``device`` (None: where it
    is); norm gains (``NORM_KEYS``) in f32."""
    if isinstance(tree, Mapping):
        return {k: cast_params(v, dtype, device, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_params(v, dtype, device, key) for v in tree]
    if not isinstance(tree, torch.Tensor):
        tree = torch.from_numpy(np.array(tree, dtype=np.float32))
    return tree.to(device=device,
                   dtype=torch.float32 if key in NORM_KEYS else dtype)


# ----------------------------------------------------------------- inits ----
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               bias: bool = False, scale: Optional[float] = None) -> Params:
    """``w`` (d_in, d_out) ~ N(0, scale^2), scale 1/sqrt(d_in) by default;
    ``b`` zeros.  f32, on the generator's device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": torch.randn((d_in, d_out), generator=gen, device=gen.device,
                          dtype=torch.float32) * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=gen.device)
    return p


def embedding_init(gen: torch.Generator, vocab: int, dim: int,
                   scale: float = 0.02) -> Params:
    return {"table": torch.randn((vocab, dim), generator=gen,
                                 device=gen.device,
                                 dtype=torch.float32) * scale}


def mlp_init(gen: torch.Generator, dims: Sequence[int],
             bias: bool = True) -> Params:
    """``fc0 .. fc{n-2}``: one ``dense_init`` per pair of widths."""
    return {
        f"fc{i}": dense_init(gen, dims[i], dims[i + 1], bias=bias)
        for i in range(len(dims) - 1)
    }


# ---------------------------------------------------------------- applies ----
def dense(p: Params, x: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x @ w (+ b)`` with x, w and b cast to ``dtype`` and the product
    and the bias add taken in ``dtype``, as the reference's einsum does."""
    y = x.to(dtype) @ p["w"].to(dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def mlp_apply(p: Params, x: torch.Tensor,
              act: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
              dtype: torch.dtype = torch.bfloat16,
              final_act: bool = False,
              layer: Callable[..., torch.Tensor] = dense) -> torch.Tensor:
    """``layer`` (``dense``, or a split of it that gives the same values)
    in order, ``act`` between them and, with ``final_act``, after the
    last one."""
    n = len(p)
    for i in range(n):
        x = layer(p[f"fc{i}"], x, dtype=dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def rms_norm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf * scale) * g.float()).to(x.dtype)


def rope_tables(positions: torch.Tensor, d: int, theta: float = 10000.0):
    """(cos, sin) of the rotary angles, each (..., S, 1, d // 2) in f32:
    computed once per forward and shared by every layer's q and k."""
    half = d // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=positions.device)
        / half
    )
    angles = positions[..., :, None].float() * freqs  # (..., S, half)
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of x (..., S, n_heads, d_head) in f32, cast back."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, n_heads, d_head); positions: (..., S)."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross-entropy in f32; labels == ignore_id are masked."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    nll = logz - gold
    mask = (labels != ignore_id).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
