"""Gradient compression, the port of ``repro.distributed.compression``:

  * ``quantize_int8`` / ``dequantize_int8`` — per-tensor symmetric int8
    with an f32 scale (4x on-the-wire reduction),
  * ``compress_tree`` — quantize and dequantize every leaf of a gradient
    tree inside the train step (simulates the wire format end to end and
    exposes the quantization error to tests).

The reference's ``compressed_psum`` (the same quantization around a
collective) needs a process group and comes with the distributed slice.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_tree(grads: Any) -> Any:
    """Quantize and dequantize every leaf (wire-format simulation)."""

    def one(g):
        q, s = quantize_int8(g)
        return dequantize_int8(q, s, g.dtype)

    return tree_map(one, grads)
