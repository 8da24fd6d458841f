"""Gradient compression for cross-pod reduction, the port of
``repro.distributed.compression``:

  * ``quantize_int8`` / ``dequantize_int8`` — per-tensor symmetric int8
    with an f32 scale (4x on-the-wire reduction),
  * ``compressed_psum`` — an all-reduce over a process group that
    quantizes before and dequantizes after the collective,
  * ``compress_tree`` — quantize and dequantize every leaf of a gradient
    tree inside the train step (simulates the wire format end to end and
    exposes the quantization error to tests).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.leaf_kinds import reduce_over_shards
from repro_torch.distributed.tensor_parallel import ModelGroup
from repro_torch.tree import leaves, unflatten


def _scale(xf: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0


def quantize_int8(x: torch.Tensor, scale: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` as int8 and its scale: ``x``'s own, or ``scale`` where given
    (a shard quantized as the whole tensor it is part of)."""
    xf = x.float()
    if scale is None:
        scale = _scale(xf)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_tree(grads: Any, dims: Any = None,
                  mg: Optional[ModelGroup] = None) -> Any:
    """Quantize and dequantize every leaf (wire-format simulation), each
    with its own scale.  A leaf that ``dims`` keeps as this rank's
    ``model`` shard of ``mg``, or declares computed on as it lies
    (``leaf_kinds.Local``), takes the scale of its whole leaf, the
    largest over the axes that cut it
    (``leaf_kinds.reduce_over_shards``: one collective an axis), so
    its values are the whole leaf's."""
    flat = leaves(grads)
    scales = reduce_over_shards([_scale(g.float()) for g in flat], dims, mg,
                                op=dist.ReduceOp.MAX)
    out = []
    for g, s in zip(flat, scales):
        q, s = quantize_int8(g, s)
        out.append(dequantize_int8(q, s, g.dtype))
    return unflatten(grads, out)


def compressed_psum(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
                    ) -> torch.Tensor:
    """int8-compressed all-reduce over ``group`` (None: the default).

    Takes the local scale as ``quantize_int8`` does, all-reduces its MAX,
    re-quantizes against that common scale (int32, clipped to +-127) so
    the sum is well-defined, all-reduces the SUM and rescales to
    ``x.dtype`` — the classic compressed ring-reduce approximation."""
    xf = x.float()
    scale_max = _scale(xf)
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    total = torch.clamp(torch.round(xf / scale_max), -127, 127).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return (total.float() * scale_max).to(x.dtype)
