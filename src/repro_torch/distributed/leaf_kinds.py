"""The kinds of leaf a loss may declare to a train step on a mesh, beside
"gathered whole" (None) and "this rank's ``model`` shard along dim d"
(an int, ``tensor_parallel``): :data:`LOCAL`, a leaf computed on as it
lies, this rank's block over every axis that shards it (a recsys table
looked up where its rows lie, ``row_parallel``).

The step (``train.trainer``) fills a declared :data:`LOCAL` in from the
leaf (:func:`local_of`); the global gradient norm
(``train.optim.global_norm``) and the int8 scales
(``distributed.compression.compress_tree``) reduce each leaf's value
over the axes that cut it (:func:`reduce_over_shards`), so each is its
whole leaf's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.distributed.sharding import axis_sizes
from repro_torch.distributed.tensor_parallel import MODEL, ModelGroup, all_reduce
from repro_torch.tree import leaves


@dataclasses.dataclass(frozen=True)
class Local:
    """A leaf computed on as it lies: not gathered, its gradient this
    rank's block's.  ``axes`` are the mesh axes that shard it, in mesh
    order, and ``groups`` their process groups; a loss declares
    :data:`LOCAL`, which the step fills in from the leaf
    (:func:`local_of`)."""
    axes: Tuple[str, ...] = ()
    groups: Tuple[Any, ...] = ()


LOCAL = Local()


def local_of(p: Any) -> Local:
    """The :class:`Local` of a leaf: the mesh axes whose placement shards
    it (none for a tensor that is no DTensor)."""
    if not isinstance(p, DTensor):
        return Local()
    mesh = p.device_mesh
    names = list(axis_sizes(mesh))
    axes = tuple(names[i] for i, pl in enumerate(p.placements)
                 if isinstance(pl, Shard))
    return Local(axes, tuple(mesh.get_group(a) for a in axes))


def reduce_over_shards(values: List[torch.Tensor], dims: Any,
                       mg: Optional[ModelGroup], op=dist.ReduceOp.SUM
                       ) -> List[torch.Tensor]:
    """Each leaf's 0-d ``values[i]`` reduced by ``op`` over the axes that
    cut the leaf, so that it is its whole leaf's: a ``model`` shard's
    (an int in ``dims``) over ``model``, a :class:`Local` leaf's over its
    axes.  One collective an axis, for all the leaves it cuts, in the
    order the axes are first met (the same on every rank); ``values``
    as they are where ``dims`` is None."""
    if dims is None:
        return values
    by_axis: Dict[str, Tuple[Any, List[int]]] = {}
    for i, d in enumerate(leaves(dims)):
        if isinstance(d, Local):
            for a, g in zip(d.axes, d.groups):
                by_axis.setdefault(a, (g, []))[1].append(i)
        elif d is not None and mg is not None:
            by_axis.setdefault(MODEL, (mg.group, []))[1].append(i)
    out = list(values)
    for axis, (group, idx) in by_axis.items():
        both = torch.stack([out[i] for i in idx])
        if axis == MODEL:
            all_reduce(both, mg, op=op)
        else:
            dist.all_reduce(both, op=op, group=group)
        for i, v in zip(idx, both.unbind(0)):
            out[i] = v
    return out
