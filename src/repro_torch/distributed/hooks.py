"""Activation sharding constraints and the data-parallel hooks of the
losses, the port of ``repro.distributed.hooks``.

The active mesh is a context (:func:`use_mesh`), the counterpart of the
reference's ``with mesh:``; the trainer enters it for a step on a mesh
and ``launch.train`` for ``fit``.  Model code calls
``constrain(x, "batch", None, "model", ...)`` with logical entries; the
hook resolves them against the active mesh as the reference does:

  * "batch" -> the tuple of batch axes present (("pod","data") / ("data",))
  * an axis name -> itself if the mesh has it, else replicated
  * None -> replicated

Outside any mesh the hook is a no-op, so the same model code runs
everywhere.  Inside one it redistributes a DTensor to the resolved spec
and returns a local tensor unchanged.  No path hands it a DTensor: a
step on a mesh gathers each weight over the batch axes, the losses take
their rows as local tensors, and the LM computes on its ``model``
shards with the explicit collectives of
:mod:`repro_torch.distributed.tensor_parallel`, whose plan places heads,
experts and vocabulary rows where these calls' specs place them.  So
every call is a no-op on the local tensors it is given; the calls stand
at the reference's sites, as its record of where each activation lies.

A step on a mesh hands a loss its batch as DTensors sharded over the
batch axes.  A loss takes its rows with :func:`local` (a graph's node
rows and edge block through ``graph_parallel``, where rows are not
independent) and ends in :func:`batch_mean`, which makes the value this
rank's share of the mean over the global batch: the shares sum to it,
and so do their gradients, whatever each rank's count of valid terms.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (
    BATCH,
    P,
    PartitionSpec,
    axis_sizes,
    local_shard,
    placements,
)
from repro_torch.tree import tree_map

BATCH_AXES = BATCH

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("active_mesh",
                                                         default=None)


@contextlib.contextmanager
def use_mesh(mesh: Any) -> Iterator[Any]:
    """Make ``mesh`` the active mesh inside the block (in this thread or
    task only, as JAX's mesh context is)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Optional[Any]:
    return _ACTIVE.get()


def resolve_entries(names: Tuple[str, ...], entries) -> PartitionSpec:
    """The spec that ``constrain`` gives ``entries`` on a mesh with axes
    ``names``."""
    spec = []
    for e in entries:
        if e == "batch":
            batch = tuple(n for n in BATCH_AXES if n in names)
            spec.append(
                None if not batch else (batch[0] if len(batch) == 1 else batch)
            )
        elif e is None:
            spec.append(None)
        elif isinstance(e, str) and e in names:
            spec.append(e)
        else:
            spec.append(None)
    return P(*spec)


def constrain(x, *entries):
    """``x`` laid out as ``entries`` say on the active mesh: a DTensor is
    redistributed; a local tensor, which is what model code computes on
    (already this rank's shard where the spec names ``model``), is
    returned as it is."""
    mesh = active_mesh()
    if mesh is None:
        return x
    spec = resolve_entries(tuple(axis_sizes(mesh)), entries)
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))
    return x


# ------------------------------------------------------- data parallelism ---
def local(x: Any) -> Any:
    """This rank's block of a DTensor; anything else as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def local_batch(batch: Any) -> Any:
    return tree_map(local, batch)


def rows_like(y: torch.Tensor, like: Any) -> torch.Tensor:
    """This rank's block of ``y``, a whole tensor whose leading dims are
    those of ``like`` (a batch input, or a param for its gradient), cut
    as ``like`` is (``y`` itself where ``like`` is no DTensor)."""
    if not isinstance(like, DTensor):
        return y
    return local_shard(y, like.device_mesh, like.placements)


def _batch_groups(skip: Tuple[str, ...] = ()) -> List[Any]:
    """The process groups of the active mesh's batch axes of more than
    one rank, but those named in ``skip``."""
    mesh = active_mesh()
    if mesh is None:
        return []
    sizes = axis_sizes(mesh)
    return [mesh.get_group(n) for n in BATCH_AXES
            if n in sizes and sizes[n] > 1 and n not in skip]


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active mesh's batch axes (a new tensor; no
    gradient flows through the sum), or ``x`` itself where they have one
    rank."""
    if not _batch_groups():
        return x
    return batch_sum_(x.detach().clone())


def batch_sum_(x: torch.Tensor, skip: Tuple[str, ...] = ()) -> torch.Tensor:
    """``x`` summed in place over the active mesh's batch axes, but those
    named in ``skip`` (the axes that shard a leaf computed on as it
    lies: their ranks hold other blocks of it)."""
    for g in _batch_groups(skip):
        dist.all_reduce(x, group=g)
    return x


def batch_ranks() -> int:
    """The count of ranks that the active mesh's batch axes split a batch
    over (1 outside a mesh)."""
    n = 1
    for g in _batch_groups():
        n *= dist.get_world_size(g)
    return n


class _BatchSum(torch.autograd.Function):
    """A sum over the batch axes' groups (taken at the forward) whose
    gradient is the sum of every rank's gradient, as a ``psum``'s."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        x = x.clone()
        for g in groups:
            dist.all_reduce(x, group=g)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        for g in ctx.groups:
            dist.all_reduce(grad, group=g)
        return grad, None


@dataclasses.dataclass(frozen=True)
class BatchAxes:
    """The active mesh's batch axes of more than one rank, taken where a
    forward starts (a recomputed block runs again in the backward pass,
    which on the card runs on autograd's own thread, where the mesh
    context is not set): their process groups, the outermost first, this
    rank's index along them and their count of ranks."""
    groups: Tuple[Any, ...]
    rank: int
    size: int


def batch_axes() -> Optional[BatchAxes]:
    """The active mesh's :class:`BatchAxes`; None outside a mesh or where
    its batch axes have one rank.  This rank's index counts their ranks
    in mesh order, the first outermost: the order of the global batch's
    row blocks."""
    groups = _batch_groups()
    if not groups:
        return None
    mesh = active_mesh()
    sizes = axis_sizes(mesh)
    coord = mesh.get_coordinate()
    r = 0
    for i, n in enumerate(sizes):
        if n in BATCH_AXES:
            r = r * sizes[n] + coord[i]
    return BatchAxes(tuple(groups), r, batch_ranks())


class _BatchGather(torch.autograd.Function):
    """Every batch rank's ``x`` along dim 0 in global-batch order; the
    gradient of this rank's block is the sum of every rank's gradient
    of it."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        for g in reversed(groups):     # the innermost axis first
            parts = [torch.empty_like(x)
                     for _ in range(dist.get_world_size(g))]
            dist.all_gather(parts, x.contiguous(), group=g)
            x = torch.cat(parts, 0)
        return x

    @staticmethod
    def backward(ctx, grad):
        for g in ctx.groups:           # the outermost axis first
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, group=g)
            n = grad.shape[0] // dist.get_world_size(g)
            r = dist.get_rank(g)
            grad = grad[r * n:(r + 1) * n]
        return grad, None


def batch_gather(x: torch.Tensor, axes: Optional[BatchAxes]
                 ) -> torch.Tensor:
    """The rows of ``x`` of every rank along the batch ``axes``, in the
    global batch's order, differentiably (``x`` itself where ``axes`` is
    None).  Every rank must call it, in the same order."""
    if axes is None:
        return x
    return _BatchGather.apply(x, list(axes.groups))


def batch_pmean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the active mesh's batch axes, through which
    the gradient flows back to every rank's ``x`` (``x`` itself where
    they have one rank).  Every rank must call it, in the same order."""
    groups = _batch_groups()
    if not groups:
        return x
    return _BatchSum.apply(x, groups) / batch_ranks()


def batch_mean(total: torch.Tensor, count) -> torch.Tensor:
    """``total / max(count, 1)``: a mean over the batch.  On a mesh
    whose batch axes split the batch, ``total`` and ``count`` are this
    rank's and the count is summed over those axes first, so what
    returns is this rank's share of the global mean (a rank that holds a
    replicated batch counts it once for each rank, and its share is a
    fraction of the whole)."""
    count = torch.as_tensor(count, device=total.device)
    return total / torch.clamp(batch_sum(count), min=1)
