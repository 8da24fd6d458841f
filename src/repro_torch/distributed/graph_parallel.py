"""Graphs computed on their batch shards: the GNN family's route on a
mesh.

The reference places every input of a GNN cell on the batch axes, node
inputs and edge inputs alike, each degraded to the axes that divide its
rows (``sanitize_shardings``), and pins MACE's edge pipeline to the edge
shards and its node algebra to the node shards (``repro.models.mace``'s
``constrain`` calls).  The port computes on those shards with explicit
collectives:

  * :func:`graph_shards` reads where this rank's node block and edge
    block lie from the placements of a node input (``pos``) and an edge
    input (``edges_src``), as ``row_parallel.row_shard`` reads a table's.
    The two may be split over different axes, either may be whole, and
    either may be split over a prefix of the batch axes;
  * :func:`gather_nodes`: this rank's rows of node states, all-gathered
    over the node axes into the whole (N, ...) tensor in the global
    batch's order (the outermost axis major); its transpose is a
    reduce-scatter over them;
  * :func:`sum_to_owners`: a whole (N, ...) partial sum (the messages of
    this rank's edge block, added into the rows of the nodes they reach)
    summed over the axes that split the edges, this rank's node rows
    kept: over an axis that splits both a reduce-scatter, over one that
    splits the edges alone an all-reduce, over one that splits the nodes
    alone a slice (its ranks hold the same edges: nothing is summed).
    Its transpose is, axis by axis, an all-gather, an all-reduce and a
    zero padding;
  * :func:`sum_over_nodes`: a partial over this rank's node rows summed
    over the node axes (an all-reduce; its transpose is one too).

The transposes keep the step's convention (``hooks``): a rank's
gradient is its share, and the shares sum over the batch axes.  A value
that an axis replicates holds a share on each of its ranks, which
nothing sums until the step does.

Every collective of the route is issued even on an axis of one rank, as
``tensor_parallel``'s and ``row_parallel``'s are, so the route and its
count (:data:`GRAPH_COLLECTIVES`) are the same on one card as on many.
On an axis of one rank a gather or a reduce-scatter runs in place, on
the tensor itself, so the route allocates no more than a step without a
mesh.  None is issued inside a loop over edge or node blocks, whose
count can differ from rank to rank.  The process groups are taken where
the loss starts (:class:`GraphShards`): a recomputed layer's backward
runs on autograd's own thread, where no mesh context is set.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from repro_torch.distributed.hooks import local
from repro_torch.distributed.row_parallel import RowShard, row_shard
from repro_torch.distributed.sharding import axis_sizes, is_sharded
from repro_torch.distributed.tensor_parallel import CollectiveCount

# the collectives the route issues (forward, recompute and backward); a
# test or the smoke run zeroes it, runs a step and reads it
GRAPH_COLLECTIVES = CollectiveCount()

# the inputs laid out as the edges; every other input with the nodes'
# row count is laid out as the nodes
EDGE_INPUTS = ("edges_src", "edges_dst", "edge_mask")
NODE_INPUTS = ("feat", "species", "pos", "labels", "label_mask", "graph_of")

_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)


@dataclasses.dataclass(frozen=True)
class GraphAxis:
    """A mesh axis that splits the nodes, the edges or both: its process
    group, its count of ranks and this rank's index along it."""
    name: str
    group: Any
    size: int
    rank: int
    nodes: bool
    edges: bool


def _split_axes(x: Any) -> Tuple[str, ...]:
    """The mesh axes that split dim 0 of ``x``, in mesh order (none for
    a plain tensor)."""
    if not is_sharded(x):
        return ()
    names = list(axis_sizes(x.device_mesh))
    return tuple(names[i] for i, pl in enumerate(x.placements)
                 if isinstance(pl, Shard) and pl.dim == 0)


@dataclasses.dataclass(frozen=True)
class GraphShards:
    """This rank's node block (``nodes``: rows ``[first, first + n)`` of
    the graph's nodes) and edge block (``edges``), and the axes that
    split either, in mesh order.  Its methods are the route's
    collectives without autograd (a layer's ``autograd.Function`` calls
    them in its forward and backward); each may reuse the memory of the
    tensor it is given."""
    nodes: RowShard
    edges: RowShard
    axes: Tuple[GraphAxis, ...]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, this rank's node rows, all-gathered over the node axes
        into the whole graph's rows (the innermost axis first)."""
        for a in reversed(self.axes):
            if a.nodes:
                x = _gather_axis(x, a)
        return x

    def gather_t(self, g: torch.Tensor) -> torch.Tensor:
        """The transpose of :meth:`gather`: ``g``, whole, summed over the
        node axes (the outermost first), this rank's rows kept."""
        for a in self.axes:
            if a.nodes:
                g = _scatter_axis(g, a)
        return g

    def to_owners(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, a whole partial sum over this rank's edge block, summed
        over the edge axes into this rank's node rows (the outermost
        axis first)."""
        for a in self.axes:
            if a.nodes and a.edges:
                x = _scatter_axis(x, a)
            elif a.edges:
                x = x.contiguous()
                GRAPH_COLLECTIVES.count += 1
                dist.all_reduce(x, group=a.group)
            else:
                n = x.shape[0] // a.size
                x = x[a.rank * n:(a.rank + 1) * n]
        return x

    def to_owners_t(self, g: torch.Tensor) -> torch.Tensor:
        """The transpose of :meth:`to_owners`: ``g``, this rank's node
        rows, back to a whole partial (the innermost axis first)."""
        for a in reversed(self.axes):
            if a.nodes and a.edges:
                g = _gather_axis(g, a)
            elif a.edges:
                g = g.contiguous()
                GRAPH_COLLECTIVES.count += 1
                dist.all_reduce(g, group=a.group)
            elif a.size > 1:
                n = g.shape[0]
                whole = g.new_zeros((a.size * n,) + tuple(g.shape[1:]))
                whole[a.rank * n:(a.rank + 1) * n] = g
                g = whole
        return g


def _gather_axis(x: torch.Tensor, a: GraphAxis) -> torch.Tensor:
    """``x`` of every rank along ``a``, along dim 0 in rank order; on an
    axis of one rank in place (through ``.data``, which writes the same
    values without a mark on autograd's version counter)."""
    x = x.contiguous()
    out = (x.data if a.size == 1 else
           x.new_empty((a.size * x.shape[0],) + tuple(x.shape[1:])))
    GRAPH_COLLECTIVES.count += 1
    _all_gather(out, x, group=a.group)
    return out


def _scatter_axis(x: torch.Tensor, a: GraphAxis) -> torch.Tensor:
    """``x`` summed over ``a``, this rank's block of dim 0 kept; on an
    axis of one rank in place, as :func:`_gather_axis`."""
    x = x.contiguous()
    out = (x.data if a.size == 1 else
           x.new_empty((x.shape[0] // a.size,) + tuple(x.shape[1:])))
    GRAPH_COLLECTIVES.count += 1
    _reduce_scatter(out, x, group=a.group)
    return out


def graph_shards(batch: Dict[str, Any]) -> Optional[GraphShards]:
    """Where this rank's node and edge blocks lie, from the placements of
    ``batch["pos"]`` and ``batch["edges_src"]``; None where the batch
    holds no DTensors (no mesh)."""
    pos, src = batch["pos"], batch["edges_src"]
    if not is_sharded(pos) and not is_sharded(src):
        return None
    if not (is_sharded(pos) and is_sharded(src)):
        raise ValueError("a graph's positions and edges are placed on a "
                         "mesh together or not at all")
    mesh = pos.device_mesh
    nodes = row_shard(mesh, _split_axes(pos), pos.shape[0])
    edges = row_shard(mesh, _split_axes(src), src.shape[0])
    coord = mesh.get_coordinate()
    axes = tuple(
        GraphAxis(n, mesh.get_group(n), mesh.size(i), coord[i],
                  n in nodes.axes, n in edges.axes)
        for i, n in enumerate(axis_sizes(mesh))
        if n in nodes.axes or n in edges.axes)
    return GraphShards(nodes, edges, axes)


def local_inputs(batch: Dict[str, Any], shards: Optional[GraphShards]
                 ) -> Dict[str, Any]:
    """This rank's block of each input (the batch itself without
    ``shards``): edge inputs must be split as ``edges_src`` is, node
    inputs as ``pos`` is."""
    if shards is None:
        return batch
    out = {}
    for k, v in batch.items():
        want = (shards.edges if k in EDGE_INPUTS
                else shards.nodes if k in NODE_INPUTS else None)
        if want is not None and _split_axes(v) != want.axes:
            raise ValueError(f"graph input {k!r} is split over "
                             f"{_split_axes(v)}, the "
                             f"{'edges' if k in EDGE_INPUTS else 'nodes'} "
                             f"over {want.axes}")
        out[k] = local(v)
    return out


# -------------------------------------------- differentiable collectives --
class _GatherNodes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, shards):
        ctx.shards = shards
        return shards.gather(h.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.shards.gather_t(g.clone()), None


class _SumToOwners(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shards):
        ctx.shards = shards
        return shards.to_owners(x.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.shards.to_owners_t(g.clone()), None


class _SumOverNodes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _all_reduce(x.detach().clone(), groups)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.groups), None


def _all_reduce(x: torch.Tensor, groups) -> torch.Tensor:
    for g in groups:
        GRAPH_COLLECTIVES.count += 1
        dist.all_reduce(x, group=g)
    return x


def gather_nodes(h_own: torch.Tensor, shards: Optional[GraphShards]
                 ) -> torch.Tensor:
    """The whole graph's rows of node states from this rank's rows
    ``h_own``, differentiably (``h_own`` itself without ``shards``).
    Every rank of the mesh calls it, in the same order."""
    return h_own if shards is None else _GatherNodes.apply(h_own, shards)


def sum_to_owners(part: torch.Tensor, shards: Optional[GraphShards]
                  ) -> torch.Tensor:
    """This rank's node rows of the sum of every edge block's whole
    partial ``part``, differentiably (``part`` itself without
    ``shards``).  Every rank of the mesh calls it, in the same order."""
    return part if shards is None else _SumToOwners.apply(part, shards)


def sum_over_nodes(part: torch.Tensor, shards: Optional[GraphShards]
                   ) -> torch.Tensor:
    """``part``, a sum over this rank's node rows, summed over the node
    axes, differentiably (``part`` itself without ``shards``): a
    molecule's energy from the nodes of every rank that holds some of
    them.  Every rank of the mesh calls it, in the same order."""
    if shards is None:
        return part
    return _SumOverNodes.apply(
        part, tuple(a.group for a in shards.axes if a.nodes))
