"""Tables computed on where their rows lie: the row-sharded lookup of the
recsys family on a mesh.

``RECSYS_RULES`` shards an embedding table's rows over the mesh's axes
(``BATCH + ("model",)``, degraded to the axes whose product divides the
rows: on the (16, 16) and (2, 16, 16) meshes most tables shard over the
batch axes alone, and some over none).  A loss that declares a table
:data:`~repro_torch.distributed.leaf_kinds.LOCAL` (``train.trainer``)
is handed this rank's block of its rows, and looks it up with
:func:`lookup_rows`:

  * the ids of the ranks that hold different batch rows, those along the
    batch axes that shard the table, are gathered (the global batch's
    order: the outermost axis major);
  * this rank looks them all up in its block (``RowShard.window``): an
    id whose row lies in another block gives zeros, an id outside the
    whole table NaN under the ``fill`` rule on every block, as one
    process gives;
  * the partial rows are summed over the axes that shard the table (a
    reduce-scatter over its batch axes, which hands each rank its own
    batch rows, and an all-reduce over ``model`` where it shards them);
    each id lies in one block, so the sum is the one-process row bit
    for bit;
  * backward, each row's gradient goes back to the ranks that looked it
    up (an all-gather over the same batch axes), and the block's
    gradient is complete where it is index-added: no gradient of a
    whole table is formed or all-reduced.  The step sums it only over
    the batch axes that do not shard the table (their ranks hold the
    same block and other rows).

A block ``("data", "model")`` nested on dim 0 is rank (d, m)'s block
``d * M + m`` (DTensor's nesting, data-major; ``sharding.local_shard``).
Every collective of the route is issued even on an axis of one rank, as
``tensor_parallel``'s are, so the route and its count
(:data:`ROW_COLLECTIVES`) are the same on one card as on many.

Retrieval over candidates split over the batch axes (a block of rows a
rank, laid out as a table's rows are: a :class:`RowShard`) ranks each
block where it lies and merges the blocks' top ids
(:func:`merge_top_ids`, counted in :data:`MERGE_COLLECTIVES`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import BATCH, axis_sizes
from repro_torch.distributed.tensor_parallel import MODEL, CollectiveCount
from repro_torch.kernels.embedding_bag.ref import resolve_window

# the collectives the lookups issue (forward and backward); a test or the
# smoke run zeroes it, runs a step and reads it
ROW_COLLECTIVES = CollectiveCount()
# the all-gathers of the blocks' top ids that a retrieval over split
# candidates issues (one for each batch axis that splits them)
MERGE_COLLECTIVES = CollectiveCount()


# --------------------------------------------------------- where rows lie --
@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's block of a table's rows: rows ``[first, first + n)``
    of ``rows``, sharded over ``axes`` (mesh order); ``batch`` are the
    process groups of those that are batch axes (the outermost first),
    ``model`` the ``model`` axis's group where it is one of them."""
    rows: int
    first: int
    n: int
    axes: Tuple[str, ...]
    batch: Tuple[Any, ...]
    model: Any

    @property
    def window(self) -> Tuple[int, int]:
        """``(first, rows)``, the window of the bag kernel and of
        :func:`~repro_torch.kernels.embedding_bag.ref.resolve_window`."""
        return self.first, self.rows


def row_shard(mesh: Any, entry: Any, rows: int) -> RowShard:
    """Where this rank's block lies of a table of ``rows`` rows whose dim
    0 is laid out by the resolved spec ``entry`` (None, an axis name or a
    tuple of them in mesh order) on ``mesh``."""
    axes = (() if entry is None else (entry,) if isinstance(entry, str)
            else tuple(entry))
    names = list(axis_sizes(mesh))
    coord = mesh.get_coordinate()
    first, n = 0, rows
    for a in axes:
        i = names.index(a)
        if n % mesh.size(i):
            raise ValueError(f"{rows} rows do not divide over {axes}")
        n //= mesh.size(i)
        first += coord[i] * n
    return RowShard(rows, first, n, axes,
                    tuple(mesh.get_group(a) for a in axes if a in BATCH),
                    mesh.get_group(MODEL) if MODEL in axes else None)


# ------------------------------------------------------------ collectives --
def _gather(x: torch.Tensor, groups: Sequence[Any],
            counter: CollectiveCount = ROW_COLLECTIVES) -> torch.Tensor:
    """``x`` of every rank along ``groups`` (the outermost first) along
    dim 0, in the global batch's order: the innermost gathered first."""
    for g in reversed(groups):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
        counter.count += 1
        dist.all_gather(parts, x.contiguous(), group=g)
        x = torch.cat(parts, 0)
    return x


class _SumRows(torch.autograd.Function):
    """The blocks' partial rows of the gathered batch summed over the
    axes that shard the table, this rank's batch rows kept: a
    reduce-scatter over the batch axes (the outermost first), then an
    all-reduce over ``model``.  The gradient of this rank's rows is
    gathered back over the batch axes (every rank's rows' gradient, for
    the rows it looked up) and passed through ``model`` (each model rank
    holds the whole gradient of its replicated rows)."""

    @staticmethod
    def forward(ctx, x, batch, model):
        ctx.batch = batch
        for g in batch:
            parts = list(x.contiguous().chunk(dist.get_world_size(g), 0))
            x = torch.empty_like(parts[0])
            ROW_COLLECTIVES.count += 1
            dist.reduce_scatter(x, parts, group=g)
        if model is not None:
            if not batch:   # never all-reduce the Function's input in place
                x = x.clone(memory_format=torch.contiguous_format)
            ROW_COLLECTIVES.count += 1
            dist.all_reduce(x, group=model)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.batch), None, None


def lookup_rows(ids: torch.Tensor, shard: RowShard,
                look: Callable[[torch.Tensor], torch.Tensor]
                ) -> torch.Tensor:
    """The rows of this rank's ``ids`` (batch rows on dim 0) in a table
    laid out as ``shard``: ``look(gathered)`` looks the ids gathered over
    the shard's batch axes up in this rank's block (zeros for ids of
    other blocks, :func:`block_rows` or the bag kernel's window), and
    the partial rows are summed over the shard's axes.  Every rank of
    the mesh calls it, for the same tables in the same order."""
    return _SumRows.apply(look(_gather(ids, shard.batch)), shard.batch,
                          shard.model)


def block_rows(table: torch.Tensor, ids: torch.Tensor,
               window: Tuple[int, int], dtype: torch.dtype) -> torch.Tensor:
    """``sparse.embedding.embedding_lookup`` of a block of a table:
    ``(...)`` ids -> ``(..., dim)`` in ``dtype``, under ``fill`` against
    the whole table of ``window = (first, V)``: the block's rows for ids
    in it, zeros for ids of other blocks, NaN for ids outside the whole
    table.  With the window ``(0, V)`` of a whole table, the lookup's
    values bit for bit."""
    rows, ok, add = resolve_window(ids.reshape(-1), table.shape[0], window,
                                   "fill")
    out = table.index_select(0, rows).to(dtype)
    out = torch.where(ok[:, None], out, float("nan"))
    out = torch.where(add[:, None], out, 0.0)
    return out.reshape(*ids.shape, table.shape[1])


def merge_top_ids(scores: torch.Tensor, block: RowShard, k: int
                  ) -> torch.Tensor:
    """The global ids of the ``k`` largest of ``block.rows`` scores split
    over the batch axes, the lower id first among equal scores, as
    ``jax.lax.top_k`` over all of them gives them; ``scores`` are this
    rank's block's (rows ``[block.first, block.first + block.n)``).

    Each rank takes its block's top ``min(k, n)`` (a stable descending
    sort, as ``models.recsys.top_ids`` takes them) as (score, global id)
    pairs packed in float64 (exact for f32 and bf16 scores and for ids
    below 2^53), padded to ``k`` with (-inf, ``rows`` + i); the pairs of
    every rank along the block's axes are all-gathered in rank order (a
    counted collective an axis); a stable ascending sort of the ids,
    then a stable descending sort of the scores, keep the first ``k``.
    The blocks
    are contiguous and gathered in rank order, and each block's list is
    already ordered (score descending, id ascending), so the result is
    the top ``k`` of all ``rows`` ties included; the sort by id places a
    pad after every candidate, so none is kept while ``k <= rows``.
    Every rank along the block's axes returns the same ids; ranks along
    the axes that do not split the candidates (``model``) hold the same
    block and return them too.  Every such rank calls it."""
    n = scores.shape[0]
    if block.n != n:
        raise ValueError(f"{n} scores for a block of {block.n} rows")
    mine = torch.sort(scores, descending=True, stable=True).indices[:k]
    pairs = torch.full((k, 2), float("-inf"), dtype=torch.float64,
                       device=scores.device)
    pairs[:, 1] = torch.arange(block.rows, block.rows + k,
                               dtype=torch.float64, device=scores.device)
    pairs[:mine.shape[0], 0] = scores[mine].double()
    pairs[:mine.shape[0], 1] = (mine + block.first).double()
    every = _gather(pairs, block.batch, MERGE_COLLECTIVES)
    every = every[torch.sort(every[:, 1], stable=True).indices]
    order = torch.sort(every[:, 0], descending=True, stable=True).indices
    return every[order[:k], 1].to(torch.int64)
