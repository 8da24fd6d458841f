"""Tensor and expert parallelism over the mesh's ``model`` axis: the
process group, the collectives that the Megatron column and row splits
need, written as autograd Functions, and their count.  The splits
themselves are the model's: ``models.transformer`` plans which of an
LM's dimensions a rank computes on its ``model`` shard (``LMPlan``) and
declares it to the train step (``LMLoss.model_dims``), which computes
inside :func:`use_model_group`; DLRM and two-tower split their MLPs'
columns (``models.recsys``), whose outputs :func:`gather_from_model`
gathers.

Every replicated value keeps its whole gradient on every rank: where
replicated values enter a rank's share of the compute,
:func:`copy_to_model` (identity, gradient summed over ``model``) stands
before them, and a rank's partial sums leave through
:func:`reduce_from_model` (summed, gradient passed through).  Both issue
their collective even on a ``model`` axis of one rank, so the route and
its count (:data:`MODEL_COLLECTIVES`) are the same on one card as on
many.  :func:`vocab_parallel_xent` is the cross-entropy over logits whose
vocabulary is split over ``model``.  :func:`merge_attention_partials`
merges the decode attention of a cache whose sequence is split over
``model`` (each rank's output over its block and the log-sum-exp that
weighs it); serving computes under ``torch.no_grad``, so it is no
autograd Function.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Iterator, Optional

import torch
import torch.distributed as dist


MODEL = "model"


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """The ``model`` axis of this rank's mesh: its process group, size and
    this rank's index along it."""
    group: Any
    size: int
    rank: int


def model_group_of(mesh: Any) -> Optional[ModelGroup]:
    """``mesh``'s ``model`` axis, or None where it has none."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if mesh is None or MODEL not in names:
        return None
    i = names.index(MODEL)
    return ModelGroup(mesh.get_group(MODEL), mesh.size(i),
                      mesh.get_coordinate()[i])


_GROUP: contextvars.ContextVar = contextvars.ContextVar("model_group",
                                                        default=None)


@contextlib.contextmanager
def use_model_group(mg: Optional[ModelGroup]) -> Iterator[None]:
    """Compute on ``model`` shards inside the block (None: whole)."""
    token = _GROUP.set(mg)
    try:
        yield
    finally:
        _GROUP.reset(token)


def model_group() -> Optional[ModelGroup]:
    return _GROUP.get()


class CollectiveCount:
    """The count of collectives issued over ``model`` (forward and
    backward); a test or the smoke run zeroes it, runs a step and reads
    it."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


MODEL_COLLECTIVES = CollectiveCount()


def all_reduce(x: torch.Tensor, mg: ModelGroup,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` (contiguous, as NCCL wants it) reduced in place over ``mg``,
    counted."""
    MODEL_COLLECTIVES.count += 1
    dist.all_reduce(x, op=op, group=mg.group)
    return x


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over ``model``."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(memory_format=torch.contiguous_format),
                          ctx.mg), None


class _ReduceFromModel(torch.autograd.Function):
    """Summed over ``model`` forward; the gradient passed through."""

    @staticmethod
    def forward(ctx, x, mg):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), mg)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mg: Optional[ModelGroup]
                  ) -> torch.Tensor:
    """``x`` (replicated over ``model``) entering a rank's share of the
    compute over ``mg``; ``x`` itself where ``mg`` is None."""
    return x if mg is None else _CopyToModel.apply(x, mg)


def reduce_from_model(x: torch.Tensor, mg: Optional[ModelGroup]
                      ) -> torch.Tensor:
    """The sum over ``mg`` of every rank's partial ``x``; ``x`` itself
    where ``mg`` is None."""
    return x if mg is None else _ReduceFromModel.apply(x, mg)


class _GatherFromModel(torch.autograd.Function):
    """Every ``model`` rank's columns (last dim) side by side, in rank
    order; the gradient is this rank's columns of the whole one (each
    rank computes on the gathered value alike)."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg, ctx.n = mg, x.shape[-1]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(mg.size)]
        MODEL_COLLECTIVES.count += 1
        dist.all_gather(parts, x.contiguous(), group=mg.group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, grad):
        r, n = ctx.mg.rank, ctx.n
        return grad[..., r * n:(r + 1) * n], None


def gather_from_model(x: torch.Tensor, mg: Optional[ModelGroup]
                      ) -> torch.Tensor:
    """The whole of ``x``, this rank's block of columns of a value split
    over ``mg``; ``x`` itself where ``mg`` is None."""
    return x if mg is None else _GatherFromModel.apply(x, mg)


# ------------------------------------------- vocab-parallel cross-entropy --
class _VocabLogsumexp(torch.autograd.Function):
    """Each row's log-sum-exp over a vocabulary split over ``model``, in
    ``torch.logsumexp``'s steps: the row maximum (reduced over ``model``,
    an infinite one taken as 0), the sum of exponentials (summed over
    ``model``), its log plus the maximum.  The gradient is this rank's
    logits' share, ``grad * exp(x - result)``, as ``torch.logsumexp``'s;
    it needs no collective."""

    @staticmethod
    def forward(ctx, x, mg):
        mx = x.amax(-1, keepdim=True)
        all_reduce(mx, mg, op=dist.ReduceOp.MAX)
        mx.masked_fill_(mx.abs() == math.inf, 0)
        total = (x - mx).exp().sum(-1)
        all_reduce(total, mg)
        out = total.log().add(mx[..., 0])
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return grad[..., None] * (x - out[..., None]).exp(), None


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                        start: int, mg: ModelGroup,
                        ignore_id: int = -1) -> torch.Tensor:
    """``nn.layers.softmax_xent`` of logits whose last dim is this rank's
    block of the vocabulary, ids ``start`` on, split over ``mg``: the
    log-sum-exp's maximum and sum and the gold logit (0 on the ranks
    whose block does not hold it) are reduced over ``model``; the value
    is the whole vocabulary's on every rank."""
    logits = logits.float()
    n = logits.shape[-1]
    logz = _VocabLogsumexp.apply(logits, mg)
    at = labels.clamp(min=0).long() - start
    here = (at >= 0) & (at < n)
    gold = torch.gather(logits, -1, at.clamp(0, n - 1)[..., None])[..., 0]
    gold = reduce_from_model(torch.where(here, gold, 0.0), mg)
    nll = logz - gold
    mask = (labels != ignore_id).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# ------------------------------------------- sequence-parallel attention --
def _weighted(o: torch.Tensor, lse: torch.Tensor, top: torch.Tensor
              ) -> torch.Tensor:
    """``o * w`` and ``w = exp(lse - top)`` side by side, (..., D + 1) in
    f32."""
    w = torch.exp(lse - top)
    return torch.cat([o.float() * w[..., None], w[..., None]], -1)


def _divided(sums: torch.Tensor) -> torch.Tensor:
    D = sums.shape[-1] - 1
    return sums[..., :D] / sums[..., D:]


def merge_attention_partials(o: torch.Tensor, lse: torch.Tensor,
                             mg: ModelGroup, heads: bool = False
                             ) -> torch.Tensor:
    """The attention of rows whose tokens are split over ``mg`` in blocks,
    one a rank, from this rank's output over its block, ``o`` (B, H, D),
    and the f32 log-sum-exp of its scores there, ``lse`` (B, H) (a block
    that holds none of a row's tokens: a zero output and a log-sum-exp
    far below any real one, as ``kernels.paged_attention`` writes them).
    In f32::

        M = max over ranks of lse,  w = exp(lse - M),
        out = (sum over ranks of o * w) / (sum over ranks of w)

    The maximum is one all-reduce over ``mg``; the sums travel packed
    together, (B, H, D + 1).  With ``heads`` they are reduce-scattered
    over the head dimension, each rank receiving its block of ``H /
    mg.size`` heads (the rows of ``wo`` that it holds): half the wire
    bytes of an all-reduce, and the result is (B, H / size, D);
    otherwise all-reduced, (B, H, D) on every rank.  Two collectives a
    call, counted."""
    B, H, D = o.shape
    top = all_reduce(lse.clone(memory_format=torch.contiguous_format), mg,
                     op=dist.ReduceOp.MAX)
    sums = _weighted(o, lse, top)
    if not heads:
        return _divided(all_reduce(sums, mg))
    if H % mg.size:
        raise ValueError(f"{H} heads do not split over {mg.size} ranks")
    whole = sums.transpose(0, 1).contiguous()     # (H, B, D + 1)
    part = torch.empty((H // mg.size, B, D + 1), dtype=whole.dtype,
                       device=whole.device)
    MODEL_COLLECTIVES.count += 1
    dist.reduce_scatter_tensor(part, whole, group=mg.group)
    return _divided(part.transpose(0, 1))


def merge_attention_blocks(o: torch.Tensor, lse: torch.Tensor
                           ) -> torch.Tensor:
    """:func:`merge_attention_partials`' arithmetic over ``n`` blocks held
    in one process, stacked on a leading axis: ``o`` (n, B, H, D),
    ``lse`` (n, B, H); (B, H, D) in f32.  The card's check and the tests
    hold the paged kernel's blocks of a cache to its whole launch by
    it."""
    return _divided(_weighted(o, lse, lse.amax(0)).sum(0))
