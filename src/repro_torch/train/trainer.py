"""Fault-tolerant training loop with microbatch gradient accumulation,
the port of ``repro.train.trainer``.

  * ``build_train_step`` turns any ``loss_fn(params, batch)`` into
    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``;
    gradients come from autograd where the reference takes
    ``jax.value_and_grad``.  With microbatches, each micro-batch's f32
    gradient is summed into a zero tree in order and the sum divided by
    their count, as the reference's scan does,
  * optional int8 gradient compression before the optimizer,
  * periodic async checkpoints and resume from (step, data cursor): a
    restarted run continues from the exact batch,
  * a step on a mesh, taken where the params are DTensors
    (:mod:`repro_torch.distributed.sharding`), data-parallel over the
    batch axes and, for a loss that declares its split (the LM's and the
    recsys family's), tensor- and expert-parallel over ``model``
    (:mod:`repro_torch.distributed.tensor_parallel`), on tables where
    their rows lie (:mod:`repro_torch.distributed.row_parallel`), and
    for the GNN family on its node and edge blocks
    (:mod:`repro_torch.distributed.graph_parallel`): see
    :func:`build_train_step`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import Shard

from repro_torch.ckpt.checkpoint import (
    CheckpointManager,
    latest_step,
    load_checkpoint,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.compression import compress_tree
from repro_torch.distributed.tensor_parallel import (
    MODEL,
    model_group_of,
    use_model_group,
)
from repro_torch.distributed.hooks import (
    batch_sum,
    batch_sum_,
    local,
    rows_like,
    use_mesh,
)
from repro_torch.distributed.leaf_kinds import Local, local_of
from repro_torch.distributed.sharding import (
    P,
    NamedSharding,
    block_except,
    full_tensor,
    gather_except,
    is_sharded,
    mesh_of,
    place,
    rewrap,
    shard_batch,
    sharding_of,
)
from repro_torch.obs import span
from repro_torch.train.optim import (
    OptConfig,
    adamw_init,
    adamw_update,
    global_norm,
)
from repro_torch.tree import leaves, tree_map, unflatten


@dataclasses.dataclass
class TrainerConfig:
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    microbatches: int = 1
    compress_grads: bool = False
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10


def value_and_grad(loss_fn: Callable[[Any, Dict], torch.Tensor],
                   params: Any, batch: Dict):
    """``(loss, grads)`` of ``loss_fn`` at ``params``, grads in the
    params' structure and dtypes (zeros where the loss does not reach a
    leaf, as JAX gives)."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(live, batch)
        flat = leaves(live)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), unflatten(params, [
        torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)])


def build_train_step(
    loss_fn: Callable[[Any, Dict], torch.Tensor],
    cfg: TrainerConfig,
    donate: bool = True,
):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` leaves must have a leading dim divisible by
    ``cfg.microbatches``.  With ``donate`` (the reference's default) the
    step updates ``params`` and ``opt_state`` in place and returns them,
    as a JAX step reuses donated buffers: the caller must not expect the
    old values in them afterwards.

    Where ``params`` are DTensors (and ``opt_state`` is laid out as
    :func:`opt_init` lays it), the step runs on their mesh, inside
    :func:`~repro_torch.distributed.hooks.use_mesh`, with ``batch`` the
    global batch on every rank, as plain tensors or already placed on
    the mesh (DTensors, kept as they lie; one microbatch):

      * it gathers the params it computes with over the batch axes (on a
        mesh of one rank, their local tensors: nothing is copied).  Where
        ``loss_fn`` has ``model_dims(params, model_group)`` (as
        ``models.transformer.LMLoss`` and ``models.recsys.RecsysLoss``),
        the loss runs inside ``tensor_parallel.use_model_group`` and each
        leaf is of one of three kinds: a dimension (an int), the leaf
        stays this rank's ``model`` shard along it, computed on
        (Megatron's column and row splits, experts and vocabulary rows
        a rank, the recsys MLPs' columns); ``leaf_kinds.LOCAL``, the
        leaf is computed on as it lies, this rank's block over every
        axis (a recsys table looked up where its rows lie); None, the
        leaf is gathered whole.  Every leaf of a loss without it is
        gathered whole: the GNN family's, which its rules replicate, and
        which it computes with on its batch shards
        (:mod:`repro_torch.distributed.graph_parallel`);
      * each microbatch of plain tensors (rows in the global batch's
        order, as in the reference) is placed by ``shard_batch`` over the
        batch axes, and
        the loss, which takes its rows with ``hooks.local`` and ends in
        ``hooks.batch_mean``, is this rank's share of the global loss:
        its gradient is this rank's part of the global gradient, whatever
        each rank's count of valid terms;
      * the shares and gradients are summed over the batch axes (an
        all-reduce; a ``LOCAL`` leaf's only over those that do not shard
        it, whose ranks hold the same block), compressed where asked
        (each leaf as a whole, as the reference's ``compress_tree``: a
        shard takes its whole leaf's scale, the largest over the axes
        that cut it), and each rank's AdamW updates its own shards with
        the global gradient norm (a shard's sum of squares summed over
        the axes that cut it).

    Plain params are the mesh-less case of the same step: every gather,
    cut and sum above is then the identity."""

    def grads_of(params, batch, placed: Callable[[Any], Any]):
        mb = cfg.microbatches
        if mb > 1 and any(is_sharded(x) for x in leaves(batch)):
            raise ValueError("a batch placed on the mesh is one microbatch")
        if mb > 1:
            micro = tree_map(
                lambda x: x.reshape((mb, x.shape[0] // mb) + tuple(x.shape[1:])),
                batch)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=leaves(params)[0].device)
            for i in range(mb):
                loss, g = value_and_grad(
                    loss_fn, params, placed(tree_map(lambda x: x[i], micro)))
                for a, b in zip(leaves(grads), leaves(g)):
                    a.add_(b.float())
                del g
                loss_sum = loss_sum + loss
            loss = loss_sum / mb
            for a in leaves(grads):
                a.div_(mb)
            return loss, grads
        return value_and_grad(loss_fn, params, placed(batch))

    split = getattr(loss_fn, "model_dims", None)

    def step(params, opt_state, batch):
        mesh = mesh_of(params)
        mg = model_group_of(mesh) if split is not None else None
        # each leaf's dimension kept as this rank's model shard, a Local
        # (computed on as it lies, its axes filled in from the leaf), or
        # None where it is gathered whole (every leaf, without a model
        # group)
        dims = (tree_map(lambda p: None, params) if mg is None
                else tree_map(lambda p, d: local_of(p)
                              if isinstance(d, Local) else d,
                              params, split(params, mg)))

        def placed(b):
            if mesh is None:
                return b
            return tree_map(lambda x, s: x if is_sharded(x) else place(x, s),
                            b, shard_batch(b, mesh))

        with use_mesh(mesh):
            full = tree_map(_compute_leaf, params, dims)
            with use_model_group(mg):
                loss, grads = grads_of(full, batch, placed)
            del full
            loss = batch_sum(loss)
            grads = tree_map(lambda g, d: batch_sum_(
                g, d.axes if isinstance(d, Local) else ()), grads, dims)
            if cfg.compress_grads:
                grads = compress_tree(grads, dims, mg)
            gn = global_norm(grads, dims, mg)
            shards = tree_map(_grad_block, grads, params, dims)
            del grads
            new_p, new_s, om = adamw_update(
                cfg.opt, shards, tree_map(local, opt_state),
                tree_map(local, params), donate=donate, grad_norm=gn)
        return (tree_map(rewrap, new_p, params),
                tree_map(rewrap, new_s, opt_state), {"loss": loss, **om})

    return step


def _compute_leaf(p: Any, dim) -> Any:
    """What a step computes with: ``p`` gathered whole (``dim`` None),
    this rank's block (a ``Local``), or ``p`` gathered over the batch
    axes only, its ``model`` shard along ``dim`` kept."""
    if dim is None:
        return full_tensor(p)
    if isinstance(dim, Local):
        return local(p)
    if is_sharded(p):
        names = p.device_mesh.mesh_dim_names
        pl = p.placements[names.index(MODEL)]
        if pl != Shard(dim):
            raise ValueError(f"a leaf computed on its model shard along dim "
                             f"{dim} is placed {pl} on the model axis")
    return gather_except(p, MODEL)


def _grad_block(g: torch.Tensor, p: Any, dim) -> torch.Tensor:
    """This rank's block of the gradient ``g`` of ``p`` (``g`` whole,
    ``p``'s block itself for a ``Local``, or ``p``'s ``model`` shard along
    ``dim``)."""
    if isinstance(dim, Local):
        return g
    return rows_like(g, p) if dim is None else block_except(g, p, MODEL)


def opt_init(params: Any) -> Dict:
    """``adamw_init`` of ``params``; where they are DTensors, ``mu`` and
    ``nu`` laid out as the params and ``step`` replicated on their mesh
    (the reference's ``opt_shardings``)."""
    state = adamw_init(tree_map(local, params))
    return {"mu": tree_map(rewrap, state["mu"], params),
            "nu": tree_map(rewrap, state["nu"], params),
            "step": place(state["step"], NamedSharding(mesh_of(params), P()))}


def _tensor(x: Any, device: torch.device, copy: bool = False) -> torch.Tensor:
    """A tensor or array leaf as a tensor on ``device``; with ``copy``
    never one that shares memory with ``x``.  A DTensor stays one, its
    local block copied."""
    if is_sharded(x):
        return rewrap(_tensor(x.to_local(), device, copy), x)
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=copy)
    if copy:
        return torch.tensor(np.asarray(x), device=device)
    return torch.as_tensor(np.asarray(x), device=device)


class Trainer:
    """Trains ``params`` (a tree of tensors or arrays, copied to
    ``device``; None means the card) with ``loss_fn`` under ``cfg``.  Its
    step donates the copy, so the caller's tensors are left as they
    were.  Params placed on a mesh (DTensors, ``sharding.place``) train
    there: the step and the checkpoints run on their mesh."""

    def __init__(
        self,
        loss_fn: Callable,
        params: Any,
        cfg: TrainerConfig,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.params = tree_map(lambda p: _tensor(p, self.device, copy=True),
                               params)
        self.mesh = mesh_of(self.params)
        self.opt_state = opt_init(self.params)
        self.step_num = 0
        self.data_cursor = 0
        self._step = build_train_step(loss_fn, cfg, donate=True)
        self.ckpt = (
            CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts)
            if cfg.ckpt_dir
            else None
        )
        self.history = []

    # -- resume ----------------------------------------------------------------
    def try_resume(self, shardings: Any = None,
                   opt_shardings: Any = None) -> bool:
        """Restore the latest checkpoint, if any.  On a mesh the leaves
        are placed as the trainer's own are, unless ``shardings`` and
        ``opt_shardings`` say otherwise (the reference's elastic
        restore)."""
        if not self.cfg.ckpt_dir or latest_step(self.cfg.ckpt_dir) is None:
            return False
        if self.mesh is not None and shardings is None:
            shardings = tree_map(sharding_of, self.params)
            opt_shardings = tree_map(sharding_of, self.opt_state)
        self.params, self.opt_state, self.step_num, self.data_cursor = (
            load_checkpoint(self.cfg.ckpt_dir, self.params, self.opt_state,
                            device=self.device, shardings=shardings,
                            opt_shardings=opt_shardings)
        )
        return True

    # -- main loop ---------------------------------------------------------------
    def fit(self, batches: Callable[[int], Dict], n_steps: int) -> Dict:
        """Train until step ``n_steps``.  ``batches(cursor)`` returns the
        batch (tensors or arrays) for a given data cursor: a deterministic
        data order makes a restart exact."""
        last = {}
        while self.step_num < n_steps:
            with span("train.step"):
                batch = tree_map(lambda x: _tensor(x, self.device),
                                 batches(self.data_cursor))
                self.params, self.opt_state, metrics = self._step(
                    self.params, self.opt_state, batch
                )
                self.step_num += 1
                self.data_cursor += 1
                if (self.step_num % self.cfg.log_every == 0
                        or self.step_num == n_steps):
                    last = {k: float(v) for k, v in metrics.items()}
                    self.history.append({"step": self.step_num, **last})
            if self.ckpt and self.step_num % self.cfg.ckpt_every == 0:
                self.ckpt.save(
                    self.step_num, self.params, self.opt_state,
                    data_cursor=self.data_cursor,
                )
        if self.ckpt:
            self.ckpt.save(
                self.step_num, self.params, self.opt_state,
                data_cursor=self.data_cursor,
            )
            self.ckpt.wait()
        return last
