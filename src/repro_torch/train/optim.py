"""AdamW with WSD (warmup-stable-decay) or cosine schedules and gradient
clipping, the port of ``repro.train.optim``.

Functional, over parameter trees of tensors (:mod:`repro_torch.tree`),
in the reference's arithmetic: the schedule and the bias corrections are
f32 tensors (not Python floats, which are f64 and would move their last
bits), ``step`` is an int32 0-d tensor, and the global norm sums its
per-leaf f32 terms in ``jax.tree_util``'s leaf order (sorted dict keys).

WSD is the MiniCPM schedule (arXiv:2404.06395): linear warmup, a long
stable plateau at peak LR, then a short exponential decay.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed.leaf_kinds import reduce_over_shards
from repro_torch.distributed.tensor_parallel import ModelGroup
from repro_torch.kernels.adamw.kernel import adamw_leaf
from repro_torch.obs import span
from repro_torch.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    clip_norm: float = 1.0
    schedule: str = "wsd"        # wsd | cosine | const
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_fraction: float = 0.1  # WSD: final fraction of steps that decay
    min_lr_ratio: float = 0.1


def schedule_lr(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor), as an f32 tensor."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "const":
        return cfg.lr * warm
    total = float(cfg.total_steps)
    if cfg.schedule == "cosine":
        t = torch.clamp((s - cfg.warmup_steps)
                        / max(total - cfg.warmup_steps, 1), 0, 1)
        cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return cfg.lr * warm * cos
    # WSD: stable until the decay phase, then exponential decay to the
    # min ratio
    decay_start = total * (1.0 - cfg.decay_fraction)
    t = torch.clamp((s - decay_start) / max(total - decay_start, 1), 0, 1)
    decay = cfg.min_lr_ratio ** t
    return cfg.lr * warm * torch.where(s < decay_start, 1.0, decay)


def adamw_init(params: Any) -> Dict:
    """f32 ``mu`` and ``nu`` shaped like ``params``, and ``step`` 0 (an
    int32 0-d tensor on the first leaf's device)."""
    first = leaves(params)
    device = first[0].device if first else None
    return {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
            "nu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any, dims: Any = None,
                mg: Optional[ModelGroup] = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, summed leaf by
    leaf in the reference's leaf order.  The sums of the leaves that
    ``dims`` keeps as this rank's ``model`` shards of ``mg``, and of
    those it declares computed on as they lie (``leaf_kinds.Local``),
    are first summed over the axes that cut them
    (``leaf_kinds.reduce_over_shards``: one collective an axis), so
    each is its whole leaf's and none is counted twice."""
    sums = reduce_over_shards(
        [torch.sum(torch.square(leaf.float())) for leaf in leaves(tree)],
        dims, mg)
    return torch.sqrt(torch.as_tensor(sum(sums), dtype=torch.float32))


def _update_leaf(p, g, mu, nu, scalars, cfg: OptConfig, donate: bool):
    """``adamw_leaf`` of one leaf.  An operand that is a strided view
    (the block of a whole tensor that ``sharding.place`` gives a rank, or
    a gradient cut from a whole one) goes through a contiguous copy, and
    with ``donate`` its new value is copied back into it."""
    dense_p, dense_mu, dense_nu = (t.contiguous() for t in (p, mu, nu))
    new = adamw_leaf(dense_p, g.contiguous(), dense_mu, dense_nu, *scalars,
                     b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                     weight_decay=cfg.weight_decay, donate=donate)
    if not donate:
        return new
    return tuple(t if t is d else t.copy_(d)
                 for t, d in zip((p, mu, nu), new))


def adamw_update(cfg: OptConfig, grads: Any, state: Dict, params: Any,
                 donate: bool = False,
                 grad_norm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, Dict, Dict]:
    """One AdamW step: ``(params, state, {"grad_norm", "lr"})``.

    Gradients are clipped to ``cfg.clip_norm`` by their global norm
    (``grad_norm`` where the caller took it, as a step on a mesh does over
    the whole gradients before it updates its shards).
    Each leaf is one :func:`~repro_torch.kernels.adamw.adamw_leaf`: a
    launch of the fused kernel on the card (the plain version's bits),
    the plain version on the CPU.  With ``donate``, ``params``, ``mu``
    and ``nu`` are updated in place and returned, as a JAX step that
    donates its buffers reuses them, where a new tree would hold the
    state twice (at DLRM-MLPerf's widths 36 GB of it).  The values are
    the same either way."""
    with span("optimizer"):
        step = state["step"] + 1
        gn = global_norm(grads) if grad_norm is None else grad_norm
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9),
                            max=1.0)
        lr = schedule_lr(cfg, step)
        bc1 = 1 - cfg.b1 ** step.to(torch.float32)
        bc2 = 1 - cfg.b2 ** step.to(torch.float32)
        out = [
            _update_leaf(p, g, m, n, (scale, lr, bc1, bc2), cfg, donate)
            for p, g, m, n in zip(leaves(params), leaves(grads),
                                  leaves(state["mu"]), leaves(state["nu"]))
        ]
        new_p = unflatten(params, [o[0] for o in out])
        new_mu = unflatten(params, [o[1] for o in out])
        new_nu = unflatten(params, [o[2] for o in out])
        metrics = {"grad_norm": gn, "lr": lr}
        return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, metrics
