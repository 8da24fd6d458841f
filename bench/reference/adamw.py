"""Plain AdamW with global-norm clipping and the warm-up schedules the
configurations state (Loshchilov and Hutter, arXiv:1711.05101).

    g~ = g * min(1, clip / ||g||)
    m  = b1 m + (1 - b1) g~            v = b2 v + (1 - b2) g~^2
    p -= lr_t * (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd * p)

``lr_t`` rises linearly over ``warmup_steps``; ``wsd`` then holds it and
decays it exponentially to ``min_lr_ratio`` over the last
``decay_fraction`` of ``total_steps``; ``const`` holds it.  The state is
kept in ``state_dtype`` (float32, or bfloat16 for a control), each
update computed in f32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def lr_at(opt: dict, t: int) -> float:
    warm = min(t / max(opt["warmup_steps"], 1), 1.0)
    if opt["schedule"] == "const":
        return opt["lr"] * warm
    if opt["schedule"] == "wsd":
        total = opt["total_steps"]
        start = total * (1.0 - opt["decay_fraction"])
        if t < start:
            return opt["lr"] * warm
        frac = min(max((t - start) / max(total - start, 1), 0.0), 1.0)
        return opt["lr"] * warm * opt["min_lr_ratio"] ** frac
    raise ValueError(f"no schedule {opt['schedule']!r} in the reference")


def global_norm(grads: Dict[str, torch.Tensor]) -> float:
    return math.sqrt(sum(float(g.double().square().sum())
                         for g in grads.values()))


def step(opt: dict, t: int, params: Dict[str, torch.Tensor],
         grads: Dict[str, torch.Tensor], m: Dict[str, torch.Tensor],
         v: Dict[str, torch.Tensor]) -> float:
    """Step ``t`` (from 1) in place on ``params``, ``m`` and ``v``;
    ``grads`` are scaled in place by the clip.  Returns the clip's
    scale."""
    gn = global_norm(grads)
    scale = min(opt["clip_norm"] / max(gn, 1e-9), 1.0)
    lr = lr_at(opt, t)
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name].mul_(scale)
            mf = m[name].float().mul_(b1).add_(g, alpha=1 - b1)
            vf = v[name].float().mul_(b2).addcmul_(g, g, value=1 - b2)
            pf = p.float()
            upd = (mf / bc1) / (torch.sqrt(vf / bc2) + opt["eps"])
            upd.add_(pf, alpha=opt["weight_decay"]).mul_(lr)
            p.copy_(pf - upd)
            m[name].copy_(mf)
            v[name].copy_(vf)
            del mf, vf, pf, upd
    return scale
