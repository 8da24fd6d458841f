"""The reference's run of a training cell's first steps: the readings
that the program's own first steps are compared with.

``follow`` trains from the same weights on the same batches, in plain
f32 PyTorch, and reads what the program's run reads: each step's loss,
each leaf's norm of the first step's gradient after clipping (what the
optimizer takes), and each leaf's norm of its change after the last
step.  Each step sums its microbatches' gradients leaf by leaf and
divides by their count, so only one microbatch's activations are live.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from bench.reference import adamw

NORM_CHUNK = 1 << 26


def leaf_norm(t: torch.Tensor) -> float:
    """The 2-norm of ``t``, summed in f64 a chunk at a time."""
    flat = t.detach().reshape(-1)
    return float(sum(c.double().square().sum() for c in flat.split(NORM_CHUNK))
                 ) ** 0.5


def change_norm(p: torch.Tensor, p0: torch.Tensor) -> float:
    a, b = p.detach().reshape(-1), p0.reshape(-1)
    total = 0.0
    for x, y in zip(a.split(NORM_CHUNK), b.split(NORM_CHUNK)):
        total += float((x.double() - y.double()).square().sum())
    return total ** 0.5


def follow(loss: Callable, weights: Callable[[str], torch.Tensor],
           names: List[str], steps: List[List[Dict[str, torch.Tensor]]],
           cfg: dict, opt: dict, mm: str = "none",
           state_dtype: torch.dtype = torch.float32) -> Dict:
    """``steps[t]`` holds step t's microbatches; ``weights(name)`` draws
    a leaf anew (f32); ``cfg["dtype"]`` is the precision computed in.
    ``mm`` and ``state_dtype`` select a control's precision below it."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = {n: weights(n).to(state_dtype).requires_grad_(True)
                  for n in names}
        m = {n: torch.zeros_like(p, dtype=state_dtype)
             for n, p in params.items()}
        v = {n: torch.zeros_like(p, dtype=state_dtype)
             for n, p in params.items()}
        losses, grad = [], {}
        for t, micro in enumerate(steps, start=1):
            total = 0.0
            for mb in micro:
                with torch.enable_grad():
                    # a control's low-precision state is computed with as
                    # f32, its gradient reaching the stored leaf
                    live = {n: p.float() if p.dtype != torch.float32 else p
                            for n, p in params.items()}
                    li = loss(live, mb, cfg, mm)
                    (li / len(micro)).backward()
                total += float(li.detach())
            losses.append(total / len(micro))
            grads = {n: p.grad.float() for n, p in params.items()}
            adamw.step(opt, t, {n: p.data for n, p in params.items()},
                       grads, m, v)
            if t == 1:
                grad = {n: leaf_norm(g) for n, g in grads.items()}
            for p in params.values():
                p.grad = None
            del grads
        change = {}
        for n, p in params.items():
            p0 = weights(n)
            change[n] = change_norm(p.float(), p0)
            del p0
        return {"loss": losses, "grad": grad, "change": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
