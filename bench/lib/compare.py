"""The comparison that decides ``correct`` for a training cell.

The program's first steps and the reference's are read alike (each
step's loss, each leaf's norm of the first clipped gradient, each leaf's
norm of its change over the steps) and these numbers worked out; a cell
compares those that ``limits/<cell>.json`` gives a limit:

  * ``loss_gap``: the largest ``|loss - reference| / |reference|`` over
    the steps; ``first_loss_gap``: the same for the first step alone;
  * ``grad_gap``: over the leaves, the largest gap between the program's
    gradient norm and the reference's, over the reference's norm of that
    leaf or of the median leaf, whichever is larger;
  * ``change_gap``: the same for the norms of the change, over the leaves
    whose reference gradient is at least a thousandth of the median
    leaf's (a leaf with none moves by weight decay and round-off alone).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

NEGLIGIBLE_GRAD = 1e-3


def _finite(x: float) -> float:
    """A gap that is NaN (a NaN reading) as infinite, so it fails."""
    return float("inf") if x != x else x


def _worst(prog: Dict[str, float], ref: Dict[str, float],
           names: List[str]) -> Tuple[float, str]:
    med = statistics.median(ref[n] for n in names)
    gap = {n: _finite(abs(prog[n] - ref[n]) / max(ref[n], med))
           for n in names}
    worst = max(gap, key=gap.get)
    return gap[worst], worst


def numbers(prog: dict, ref: dict) -> dict:
    names = sorted(ref["grad"])
    losses = [_finite(abs(p - r) / abs(r))
              for p, r in zip(prog["loss"], ref["loss"])]
    med = statistics.median(ref["grad"].values())
    moved = [n for n in names if ref["grad"][n] >= NEGLIGIBLE_GRAD * med]
    grad, grad_leaf = _worst(prog["grad"], ref["grad"], names)
    change, change_leaf = _worst(prog["change"], ref["change"], moved)
    return {"loss_gap": max(losses), "first_loss_gap": losses[0],
            "grad_gap": grad, "change_gap": change,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "left_out": sorted(set(names) - set(moved))}


def judge(nums: dict, limits: Dict[str, float]) -> Tuple[bool, dict]:
    """Whether every number compared (each that ``limits`` names) is
    within its limit, and each beside its limit."""
    checks = {k: {"value": nums[k], "limit": v} for k, v in limits.items()}
    ok = bool(checks) and all(c["limit"] is not None
                              and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
