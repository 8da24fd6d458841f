"""The training driver: ``Trainer.fit`` of the port, one step a call.

Set-up draws the weights on the card from the seed, builds the one
``Trainer`` that the window uses, places the traffic's pool of batches
on the card, and runs the first steps through ``fit`` on distinct
batches (the first compiles and warms every kernel), reading what the
reference is compared with: each step's loss, each leaf's norm of the
first clipped gradient (from AdamW's first moment after one step, which
is ``(1 - b1)`` times it) and each leaf's norm of its change.  The
window then runs whole steps, each timed to a synchronize, until
``seconds`` have passed.  A traced run profiles ``trace_steps`` more
steps after the window.  Then the program's state is freed and the
reference follows the same first steps from the same weights.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from bench.lib import compare, traffic
from bench.lib import trace as tracing
from bench.lib import weights as W
from bench.lib.device import free_cache, peak_bytes, sync
from bench.reference.follow import change_norm, follow, leaf_norm
from bench.reference.precision import DTYPES


class Program:
    """The system under test: one ``Trainer`` on the run's weights."""

    def __init__(self, fam, seed: int, device):
        from repro_torch.train.trainer import Trainer

        self.fam, self.seed, self.device = fam, seed, device
        self.specs = fam.specs()
        loss_fn, cfg = fam.program()
        weights = W.nest(W.draw(self.specs, seed, device))
        self.trainer = Trainer(loss_fn, weights, cfg, device=device)
        del weights
        self.pool = traffic.pool(fam.mix, fam.model, seed, device)

    def batch(self, cursor: int) -> Dict[str, torch.Tensor]:
        return self.pool[cursor % len(self.pool)]

    def step(self) -> float:
        """One ``fit`` step; its loss."""
        t = self.trainer
        t.fit(self.batch, t.step_num + 1)
        return t.history[-1]["loss"]

    def first_steps(self, n: int) -> dict:
        """``n`` steps from the start, read as the reference reads its
        own."""
        losses, grad = [], {}
        for k in range(n):
            losses.append(self.step())
            if k == 0:
                b1 = self.trainer.cfg.opt.b1
                grad = {name: leaf_norm(mu) / (1 - b1) for name, mu in
                        W.flat(self.trainer.opt_state["mu"]).items()}
        params = W.flat(self.trainer.params)
        change = {}
        for i, spec in enumerate(self.specs):
            p0 = W.draw_leaf(spec, i, self.seed, self.device)
            change[spec[0]] = change_norm(params[spec[0]], p0)
            del p0
        return {"loss": losses, "grad": grad, "change": change}

    def free(self) -> None:
        del self.trainer, self.pool
        gc.collect()
        free_cache(self.device)


def reference(fam, seed: int, device, n: int, mm: str = "none",
              state_dtype=torch.float32) -> dict:
    """The reference's readings of the first ``n`` steps (or a control's,
    with a lower ``mm`` or ``state_dtype``)."""
    specs = fam.specs()
    index = {s[0]: i for i, s in enumerate(specs)}
    pool = traffic.pool(fam.mix, fam.model, seed, device, n)
    steps = [fam.microbatches(b) for b in pool]
    return follow(fam.reference_loss,
                  lambda name: W.draw_leaf(specs[index[name]], index[name],
                                           seed, device),
                  [s[0] for s in specs], steps, fam.reference_cfg, fam.opt,
                  mm=mm, state_dtype=state_dtype)


def window(prog: Program, seconds: float) -> dict:
    step_s: List[float] = []
    losses: List[float] = []
    sync(prog.device)
    t0 = time.perf_counter()
    while True:
        s0 = time.perf_counter()
        losses.append(prog.step())
        sync(prog.device)
        s1 = time.perf_counter()
        step_s.append(s1 - s0)
        if s1 - t0 >= seconds:
            break
    return {"window_s": s1 - t0, "step_s": step_s, "losses": losses}


def run(fam, seed: int, seconds: float, traced: bool, device,
        t_start: float, limits: dict) -> dict:
    reference_steps = limits["reference_steps"]
    phases = {"start": time.perf_counter() - t_start}
    t = time.perf_counter()
    prog = Program(fam, seed, device)
    sync(device)
    phases["program"] = time.perf_counter() - t
    t = time.perf_counter()
    readings = prog.first_steps(reference_steps)
    sync(device)
    phases["first_steps"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    win = window(prog, seconds)
    out = {"setup_s": setup_s, **win, "memory_peak_bytes": peak_bytes(device)}
    if traced:
        n = fam.mix["trace_steps"]
        # the thrown-away step takes the cursor's batch, the stretch the
        # next n
        c0 = prog.trainer.data_cursor + 1

        def step():
            prog.step()
            sync(device)
        t = time.perf_counter()
        events = tracing.profile(step, n, fam.patches())
        phases["profile"] = time.perf_counter() - t
        t = time.perf_counter()
        out["trace"] = tracing.reduce(events, fam.spans)
        phases["reduce"] = time.perf_counter() - t
        del events
        out["counts"] = fam.counts([prog.batch(c0 + i) for i in range(n)])
    else:
        out["counts"] = fam.counts()
    prog.free()
    del prog
    t = time.perf_counter()
    ref = reference(fam, seed, device, reference_steps)
    phases["reference"] = time.perf_counter() - t
    out["numbers"] = compare.numbers(readings, ref)
    out["phases"] = phases
    out["mean_step_s"] = out["window_s"] / len(out["step_s"])
    return out


def end_to_end(out: dict, mix: dict) -> dict:
    """The end-to-end metrics this driver can give, by name."""
    n, t = len(out["step_s"]), out["window_s"]
    items = traffic.items(mix)
    vals = {"setup_s": out["setup_s"],
            "samples_per_s": items["samples"] * n / t,
            "step_p95_ms": float(np.percentile(out["step_s"], 95)) * 1e3}
    if "tokens" in items:
        vals["train_tokens_per_s"] = items["tokens"] * n / t
    return vals


def attempts(out: dict) -> tuple:
    """Steps attempted in the window, and those whose loss was not
    finite."""
    return (len(out["losses"]),
            sum(1 for x in out["losses"] if not np.isfinite(x)))


# ----------------------------------------------- the calibration's parts --
numbers = compare.numbers


def program_readings(fam, seed: int, device, limits: dict,
                     seconds: float = 0.0) -> dict:
    """The first steps' readings (training needs no window)."""
    prog = Program(fam, seed, device)
    readings = prog.first_steps(limits["reference_steps"])
    prog.free()
    return readings


def reference_readings(fam, seed: int, device, limits: dict, prog=None,
                       control: bool = False) -> dict:
    c = limits["control"] if control else {}
    return reference(fam, seed, device, limits["reference_steps"],
                     mm=c.get("mm", "none"), state_dtype=DTYPES[
                         c.get("state_dtype", "float32")])
