"""The serving driver: the port's score function, one call a batch.

Set-up draws the weights on the card from the seed in the serving dtype,
places the traffic's pool of batches on the card and warms the call (the
first builds the kernels).  The window issues calls back to back until
``seconds`` have passed, then waits for the last; each call is timed on
the device by CUDA events recorded between calls, read after the window,
so no call waits for the one before.  It keeps the scores of calls drawn
from the seed: ``check_calls`` call numbers among those the warm calls'
pace says a window makes.  A traced run profiles ``trace_steps`` calls
after the window.  Then the program's state is freed and the reference
scores every batch of the pool, which the kept calls' scores are held
to.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from bench.lib import trace as tracing
from bench.lib import traffic
from bench.lib import weights as W
from bench.lib.device import between_ms, free_cache, peak_bytes, stamp, sync
from bench.lib.seeds import numpy_rng

CHECKS = 5     # stream number of lib.seeds.derive
WARM_CALLS = 3


class Program:
    """The system under test: the score function on the run's weights."""

    def __init__(self, fam, seed: int, device):
        self.fam, self.device = fam, device
        self.score, self.cfg = fam.serve_program()
        self.params = W.nest(W.draw(fam.specs(), seed, device,
                                    fam.serve_dtype))
        self.pool = traffic.pool(fam.mix, fam.model, seed, device)

    def call(self, i: int) -> torch.Tensor:
        with torch.no_grad():
            return self.score(self.cfg, self.params,
                              self.pool[i % len(self.pool)])

    def free(self) -> None:
        del self.params, self.pool
        gc.collect()
        free_cache(self.device)


def warm(prog: Program) -> float:
    """The first calls (the first builds the kernels); the last's time."""
    for i in range(WARM_CALLS):
        t = time.perf_counter()
        prog.call(i)
        sync(prog.device)
    return time.perf_counter() - t


def serve(prog: Program, seed: int, seconds: float, checks: int,
          pace: float) -> dict:
    """The window; each call's device time and the kept calls' scores
    by call number."""
    expect = max(int(seconds / max(pace, 1e-6)), 1)
    keep = set(numpy_rng(seed, CHECKS).choice(
        expect, size=min(checks, expect), replace=False).tolist())
    kept: Dict[int, torch.Tensor] = {}
    calls = 0
    stamps = [stamp(prog.device)]
    t0 = time.perf_counter()
    while True:
        s = prog.call(calls)
        stamps.append(stamp(prog.device))
        if calls in keep:
            kept[calls] = s.float().clone()
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(prog.device)
    window_s = time.perf_counter() - t0
    if not kept:
        kept[calls - 1] = s.float().clone()
    return {"window_s": window_s, "calls": calls,
            "call_ms": between_ms(stamps), "kept": kept}


def reference(fam, seed: int, device, mm: str = "none"
              ) -> List[torch.Tensor]:
    """The reference's scores of each batch of the pool (a call's are
    those of its batch)."""
    params = W.draw(fam.specs(), seed, device, fam.serve_dtype)
    pool = traffic.pool(fam.mix, fam.model, seed, device)
    with torch.no_grad():
        return [fam.reference_logits(params, b, fam.reference_cfg, mm)
                for b in pool]


def numbers(prog, ref: List[torch.Tensor]) -> dict:
    """Over the kept calls' scores against the reference's:
    ``score_gap``, the widest gap over the largest reference score's
    magnitude (one wrong answer); ``score_rms_gap``, the gaps' 2-norm
    over the reference scores' (every answer a little off).  ``prog`` is
    the kept calls' scores by call number, or (a control in the
    program's place) scores by batch of the pool."""
    if isinstance(prog, list):
        prog = dict(enumerate(prog))
    got = torch.cat([prog[c].reshape(-1) for c in sorted(prog)]).double()
    want = torch.cat([ref[c % len(ref)].reshape(-1)
                      for c in sorted(prog)]).double()
    gap = (got - want).abs()
    out = {"score_gap": float(gap.max() / want.abs().max().clamp(min=1e-30)),
           "score_rms_gap": float(gap.norm() / want.norm().clamp(min=1e-30))}
    return {k: float("inf") if v != v else v for k, v in out.items()}


# ------------------------------------------------- as the harness runs it --
def run(fam, seed: int, seconds: float, traced: bool, device,
        t_start: float, limits: dict) -> dict:
    phases = {"start": time.perf_counter() - t_start}
    t = time.perf_counter()
    prog = Program(fam, seed, device)
    sync(device)
    phases["program"] = time.perf_counter() - t
    t = time.perf_counter()
    pace = warm(prog)
    phases["warm"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    win = serve(prog, seed, seconds, limits["check_calls"], pace)
    out = {"setup_s": setup_s, "window_s": win["window_s"],
           "calls": win["calls"], "call_ms": win["call_ms"],
           "memory_peak_bytes": peak_bytes(device)}
    out["failed"] = sum(1 for s in win["kept"].values()
                        if not bool(torch.isfinite(s).all()))
    if traced:
        n = fam.mix["trace_steps"]
        calls = iter(range(n + 1))

        def step():
            prog.call(next(calls))
            sync(device)
        t = time.perf_counter()
        events = tracing.profile(step, n, fam.patches())
        phases["profile"] = time.perf_counter() - t
        out["trace"] = tracing.reduce(events, fam.spans)
        del events
        out["counts"] = fam.counts([prog.pool[i % len(prog.pool)]
                                    for i in range(1, n + 1)])
    else:
        out["counts"] = fam.counts()
    prog.free()
    del prog
    t = time.perf_counter()
    ref = reference(fam, seed, device)
    phases["reference"] = time.perf_counter() - t
    out["numbers"] = numbers(win["kept"], ref)
    out["phases"] = phases
    out["mean_step_s"] = out["window_s"] / out["calls"]
    return out


def end_to_end(out: dict, mix: dict) -> dict:
    """The end-to-end metrics this driver can give, by name."""
    return {"setup_s": out["setup_s"],
            "score_samples_per_s":
                mix["batch"] * out["calls"] / out["window_s"],
            "score_p95_ms": float(np.percentile(out["call_ms"], 95))}


def attempts(out: dict) -> tuple:
    return out["calls"], out["failed"]


# ----------------------------------------------- the calibration's parts --
def program_readings(fam, seed: int, device, limits: dict,
                     seconds: float) -> dict:
    prog = Program(fam, seed, device)
    win = serve(prog, seed, seconds, limits["check_calls"], warm(prog))
    prog.free()
    return win["kept"]


def reference_readings(fam, seed: int, device, limits: dict, kept=None,
                       control: bool = False) -> List[torch.Tensor]:
    mm = limits["control"].get("mm", "none") if control else "none"
    return reference(fam, seed, device, mm)

