#!/usr/bin/env python3
"""The port's own spans (``repro_torch.obs.span``) in a traced run of a
benchmark cell, and what a span costs.

    python3 scripts/span_report.py cell --workload W --seed N \
        [--seconds S] [--program TREE] --out PATH
    python3 scripts/span_report.py stretch --workload W --seed N \
        [--pairs K] --out PATH
    python3 scripts/span_report.py cost --out PATH

``cell`` runs the cell once through the benchmark's harness with
``--trace 1``, on the port under ``TREE/src`` (this checkout's by
default: another tree's port, such as a parent commit's, runs under this
checkout's benchmark), and reduces the profiled stretch's raw events a
second time with ``bench/lib/spans.py``.  It writes the run's result
line, that reduction, the per-layer metrics read from the program's
spans (``bench/lib/span_readers.py``), the traced step's host time and
the window's mean step.

``stretch`` builds the cell's program once and profiles its traced
stretch ``2 K`` times, in turns with the spans on and off (off: the
spans see no profiler, as in a tree without them), reducing each with
``bench/lib/trace.py``: a traced step's host and busy time, and the
profiler's events, with and without the spans, in one process.

``cost`` times ``obs.span`` and an idle ``record_function`` with no
profiler, and ``obs.span`` under a profiler session that records (CPU
and, where there is a card, CUDA activity): microseconds a span entered
and left, the least of several repeats.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# each metric a later benchmark PR can list: (reader, arguments)
METRICS = {
    "optimizer_roofline": ("roofline", ("repro::optimizer", "adamw_bytes")),
    "lookup_roofline": ("roofline", ("repro::lookup", "bag_forward_bytes")),
    "cast_share": ("share", ("repro::lm.cast",)),
    "norm_share": ("share", ("repro::lm.norm",)),
    "rope_share": ("share", ("repro::lm.rope",)),
    "loss_share": ("share", ("repro::lm.loss",)),
    "step_idle": ("step_idle", ()),
}


def traced_cell(workload: str, seed: int, seconds: float, device=None,
                root: Path = ROOT) -> dict:
    """One traced run of ``workload`` (``device`` and ``root`` as
    ``harness.execute`` takes them), its stretch reduced by
    ``bench.lib.spans`` too."""
    from bench.lib import harness, span_readers, spans
    from bench.lib import trace as tracing

    runs = []
    reduce = tracing.reduce

    def both(events, fam_spans):
        out = reduce(events, fam_spans)
        out["program"] = spans.reduce(events)
        return out

    class Kept(harness.Run):
        def __init__(self, out):
            super().__init__(out)
            runs.append(self)

    saved = (tracing.reduce, harness.Run)
    tracing.reduce, harness.Run = both, Kept
    try:
        result = harness.execute(workload, seed, seconds, True,
                                 time.perf_counter(), device=device,
                                 root=root)
    finally:
        tracing.reduce, harness.Run = saved
    if result is None:
        raise SystemExit(f"{workload}: no card to run on")
    (run,) = runs
    steps = harness.cell_spec(workload, root)["mix"]["trace_steps"]
    return {"workload": workload, "seed": seed, "result": result,
            "program": run.trace["program"],
            "program_metrics": {
                name: getattr(span_readers, fn)(run, *args)
                for name, (fn, args) in METRICS.items()},
            "traced_step_s": run.trace["window_s"] / steps,
            "window_mean_step_s": run.step_s}


def stretches(workload: str, seed: int, pairs: int, device=None,
              root: Path = ROOT) -> dict:
    """The traced stretch of ``workload``'s program, ``pairs`` times
    with the spans on and off in turns (on first, then off first):
    each stretch's step time, busy time and event count, by mode."""
    import itertools
    from types import SimpleNamespace

    import torch

    from bench.lib import harness
    from bench.lib import trace as tracing
    from bench.lib.device import sync
    from repro_torch import obs

    s = harness.cell_spec(workload, root)
    mix = s["mix"]
    fam, drv = harness.family(s["model"], mix), harness.driver(mix)
    device = device or torch.device("cuda", 0)
    prog = drv.Program(fam, seed, device)
    if mix["driver"] == "serve":
        calls = itertools.count()

        def step():
            prog.call(next(calls))
            sync(device)
    else:
        def step():
            prog.step()
            sync(device)
    for _ in range(3):
        step()
    n = mix["trace_steps"]
    profiler = obs._profiler
    off = SimpleNamespace(_is_profiler_enabled=False)
    out = {"on": [], "off": []}
    for i in range(2 * pairs):
        mode = ("on", "off")[(i + i // 2) % 2]     # on off off on ...
        obs._profiler = profiler if mode == "on" else off
        try:
            events = tracing.profile(step, n, fam.patches())
        finally:
            obs._profiler = profiler
        r = tracing.reduce(events, fam.spans)
        out[mode].append({"step_s": r["window_s"] / n,
                          "busy_s": r["busy_s"] / n,
                          "events": len(events)})
        del events
    return {"workload": workload, "seed": seed, "steps": n, **out}


def span_cost(number: int = 200_000, repeat: int = 7) -> dict:
    """Microseconds a span: ``obs.span`` and an idle ``record_function``
    with no profiler, ``obs.span`` while a profiler records."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import obs

    def least(stmt, n=number):
        t = min(timeit.repeat(stmt, number=n, repeat=repeat))
        return t / n * 1e6

    def span():
        with obs.span("lm.norm"):
            pass

    def idle_range():
        with record_function("repro::lm.norm"):
            pass

    loop = least(lambda: None)
    out = {"off_us": least(span) - loop,
           "record_function_idle_us": least(idle_range, number // 10) - loop}
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        out["device"] = torch.cuda.get_device_name(0)
    # a session a repeat: the profiler's buffers grow with every span
    on = []
    for _ in range(repeat):
        with profile(activities=activities):
            on.append(least(span, number // 20) - loop)
    out["on_us"] = min(on)
    out["activities"] = [a.name for a in activities]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    cell = sub.add_parser("cell")
    cell.add_argument("--workload", required=True)
    cell.add_argument("--seed", type=int, required=True)
    cell.add_argument("--seconds", type=float, default=5.0)
    cell.add_argument("--program", type=Path, default=ROOT)
    cell.add_argument("--out", type=Path, required=True)
    stretch = sub.add_parser("stretch")
    stretch.add_argument("--workload", required=True)
    stretch.add_argument("--seed", type=int, required=True)
    stretch.add_argument("--pairs", type=int, default=3)
    stretch.add_argument("--out", type=Path, required=True)
    cost = sub.add_parser("cost")
    cost.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)
    program = args.program if args.what == "cell" else ROOT
    sys.path[:0] = [str(ROOT), str(program.resolve() / "src")]
    if args.what == "cell":
        got = traced_cell(args.workload, args.seed, args.seconds)
        got["program_tree"] = str(args.program)
    elif args.what == "stretch":
        got = stretches(args.workload, args.seed, args.pairs)
    else:
        got = span_cost()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(got, indent=1))
    print(json.dumps({k: v for k, v in got.items()
                      if k not in ("program", "result")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
