"""One run of one cell of ``BENCHMARK.json``: the cell's configuration,
traffic mix, family, driver, limits and per-layer metric readers are
found by name, so a new cell or metric is new files and entries.

    configs/<config>.json    the configuration as it is run
    traffic/<traffic>.json   the mix: its kind's parameters and driver
    families/<family>.py     weights, program, reference and counts
    drivers/<driver>.py      set-up, the window and the trace stretch
    limits/<workload>.json   each number compared, with its limit
    metrics/<metric>.py      ``read(run)``: a per-layer metric, or None

The last line of standard output is the result; the numbers compared,
each beside its limit, are also the last lines of standard error.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Optional

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, root: Path = ROOT) -> dict:
    """Everything a run of ``workload`` reads, by name."""
    spec = load_json(root / "BENCHMARK.json")
    (cell,) = [w for w in spec["workloads"] if w["name"] == workload]
    (config,) = [c for c in spec["configs"] if c["name"] == cell["config"]]
    bench = root / "bench"
    return {"spec": spec, "cell": cell,
            "model": load_json(root / config["file"]),
            "mix": load_json(bench / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(bench / "limits" / f"{workload}.json")}


def family(model: dict, mix: dict):
    mod = importlib.import_module(f"bench.families.{model['family']}")
    return mod.Family(model, mix)


def driver(mix: dict):
    return importlib.import_module(f"bench.drivers.{mix['driver']}")


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reports(spec: dict, workload: str) -> list:
    """The end-to-end metrics the cell reports: those that list it, and
    those with no list (``setup_s``)."""
    return [m for m in spec["end_to_end"]
            if workload in m.get("workloads", (workload,))]


def per_layer(spec: dict, workload: str) -> list:
    """The per-layer metrics the cell reads: those that list it."""
    return [m for m in spec["per_layer"] if workload in m["workloads"]]


def forbidden_modules() -> list:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


class Run:
    """What a metric reader reads: the counts, the reduced trace and the
    window's mean step (or call) time."""

    def __init__(self, out: dict):
        self.counts = out["counts"]
        self.trace = out.get("trace")
        self.step_s = out["mean_step_s"]


def execute(workload: str, seed: int, seconds: float, traced: bool,
            t_start: float, device=None, root: Path = ROOT) -> Optional[dict]:
    """The result of one run, or None where there is no card to run on
    (``device`` overrides the card: a CPU run for the tests)."""
    import torch

    from bench.lib import compare
    from bench.lib.device import is_card

    s = cell_spec(workload, root)
    cell, mix, model = s["cell"], s["mix"], s["model"]
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            print(f"{workload} needs {cell['chips']} CUDA device(s); "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return None
        device = torch.device("cuda", 0)
    fam = family(model, mix)
    drv = driver(mix)
    out = drv.run(fam, seed, seconds, traced, device, t_start, s["limits"])
    print("phases (s): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                     out["phases"].items()), file=sys.stderr)
    nums = out["numbers"]
    correct, checks = compare.judge(nums, s["limits"]["limits"])
    attempted, failed = drv.attempts(out)
    if traced:
        run = Run(out)
        metrics = {}
        for m in per_layer(s["spec"], workload):
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = drv.end_to_end(out, mix)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in reports(s["spec"], workload)}
    card = is_card(device)
    dev = {"platform": "gpu" if card else "cpu",
           "kind": torch.cuda.get_device_name(device) if card else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
        result["breakdown"] = {"device_ops": out["trace"]["device_ops"],
                               "idle_gaps": out["trace"]["idle_gaps"]}
    if "grad_leaf" in nums:
        result["worst_leaves"] = {"grad": nums["grad_leaf"],
                                  "change": nums["change_leaf"]}
    result["checks"] = checks
    return result


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start)
    if result is None:
        return 3
    found = forbidden_modules()
    if found:
        print("loaded in the measuring process: " + ", ".join(found),
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
