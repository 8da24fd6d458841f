"""The readings that a cell's limits are set from, in one process on
the card: the program's first training steps (or a short window's kept
scoring calls, ``--seconds``) on many seeds against the reference, the
control (the reference in the program's place, in the precision below
the one the configuration states) on a few, and each planted fault of
the cell's driver on a few.

    python3 bench/calibrate.py --workload dlrm-mlperf.train \
        --seeds 101,102,103 --control 3 --faults half_batch:3 \
        --out build/calibrate.json

For each number compared it prints the largest sound reading (the lower
one), the smallest control reading and each fault's smallest reading.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench.lib import harness  # noqa: E402
from bench.lib.faults import FAULTS  # noqa: E402


def floats(nums: dict) -> dict:
    return {k: v for k, v in nums.items() if isinstance(v, float)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="the control on this many of the seeds")
    ap.add_argument("--faults", default="",
                    help="name:count,... of the driver's faults")
    ap.add_argument("--seconds", type=float, default=5.0,
                    help="a serving cell's window (training needs none)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    s = harness.cell_spec(args.workload)
    fam = harness.family(s["model"], s["mix"])
    drv = harness.driver(s["mix"])
    limits = s["limits"]
    device = torch.device("cuda", 0) if torch.cuda.is_available() else "cpu"
    seeds = [int(x) for x in args.seeds.split(",")]
    progs, refs = {}, {}
    out = {"workload": args.workload, "sound": {}, "control": {},
           "faults": {}, "seconds": {}}

    def save():
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))

    def stored(x):
        return x if s["mix"]["driver"] == "train" else None

    for seed in seeds:
        t0 = time.perf_counter()
        progs[seed] = drv.program_readings(fam, seed, device, limits,
                                           args.seconds)
        t1 = time.perf_counter()
        refs[seed] = drv.reference_readings(fam, seed, device, limits,
                                            progs[seed])
        t2 = time.perf_counter()
        nums = drv.numbers(progs[seed], refs[seed])
        out["sound"][seed] = {**nums, "program": stored(progs[seed]),
                              "reference": stored(refs[seed])}
        out["seconds"][seed] = {"program": t1 - t0, "reference": t2 - t1}
        print(seed, floats(nums), f"program {t1 - t0:.1f} s, reference "
              f"{t2 - t1:.1f} s", flush=True)
        save()
    for seed in seeds[:args.control]:
        t0 = time.perf_counter()
        got = drv.reference_readings(fam, seed, device, limits, progs[seed],
                                     control=True)
        nums = drv.numbers(got, refs[seed])
        out["control"][seed] = {**nums, "readings": stored(got)}
        print("control", seed, floats(nums),
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        save()
    for item in filter(None, args.faults.split(",")):
        name, count = item.split(":")
        out["faults"][name] = {}
        for seed in seeds[:int(count)]:
            with FAULTS[s["mix"]["driver"]][name]():
                got = drv.program_readings(fam, seed, device, limits,
                                           args.seconds)
            nums = drv.numbers(got, refs[seed])
            out["faults"][name][seed] = {**nums, "readings": stored(got)}
            print(name, seed, floats(nums), flush=True)
            save()
    keys = list(floats(next(iter(out["sound"].values()))))
    out["lower"] = {k: max(r[k] for r in out["sound"].values()) for k in keys}
    out["control_least"] = {k: min(r[k] for r in out["control"].values())
                            for k in keys} if out["control"] else {}
    out["fault_least"] = {f: {k: min(r[k] for r in v.values()) for k in keys}
                          for f, v in out["faults"].items() if v}
    save()
    print(json.dumps({k: out[k] for k in ("lower", "control_least",
                                          "fault_least")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
