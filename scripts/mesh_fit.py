#!/usr/bin/env python3
"""How large a recsys train step of ``chip_smoke.py``'s mesh phase fits
one CUDA card: ``chip_smoke.mesh_recsys_step`` (the unsharded step, then
the one-rank NCCL mesh step, one trainer on the card at a time) at each
``ARCH:BATCH[:USERS]`` given, each in a process of its own, in turn.

    python3 scripts/mesh_fit.py two-tower-retrieval:65536 \\
        two-tower-retrieval:32768 two-tower-retrieval:32768:4194304 \\
        [--out build/mesh_fit.json]

``USERS`` sets two-tower's user rows (``chip_smoke.MESH_TWO_TOWER_USERS``
by default, its published 10,000,000 at most).  Prints one line a case:
its steps' peaks and the comparison's verdict, or the out-of-memory
error that ended it; writes every case's report as JSON.  Exits 1 if a
case that fitted failed its checks.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OOM = "out of memory"


def one(case: str, out: str) -> int:
    """The case in this process: its report, or its out-of-memory error,
    written to ``out``."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.embedding_bag.kernel import EMBEDDING_BAG
    from repro_torch.launch.mesh import make_host_mesh

    arch, batch, *users = case.split(":")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    if arch == "dlrm-mlperf":
        cuda_lib.build()
    failures: list = []
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, device_id=torch.device(
                "cuda", torch.cuda.current_device()))
        try:
            with cs.deterministic_algorithms():
                r = cs.mesh_recsys_step(
                    arch, make_host_mesh(), device, EMBEDDING_BAG, failures,
                    batch_size=int(batch),
                    users=int(users[0]) if users else None)
            r["failures"] = failures
        except torch.cuda.OutOfMemoryError as e:
            r = {"arch": arch, "batch": int(batch), OOM: str(e)[:400],
                 "peak_bytes": torch.cuda.max_memory_allocated(device)}
        finally:
            dist.destroy_process_group()
    r["case"], r["card"] = case, cs.smi_line()
    Path(out).write_text(json.dumps(r, indent=1, default=str))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cases", nargs="+", help="ARCH:BATCH[:USERS]")
    ap.add_argument("--out", default="build/mesh_fit.json")
    ap.add_argument("--one", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        return one(args.cases[0], args.one)
    import torch
    if not torch.cuda.is_available():
        print("mesh_fit: no CUDA device available", file=sys.stderr)
        return 2
    reports, bad = [], 0
    with tempfile.TemporaryDirectory() as tmp:
        for i, case in enumerate(args.cases):
            path = Path(tmp) / f"{i}.json"
            p = subprocess.run([sys.executable, __file__, case, "--one",
                                str(path)], text=True,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            if p.returncode or not path.exists():
                print(p.stdout[-3000:])
                reports.append({"case": case, "rc": p.returncode})
                bad += 1
                continue
            r = json.loads(path.read_text())
            reports.append(r)
            if OOM in r:
                print(f"{case}: out of memory (peak "
                      f"{r['peak_bytes'] / 1e9:.3f} GB before it)")
                continue
            bad += bool(r["failures"])
            print(f"{case}: cuts {r['cuts']}; unsharded peak "
                  f"{r['unsharded']['peak_bytes'] / 1e9:.3f} GB "
                  f"(step {r['unsharded']['step_peak_bytes'] / 1e9:.3f}), "
                  f"mesh peak {r['sharded']['peak_bytes'] / 1e9:.3f} GB, "
                  f"step {r['unsharded']['s']:.3f} / {r['sharded']['s']:.3f} "
                  f"s, failures {r['failures']}")
    print(reports[0].get("card", "") if reports else "")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(reports, indent=1, default=str))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
