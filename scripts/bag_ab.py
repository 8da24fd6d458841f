#!/usr/bin/env python3
"""Time the port's embedding-bag kernel from two checkouts of the
repository in turns on one CUDA card, so that two versions of the kernel
are compared on the same card and host.

    python3 scripts/bag_ab.py OLD_TREE NEW_TREE [--out PATH]

Runs OLD, NEW, NEW, OLD, each in a process of its own started in that
tree, which times ``embedding_bag_fixed`` (CUDA events over 20 calls) at
DLRM's serve launch (table t0's 45,833,138 x 128 rows in bf16, a 20M x
128 f32 table; B 262,144, K 1, w 1) and at the deployment launch (t19's
48,937,457 rows in bf16, the f32 table; B 262,144, K 8), with ids in
range, drawn from one seed in both trees.  Where the tree's wrapper takes
an ``id_rule``, both rules are timed.  Every result is held to the tree's
plain version by ``chip_smoke.bag_check``.  Prints the card's name and
power limit, then one JSON line per run; compare the runs of one call
only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import inspect, json, sys
import torch
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.embedding_bag.kernel import embedding_bag_fixed
from repro_torch.kernels.embedding_bag.ref import embedding_bag_fixed_plain

cuda_lib.build()
dev = torch.device("cuda")
rules = ("clip", "fill") if "id_rule" in inspect.signature(
    embedding_bag_fixed).parameters else (None,)
B = 262_144
result = {}
for tag, rows, dtype in (("bf16", (45_833_138, 48_937_457), torch.bfloat16),
                         ("f32", (20_000_000, 20_000_000), torch.float32)):
    for cell, V, K in (("serve", rows[0], 1), ("deploy", rows[1], 8)):
        gen = torch.Generator(device=dev).manual_seed(7)
        table = torch.empty((V, 128), dtype=dtype, device=dev).normal_(
            0.0, 0.02, generator=gen)
        ids = torch.randint(0, V, (B, K), generator=gen, device=dev,
                            dtype=torch.int32)
        w = (torch.ones((B, K), device=dev) if K == 1 else
             torch.rand((B, K), generator=gen, device=dev))
        case = {}
        for rule in rules:
            kw = {} if rule is None else {"id_rule": rule}
            got = embedding_bag_fixed(table, ids, w, **kw)
            plain = embedding_bag_fixed_plain(table, ids, w)
            check = cs.bag_check(got, plain)
            case[rule or "clip"] = {
                "ms": cs.cuda_ms(lambda: embedding_bag_fixed(table, ids, w,
                                                             **kw)),
                "max_abs_err": check["max_abs_err"],
                "correct": check["within_tolerance"]}
            del got, plain
        result[f"{cell}_{tag}"] = case
        del table, ids, w
        torch.cuda.empty_cache()
print("RESULT " + json.dumps(result))
"""


def run(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--out", default=None, help="also write the runs here")
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    runs = [{"smi": smi.strip()}]
    for tag, tree in (("old", args.old), ("new", args.new),
                      ("new", args.new), ("old", args.old)):
        result = {"tree": tag, **run(tree.resolve())}
        print(json.dumps(result), flush=True)
        runs.append(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))
    failed = [r["tree"] for r in runs[1:]
              if not all(c["correct"] for k, v in r.items() if k != "tree"
                         for c in v.values())]
    if failed:
        print(f"bag_ab: a bag disagreed in {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
