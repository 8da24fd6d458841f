#!/usr/bin/env python3
"""Time the port's varint decode from two checkouts of the repository in
turns on one CUDA card, so that two versions of the kernel and its
wrapper are compared on the same card and host.

    python3 scripts/varint_ab.py OLD_TREE NEW_TREE [--out PATH]

Runs OLD, NEW, NEW, OLD, each in a process of its own started in that
tree, which times its ``varint_decode`` (CUDA events over 20 calls, and
the kernel's and all device time under ``torch.profiler``) at three
shapes: 2^24 postings (49.8 MB, 12,288 tiles), 200,000 varints of 5 to 10
bytes (1.5 MB, 367 tiles) and a search chunk (4,096 B, 3,848 values, one
tile).  At the search chunk it also times, on the host and with events:
``torch.empty`` of the output; the launch path ``CudaKernel.launch`` had
before it skipped the current device's context (a ``torch.cuda.device``
context and a ``torch.cuda.Stream`` lookup on every call); and
``index_add_`` over the host's prepared payloads (step 3 of the decode
only), into an output made outside its timing and with its zeroing
inside.  Every decode is checked against the values encoded.  Prints one
JSON line per run; compare the runs of one call only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, time
import numpy as np, torch
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.posting_decode.kernel import (
    VARINT_DECODE, varint_decode)
from repro_torch.kernels.posting_decode.ref import byte_prep

cuda_lib.build()
dev = torch.device("cuda")
rng = np.random.RandomState(3)


def host_us(fn, calls=2000):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def timed(values):
    raw = cs.leb128_bytes(values)
    buf = torch.from_numpy(raw).to(dev)
    nv = int(np.count_nonzero(raw < 0x80))
    got = varint_decode(buf, nv)
    ok = np.array_equal(got.cpu().numpy(), values.view(np.int64))
    decode = lambda: varint_decode(buf, nv)
    return raw, buf, nv, {
        "shape": [raw.size, nv], "correct": bool(ok),
        "ms": cs.cuda_ms(decode),
        "profiler_kernel_ms": cs.profiler_ms(decode, "varint_decode"),
        "profiler_device_ms": cs.profiler_ms(decode),
    }


n = 1 << 24
vals = np.stack([rng.geometric(0.5, n) - 1, rng.randint(0, 4096, n)],
                axis=1).reshape(-1).astype(np.uint64)
result = {"deploy": timed(vals)[3]}
del vals
result["straddle"] = timed(
    cs.values_of_widths(rng.randint(5, 11, 200_000), rng))[3]
raw, buf, nv, search = timed(
    cs.values_of_widths(cs.widths_for(4096, 3848, rng), rng))

contrib, vid, _ = byte_prep(raw)
vid_t, contrib_t = (torch.from_numpy(a).to(dev) for a in (vid, contrib))
lib_out = torch.zeros(nv, dtype=torch.int64, device=dev)
index_add = lambda: lib_out.index_add_(0, vid_t, contrib_t)
fn = VARINT_DECODE._bind()
pad = [0] * (len(VARINT_DECODE.argtypes) - 4)   # null scratch: one tile


def decode_launch_before():
    out = torch.empty(nv, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fn(buf.data_ptr(), raw.size, out.data_ptr(), nv, *pad, stream):
            raise RuntimeError("varint_decode failed")
    return out


search["correct"] = search["correct"] and bool(
    torch.equal(decode_launch_before(), varint_decode(buf, nv)))
search.update({
    "ms_launch_before": cs.cuda_ms(decode_launch_before),
    "index_add_ms": cs.cuda_ms(index_add),
    "index_add_with_zeros_ms": cs.cuda_ms(lambda: torch.zeros(
        nv, dtype=torch.int64, device=dev).index_add_(0, vid_t, contrib_t)),
    "profiler_index_add_ms": cs.profiler_ms(index_add),
    "host_empty_us": host_us(
        lambda: torch.empty(nv, dtype=torch.int64, device=dev)),
    "host_varint_decode_us": host_us(lambda: varint_decode(buf, nv)),
    "host_launch_before_us": host_us(decode_launch_before),
    "host_index_add_us": host_us(index_add),
})
result["search"] = search
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
    runs = []
    for tag, tree in (("old", args.old), ("new", args.new),
                      ("new", args.new), ("old", args.old)):
        result = {"tree": tag, **run(tree.resolve())}
        print(json.dumps(result), flush=True)
        runs.append(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))
    failed = [r["tree"] for r in runs
              if not all(r[k]["correct"] for k in ("deploy", "straddle",
                                                   "search"))]
    if failed:
        print(f"varint_ab: a decode disagreed in {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
