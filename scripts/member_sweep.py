#!/usr/bin/env python3
"""Measure the two choices ``sorted_member_mask`` fixes, on one CUDA card:
the route threshold and the merge route's tile.

    python3 scripts/member_sweep.py [--out PATH]

Threshold: b of 2^24 sorted distinct keys and a of one key for each 4,
8, 16, 32, 64, 256 and 1,024 keys of b; each route (``run_member_mask``
with ``"search"`` and ``"merge"``) checked bit for bit against the plain
version and timed with CUDA events and ``torch.profiler``'s kernel time.
``kernels/intersect/kernel.py::SEARCH_RATIO`` is the least ratio from
which the search route wins.

Tile: ``csrc/sorted_member_mask.cu`` built three more times, with its
``kItems`` (merged elements a thread, 15 in the source) set to 8, 15 and
16, each its own library under ``build/member_sweep/``, and its merge
route checked and timed the same way at 2^24 in 2^24 (distinct keys and
posting docs in runs of mean 4), 2^24 in 2^14 and 4,096 segments of
4,096 in 4,096.

Prints one JSON object (and writes it to ``--out``); compare numbers of
one call only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.intersect.kernel import (  # noqa: E402
    INLINE_SEGMENTS, SORTED_MEMBER_MASK, run_member_mask,
    sorted_member_mask_segments_plain,
)

SOURCE = ROOT / SORTED_MEMBER_MASK.source
ITEMS_LINE = "constexpr int kItems = 15;"
TILE_ITEMS = (8, 15, 16)
RATIOS = (4, 8, 16, 32, 64, 256, 1024)
N = 1 << 24


def build_variants(out_dir: Path) -> dict:
    """One shared library of the source for each count in ``TILE_ITEMS``,
    all compiled together; returns each one's bound C entry."""
    text = SOURCE.read_text()
    if text.count(ITEMS_LINE) != 1:
        raise RuntimeError(f"{SOURCE} does not hold {ITEMS_LINE!r} once")
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k in TILE_ITEMS:
        src = out_dir / f"member_items_{k}.cu"
        src.write_text(text.replace(ITEMS_LINE,
                                    f"constexpr int kItems = {k};"))
        procs[k] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", str(src),
             "-o", str(out_dir / f"member_items_{k}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for k, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {k} items:\n{out}")
        lib = ctypes.CDLL(str(out_dir / f"member_items_{k}.so"))
        fn = lib.sorted_member_mask
        fn.argtypes = [*SORTED_MEMBER_MASK.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[k] = fn
    return fns


def merge_launch(fn, a, a_off, b, b_off):
    """A launch of one variant's merge route, as ``run_member_mask``
    makes it (scratch for the most tiles any variant cuts)."""
    S = a_off.size - 1
    offs = (torch.from_numpy(np.concatenate([a_off, b_off])).to(a.device)
            if S > INLINE_SEGMENTS else None)
    tiles = -(-(a.numel() + b.numel()) // (256 * min(TILE_ITEMS)))
    ranks = torch.empty(2 * (tiles + 1), dtype=torch.int64, device=a.device)
    stream = cuda_lib.stream_handle(a.device)

    def launch():
        out = torch.empty(a.shape, dtype=torch.bool, device=a.device)
        err = fn(a.data_ptr(), a.numel(), a_off.ctypes.data, b.data_ptr(),
                 b.numel(), b_off.ctypes.data,
                 offs.data_ptr() if offs is not None else None, S,
                 out.data_ptr(), ranks.data_ptr(), 1, stream)
        if err:
            raise RuntimeError(f"sorted_member_mask: CUDA error {err}")
        return out
    return launch


def timed(launch, plain) -> dict:
    return {"bit_identical": bool(torch.equal(launch(), plain)),
            "ms": cs.cuda_ms(launch),
            "profiler_kernel_ms": cs.profiler_ms(launch, "member_")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cuda_lib.build()
    fns = build_variants(cuda_lib.BUILD_DIR.parent / "member_sweep")
    rng = np.random.RandomState(13)
    one = np.array([0, N], np.int64)

    def on_card(a, a_off, b, b_off):
        a_t, b_t = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        plain = sorted_member_mask_segments_plain(a_t, a_off, b_t, b_off)
        return a_t, a_off, b_t, b_off, plain

    result = {"smi": cs.smi_line(), "threshold": {}, "tile": {}}
    _, _, b, _ = cs.member_segments([(N, N)], rng)
    for ratio in RATIOS:
        a = cs.member_ratio_keys(b, ratio, rng)
        a_t, a_off, b_t, b_off, plain = on_card(
            a, np.array([0, a.size], np.int64), b, one)
        result["threshold"][f"ratio_{ratio}"] = {
            route: timed(lambda route=route: run_member_mask(
                a_t, a_off, b_t, b_off, route), plain)
            for route in ("search", "merge")}
    shapes = {
        "deploy": ([(N, N)], 1.0),
        "posting_docs": ([(N, N)], 4.0),
        "skew_small_b": ([(N, 1 << 14)], 1.0),
        "segments_4096": ([(4096, 4096)] * 4096, 1.0),
    }
    for name, (segs, repeat) in shapes.items():
        args_ = on_card(*cs.member_segments(segs, rng, repeat_mean=repeat))
        result["tile"][name] = {
            f"items_{k}": timed(merge_launch(fn, *args_[:4]), args_[4])
            for k, fn in fns.items()}
    ok = all(r["bit_identical"] for part in ("threshold", "tile")
             for case in result[part].values() for r in case.values())
    result["ok"] = ok
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
