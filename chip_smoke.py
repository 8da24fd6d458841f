#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the search stack on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py [--scale 1.0] [--out PATH]

Phases (any failure exits non-zero before the last line is printed):

  1. build the CUDA kernels from ``src/repro_torch/csrc`` and print the
     card's ``nvidia-smi`` name and power limit;
  2. search: build the standard world (``set2``, every ordinary index) and
     the hot-vocabulary world at ``--scale``, at 1 and 2 shards, and serve
     a 256-query batch over all four planner routes (exhaustive, top-k and
     ``rank="prox"``) plus a pooled hot top-k batch, with
     ``backend="cuda"`` and with the ``numpy`` host oracle.  Results must
     match element-wise, ``last_trace`` key for key (wall-clock keys
     aside) and per-device ``IOStats`` to the byte; both kernels' launch
     counters must rise during the ``cuda`` runs.  Prints qps and
     per-query p50/p99 latency per backend, and for each 1-shard cell
     where one cold ``cuda`` batch spends its time (device busy time
     and idle share from ``torch.profiler``, top host functions);
  3. kernels: each kernel against its plain PyTorch version on the card,
     bit for bit, at the largest shape the search phase gave it and at
     deployment size (2^24 postings varint-encoded; two sorted 2^24-id
     lists), timed with CUDA events beside its bound and the one-call
     PyTorch yardstick;
  4. print the kernels line, then the result line.

Exits with code 2 when no CUDA device is present.  Imports nothing of
JAX or of the ``repro`` package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the 32-bit rate
# outside the tensor cores (used for integer compares and adds)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

WALL_CLOCK_KEYS = ("shard_fetch_s", "query_s", "busy_s")
N_QUERIES = 256
N_HOT_QUERIES = 64
TOP_K = 10
DEPLOY_N = 1 << 24


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------- queries --
def words_of_class(lex, cls, n: int = 12) -> List[int]:
    out = []
    for w in range(lex.n_words):
        l1 = lex.lemma1[w]
        if l1 >= 0 and lex.lemma_class[l1] == cls:
            out.append(int(w))
            if len(out) == n:
                break
    return out


def standard_queries(world, Query, rng) -> list:
    """256 queries over all four routes: exhaustive proximity and phrase
    queries, then fresh draws as doc-id top-k and ranked top-k."""
    from repro_torch.core.lexicon import FREQUENT, OTHER, STOP

    lex = world.lexicon
    stop = words_of_class(lex, STOP)
    freq = words_of_class(lex, FREQUENT)
    other = words_of_class(lex, OTHER)
    toks = world.parts[0][0]

    def draw(i: int):
        kind = i % 5
        if kind == 0:
            return (int(rng.choice(stop)), int(rng.choice(stop))), False
        if kind == 1:
            return tuple(int(w) for w in rng.choice(stop, 3)), False
        if kind == 2:
            return (int(rng.choice(freq)), int(rng.choice(other))), False
        if kind == 3:
            return tuple(int(w) for w in
                         rng.choice(other, rng.randint(2, 4), replace=False)), False
        n = int(rng.randint(3, 6))
        s = int(rng.randint(0, toks.shape[0] - n))
        return tuple(int(t) for t in toks[s:s + n]), True

    qs = []
    for i in range(N_QUERIES):
        words, phrase = draw(i)
        if i < 96:
            qs.append(Query(words, phrase=phrase))
        elif i < 192:
            qs.append(Query(words, phrase=phrase, top_k=TOP_K))
        else:
            qs.append(Query(words, phrase=phrase, top_k=TOP_K, rank="prox"))
    return qs


def hot_queries(world, Query, rng, k: int) -> list:
    """Hot-vocabulary top-k phrases cycling 8 distinct phrases, so the
    chunk pool shares drains; every third query is ranked."""
    toks = world.parts[0][0]
    distinct = []
    while len(distinct) < 8:
        s = int(rng.randint(0, toks.shape[0] - k))
        distinct.append(tuple(int(t) for t in toks[s:s + k]))
    return [
        Query(distinct[i % 8], phrase=True, top_k=TOP_K,
              rank="prox" if i % 3 == 0 else None)
        for i in range(N_HOT_QUERIES)
    ]


# -------------------------------------------------------------- search --
def device_io(substrate) -> List[Dict[str, Dict[str, int]]]:
    per_shard = (substrate.search_io_per_shard()
                 if hasattr(substrate, "search_io_per_shard")
                 else [substrate.search_io()])
    return [{name: dataclasses.asdict(st) for name, st in shard.items()}
            for shard in per_shard]


def io_delta(before, after):
    return [
        {name: {f: after[s][name][f] - before[s][name][f]
                for f in after[s][name]}
         for name in after[s]}
        for s in range(len(after))
    ]


def strip_wall_clock(trace):
    if isinstance(trace, dict):
        return {k: strip_wall_clock(v) for k, v in trace.items()
                if k not in WALL_CLOCK_KEYS}
    return trace


def same_results(ref, got) -> List[str]:
    bad = []
    for i, (r, g) in enumerate(zip(ref, got)):
        ok = (r.route == g.route
              and np.array_equal(r.docs, g.docs)
              and np.array_equal(r.witnesses, g.witnesses)
              and r.lookups == g.lookups
              and r.postings_scanned == g.postings_scanned
              and (r.scores is None) == (g.scores is None)
              and (r.scores is None or np.array_equal(r.scores, g.scores)))
        if not ok:
            bad.append(f"query {i}")
    if len(ref) != len(got):
        bad.append(f"{len(ref)} vs {len(got)} results")
    return bad


def serve(substrate, queries, backend: str, device) -> dict:
    """One cold batch (parity), then warm passes (qps) and single-query
    batches (latency) on the same service."""
    from repro_torch.search import SearchService

    # the numpy oracle keeps the int32 device tier (device_decode=True
    # with a host decoder) so cache charges, evictions and therefore
    # reads match the cuda run's exactly
    svc = SearchService(substrate, window=3, backend=backend, device=device,
                        device_decode=True)
    io0 = device_io(substrate)
    res = svc.search_batch(queries)
    out = {"results": res, "trace": strip_wall_clock(svc.last_trace),
           "io": io_delta(io0, device_io(substrate))}
    if device.type == "cuda":
        torch.cuda.synchronize()
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        svc.search_batch(queries)
        warm.append(time.perf_counter() - t0)
    lat = []
    for q in queries:
        t0 = time.perf_counter()
        svc.search_batch([q])
        lat.append(time.perf_counter() - t0)
    out["qps"] = len(queries) / float(np.median(warm))
    out["p50_ms"] = float(np.percentile(lat, 50)) * 1e3
    out["p99_ms"] = float(np.percentile(lat, 99)) * 1e3
    return out


def profile_cell(substrate, queries, device) -> dict:
    """Where one cold ``cuda`` batch spends its time: device busy time
    against wall time from ``torch.profiler`` (the device's idle share),
    the top device kernels, and the top host functions from cProfile."""
    import cProfile
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.search import SearchService

    def fresh():
        return SearchService(substrate, window=3, backend="cuda",
                             device=device)

    svc = fresh()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.search_batch(queries)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [
        (e.key, e.count, e.self_device_time_total)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_us = sum(k[2] for k in kernels)
    kernels.sort(key=lambda k: -k[2])

    svc = fresh()
    prof_host = cProfile.Profile()
    prof_host.enable()
    svc.search_batch(queries)
    prof_host.disable()
    stats = pstats.Stats(prof_host).stats
    host = sorted(
        ((f"{Path(fn[0]).name}:{fn[2]}", cc, tt)
         for fn, (cc, nc, tt, ct, callers) in stats.items()),
        key=lambda h: -h[2])[:10]
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "device_kernels": [
            {"name": n[:60], "count": c, "ms": us / 1e3}
            for n, c, us in kernels[:6]],
        "host_tottime": [
            {"fn": n, "calls": c, "s": t} for n, c, t in host],
    }


def search_phase(scale: float, device, kernels) -> dict:
    from repro_torch.data.world import (
        HOT_GEOMETRY, build_index_set, build_sharded_index_set,
        make_hot_world, make_world,
    )
    from repro_torch.search import Query

    t0 = time.perf_counter()
    world = make_world(scale)
    hot = make_hot_world(scale)
    std_q = standard_queries(world, Query, np.random.RandomState(7))
    hot_q = hot_queries(hot, Query, np.random.RandomState(17), k=3)
    log(f"search: worlds of {world.total_tokens} and {hot.total_tokens} "
        f"tokens, {len(std_q)} + {len(hot_q)} queries")

    for k in kernels:
        k.launches = 0
        k.largest = None
    report: Dict[str, object] = {"cells": []}
    failures: List[str] = []
    single = {}
    for n_shards in (1, 2):
        tb = time.perf_counter()
        if n_shards == 1:
            std = build_index_set(world, "set2", build_ordinary_all=True)
            hs = build_index_set(hot, "set2", **HOT_GEOMETRY)
        else:
            std = build_sharded_index_set(world, "set2", n_shards,
                                          build_ordinary_all=True)
            hs = build_sharded_index_set(hot, "set2", n_shards,
                                         **HOT_GEOMETRY)
        build_s = time.perf_counter() - tb
        for name, sub, qs in (("standard", std, std_q), ("hot", hs, hot_q)):
            if n_shards == 1:
                single[name] = (sub, qs)
            runs = {b: serve(sub, qs, b, device) for b in ("numpy", "cuda")}
            ref, got = runs["numpy"], runs["cuda"]
            routes = sorted({r.route for r in ref["results"]})
            bad = same_results(ref["results"], got["results"])
            if ref["trace"] != got["trace"]:
                bad.append("last_trace differs")
            if ref["io"] != got["io"]:
                bad.append("per-device IOStats differ")
            read_bytes = sum(d["read_bytes"] for shard in got["io"]
                             for d in shard.values())
            cell = {"world": name, "shards": n_shards, "queries": len(qs),
                    "routes": routes, "build_s": build_s,
                    "read_bytes": read_bytes, "match": not bad}
            for b, r in runs.items():
                cell[b] = {k: r[k] for k in ("qps", "p50_ms", "p99_ms")}
            report["cells"].append(cell)
            log("search: " + json.dumps(cell))
            failures += [f"{name} x{n_shards}: {b}" for b in bad]
    report["launches"] = {k.symbol: k.launches for k in kernels}
    report["largest"] = {k.symbol: k.largest for k in kernels}
    report["seconds"] = time.perf_counter() - t0
    # after the launch counts are read: profiling runs do not count
    report["profile"] = {}
    for name, (sub, qs) in single.items():
        report["profile"][name] = profile_cell(sub, qs, device)
        log(f"profile {name}: " + json.dumps(report["profile"][name]))
    for k in kernels:
        if k.launches == 0:
            failures.append(f"{k.symbol} was never launched by the search")
    if not any(set(c["routes"]) >= {"ordinary", "stopseq", "wv", "multi"}
               for c in report["cells"]):
        failures.append("no batch covered all four routes")
    report["failures"] = failures
    return report


# ------------------------------------------------------------- kernels --
def cuda_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def encode_varints(values: torch.Tensor):
    """Byte-parallel form of the LEB128 encoding of ``values`` (int64 >= 0)
    on their device: per-byte sorted value ids and shifted payloads, as
    ``byte_prep`` yields them from the bytes."""
    widths = torch.ones_like(values)
    for k in range(1, 9):
        widths += (values >= (1 << (7 * k))).to(torch.int64)
    vid = torch.repeat_interleave(
        torch.arange(values.numel(), device=values.device), widths)
    starts = torch.cumsum(widths, 0) - widths
    rank = torch.arange(vid.numel(), device=values.device) - starts[vid]
    shift = 7 * rank
    contrib = ((values[vid] >> shift) & 0x7F) << shift
    return vid, contrib


def widths_for(n_bytes: int, n_values: int, rng) -> np.ndarray:
    """Varint widths (1..5) summing to exactly ``n_bytes``."""
    widths = np.ones(n_values, dtype=np.int64)
    extra = n_bytes - n_values
    while extra > 0:
        idx = rng.randint(0, n_values, size=extra)
        np.add.at(widths, idx, 1)
        over = np.maximum(widths - 5, 0)
        widths -= over
        extra = int(over.sum())
    return widths


def values_with_widths(widths: np.ndarray, rng) -> np.ndarray:
    lo = np.where(widths == 1, 0, 1 << (7 * (widths - 1)))
    hi = 1 << (7 * widths)
    return lo + (rng.random_sample(widths.shape[0]) * (hi - lo)).astype(np.int64)


def segment_sum_case(vid, contrib, n_values, expect=None) -> dict:
    from repro_torch.kernels.posting_decode.kernel import (
        varint_segment_sum, varint_segment_sum_plain,
    )

    got = varint_segment_sum(vid, contrib, n_values)
    plain = varint_segment_sum_plain(vid, contrib, n_values)
    torch.cuda.synchronize()
    ok = bool(torch.equal(got, plain))
    if expect is not None:
        ok = ok and bool(torch.equal(got, expect))
    m = vid.numel()
    lib_out = torch.zeros(n_values, dtype=torch.int64, device=vid.device)
    return {
        "shape": [m, n_values],
        "bit_identical": ok,
        "max_abs_err": int((got - plain).abs().max()) if n_values else 0,
        "ms": cuda_ms(lambda: varint_segment_sum(vid, contrib, n_values)),
        "plain_ms": cuda_ms(
            lambda: varint_segment_sum_plain(vid, contrib, n_values)),
        "library_ms": cuda_ms(lambda: lib_out.index_add_(0, vid, contrib)),
        "bound_ms": max((16 * m + 8 * n_values) / HBM_BYTES_PER_S,
                        m / SCALAR_OPS_PER_S) * 1e3,
        "bound_by": "bytes",
    }


def member_mask_case(a, b) -> dict:
    from repro_torch.kernels.intersect.kernel import (
        sorted_member_mask, sorted_member_mask_plain,
    )

    got = sorted_member_mask(a, b)
    plain = sorted_member_mask_plain(a, b)
    lib = torch.isin(a, b)
    torch.cuda.synchronize()
    n, m = a.numel(), b.numel()
    ops = n * max(1, int(np.ceil(np.log2(max(m, 2)))))
    return {
        "shape": [n, m],
        "bit_identical": bool(torch.equal(got, plain))
        and bool(torch.equal(got, lib)),
        "max_abs_err": int((got.int() - plain.int()).abs().max()) if n else 0,
        "ms": cuda_ms(lambda: sorted_member_mask(a, b)),
        "plain_ms": cuda_ms(lambda: sorted_member_mask_plain(a, b)),
        "library_ms": cuda_ms(lambda: torch.isin(a, b)),
        "bound_ms": max((8 * n + 8 * m + n) / HBM_BYTES_PER_S,
                        ops / SCALAR_OPS_PER_S) * 1e3,
        "bound_by": "bytes" if (8 * n + 8 * m + n) / HBM_BYTES_PER_S
        >= ops / SCALAR_OPS_PER_S else "operations",
    }


def sorted_ids(n: int, hi: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` distinct sorted ids drawn from [0, hi)."""
    ids = torch.randperm(hi, generator=gen, device="cpu")[:n]
    return torch.sort(ids).values.to(device)


def kernel_phase(largest: dict, device) -> Dict[str, dict]:
    rng = np.random.RandomState(3)
    gen = torch.Generator().manual_seed(5)
    out: Dict[str, dict] = {}

    # varint_segment_sum at the largest search shape, then 2^24 postings
    # a kernel the search never launched has failed already; it is
    # still checked, at a small shape
    m, n_values = largest["varint_segment_sum"] or (4096, 2048)
    values = values_with_widths(widths_for(m, n_values, rng), rng)
    vid, contrib = encode_varints(torch.tensor(values, device=device))
    assert vid.numel() == m, (vid.numel(), m)
    search = segment_sum_case(vid, contrib, n_values,
                              expect=torch.tensor(values, device=device))
    docs_delta = torch.tensor(rng.geometric(0.5, DEPLOY_N) - 1, device=device)
    pos = torch.tensor(rng.randint(0, 4096, DEPLOY_N), device=device)
    vals = torch.stack([docs_delta, pos], dim=1).reshape(-1)
    vid, contrib = encode_varints(vals)
    deploy = segment_sum_case(vid, contrib, vals.numel(), expect=vals)
    deploy["stream_bytes"] = vid.numel()
    out["varint_segment_sum"] = {"search": search, "deploy": deploy}
    del vid, contrib, vals

    # sorted_member_mask at the largest search shape, then 2^24 x 2^24
    n, m = largest["sorted_member_mask"] or (4096, 4096)
    a = sorted_ids(n, 4 * max(n, m), gen, device)
    b = sorted_ids(m, 4 * max(n, m), gen, device)
    search = member_mask_case(a, b)
    a = sorted_ids(DEPLOY_N, 4 * DEPLOY_N, gen, device)
    b = sorted_ids(DEPLOY_N, 4 * DEPLOY_N, gen, device)
    deploy = member_mask_case(a, b)
    out["sorted_member_mask"] = {"search": search, "deploy": deploy}
    return out


# ---------------------------------------------------------------- main --
def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def main(argv: Sequence[str] = ()) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="world scale (1.0: about 0.84M tokens)")
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.intersect.kernel import SORTED_MEMBER_MASK
    from repro_torch.kernels.posting_decode.kernel import VARINT_SEGMENT_SUM

    device = torch.device("cuda")
    kernels = (VARINT_SEGMENT_SUM, SORTED_MEMBER_MASK)
    t0 = time.perf_counter()
    lib = cuda_lib.build(verbose=True)
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    search = search_phase(args.scale, device, kernels)
    log(f"search: {search['seconds']:.1f} s, launches {search['launches']}")
    checks = kernel_phase(search["largest"], device)
    failures = list(search["failures"])
    for name, cases in checks.items():
        for where, case in cases.items():
            log(f"kernel {name} {where}: " + json.dumps(case))
            if not case["bit_identical"]:
                failures.append(f"{name} disagrees with its plain version "
                                f"at {where} shape {case['shape']}")

    line = {"kernels": [
        {
            "name": k.symbol,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": search["launches"][k.symbol],
            "max_abs_err": checks[k.symbol]["search"]["max_abs_err"],
            "ms": checks[k.symbol]["search"]["ms"],
            "plain_ms": checks[k.symbol]["search"]["plain_ms"],
            "bound_ms": checks[k.symbol]["search"]["bound_ms"],
            "bound_by": checks[k.symbol]["search"]["bound_by"],
            "library_ms": checks[k.symbol]["search"]["library_ms"],
            "shape": checks[k.symbol]["search"]["shape"],
            "bit_identical": all(c["bit_identical"]
                                 for c in checks[k.symbol].values()),
            "deploy": checks[k.symbol]["deploy"],
        }
        for k in kernels
    ]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"smi": smi, "search": {k: v for k, v in search.items()
                                    if k != "failures"},
             "kernels": line["kernels"], "failures": failures}, indent=1))
    if failures:
        for f in failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1
    log(smi)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
