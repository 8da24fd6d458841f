#!/usr/bin/env python3
"""Time the port's embedding-bag kernel and DLRM's forward and training
step from two checkouts of the repository in turns on one CUDA card, so
that two versions are compared on the same card and host; and, with
``--variants``, edited builds of this tree's bag kernel side by side.

    python3 scripts/bag_ab.py OLD_TREE NEW_TREE [--variants EDITS.json]
        [--sections kernels,e2e,train] [--out PATH]

Runs OLD, NEW, NEW, OLD, each in a process of its own started in that
tree, over DLRM-MLPerf's 26 tables at the published config (seeded,
45.6 GB in bf16).  Each run times (CUDA events over 20 calls):

* ``kernels``: the one-table bag at DLRM's serve launch (t0, B 262,144,
  K 1, w 1, both id rules) and over a 20M x 128 f32 table, the
  deployment launch (t19 and the f32 table, K 8), DIN's widths (1M x 18,
  B 16,384, K 100), and the 26 tables at ``serve_bulk``'s batch: one
  grouped launch where the tree has ``embedding_bags`` (over the (B, 26)
  ids with a bag stride of 26, as DLRM's forward passes them, and over a
  transposed copy), else the 26 one-table launches the forward made;
  every result held to the plain version by ``chip_smoke.bag_check``,
  and each time also read from the profiler as the kernels' own device
  time (``kernel_ms``), which host time between calls does not reach;
* ``e2e``: ``dlrm_forward`` as ``chip_smoke.py``'s recsys serve phase
  drives it (``serve_p99`` 200 calls of 512, ``serve_bulk`` 10 of
  262,144, ``retrieval_cand`` 5 of 1M candidates; host clock around
  synchronised calls), a profiled forward of each serve cell, and the
  SHA-256 of the scores of two fixed batches, which must agree between
  the trees;
* ``train``: DLRM with tables capped at 2^22 rows through ``Trainer``,
  3 warm-up and 10 timed steps of 65,536.

``--variants`` maps a variant's name to a list of ``[old, new]`` text
edits of ``src/repro_torch/csrc/embedding_bag.cu`` (``[]``: the source
as it stands); each is compiled by its own ``nvcc`` with ``-Xptxas -v``
(the kernels' registers and spills are printed) and, twice in turns,
timed at the kernel cases in NEW's tree.  Prints the card's name and
power limit, then one JSON line per run; compare the runs of one call
only.  Exits 1 if a result disagrees with its plain version or the
trees' scores differ.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import ctypes, dataclasses, hashlib, json, subprocess, sys, tempfile, threading, time
from pathlib import Path
import torch
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.configs.registry import get_serving, get_training
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.embedding_bag import kernel as bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_fixed_plain

sections = set(sys.argv[1].split(","))
variants = json.loads(sys.argv[2]) if len(sys.argv) > 2 else None
cuda_lib.build()
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
grouped = hasattr(bag, "embedding_bags")
sv = get_serving("dlrm-mlperf")
cfg = sv.config
params = sv.init(cfg, torch.Generator(device=dev).manual_seed(0))
tables = [t["table"] for t in params["tables"].values()]
B = 262_144


# the profiler's device time of the bag kernels a call of fn launches;
# each call's output is freed before the next
def kernel_ms(fn):
    return cs.profiler_ms(lambda: (fn(), None)[1], match="embedding_bag")


def case(table, ids, w, rules=("clip", "fill")):
    out = {}
    for rule in rules:
        got = bag.embedding_bag_fixed(table, ids, w, id_rule=rule)
        check = cs.bag_check(got, embedding_bag_fixed_plain(table, ids, w,
                                                            id_rule=rule))
        run = lambda: bag.embedding_bag_fixed(table, ids, w, id_rule=rule)
        out[rule] = {"ms": cs.cuda_ms(run),
                     "kernel_ms": kernel_ms(run),
                     "correct": check["within_tolerance"]}
        del got
    return out


def group_case():
    gen = torch.Generator(device=dev).manual_seed(9)
    sparse = torch.stack([cs.bag_ids(t.shape[0], B, 1, gen, dev)[:, 0]
                          for t in tables], 1)
    cols = sparse.t().contiguous()
    ones = torch.ones((B, 1), device=dev)
    per_table = lambda: [bag.embedding_bag_fixed(t, cols[i, :, None], ones,
                                                 id_rule="fill")
                         for i, t in enumerate(tables)]
    out = {"per_table_ms": cs.cuda_ms(per_table),
           "per_table_kernel_ms": kernel_ms(per_table)}
    if grouped:
        ids = sparse.t()[..., None]
        w = torch.ones((1, 1, 1), device=dev).expand(len(tables), B, 1)
        run = lambda: bag.embedding_bags(tables, ids, w, "fill")
        got = run()
        outs = [got[:, i] for i in range(len(tables))]
        head = torch.zeros((B, tables[0].shape[1]), dtype=tables[0].dtype,
                           device=dev)
        out["ms"] = cs.cuda_ms(run)
        out["kernel_ms"] = kernel_ms(run)
        # the same launch over a transposed copy of the ids (bag stride 1)
        out["contiguous_ids_kernel_ms"] = kernel_ms(
            lambda: bag.embedding_bags(tables, cols[..., None], w, "fill"))
        out["interaction_f32_ms"] = cs.cuda_ms(lambda: bag.embedding_bags(
            tables, ids, w, "fill", dtype=torch.float32, head=head))
        out["interaction_bf16_float_ms"] = cs.cuda_ms(
            lambda: bag.embedding_bags(tables, ids, w, "fill",
                                       head=head).float())
    else:
        outs = per_table()
        out["ms"] = out["per_table_ms"]
        out["kernel_ms"] = out["per_table_kernel_ms"]
    out["correct"] = all(
        cs.bag_check(o, embedding_bag_fixed_plain(t, cols[i, :, None], ones,
                                                  id_rule="fill"))
        ["within_tolerance"] for i, (o, t) in enumerate(zip(outs, tables)))
    return {"fill": out}


def kernel_cases(rules=("clip", "fill")):
    res = {}
    gen = torch.Generator(device=dev).manual_seed(7)
    f32 = torch.empty((20_000_000, 128), device=dev).normal_(0.0, 0.02,
                                                             generator=gen)
    for tag, pair in (("bf16", (tables[0], tables[19])), ("f32", (f32, f32))):
        for cell, table, Bc, K in (("serve", pair[0], B, 1),
                                   ("deploy", pair[1], B, 8)):
            ids = cs.bag_ids(table.shape[0], Bc, K, gen, dev)
            w = (torch.ones((Bc, K), device=dev) if K == 1 else
                 torch.rand((Bc, K), generator=gen, device=dev))
            res[f"{cell}_{tag}"] = case(table, ids, w, rules)
    del f32
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        table = torch.empty((1_000_000, 18), dtype=dtype, device=dev).normal_(
            0.0, 0.02, generator=gen)
        ids = cs.bag_ids(1_000_000, 16_384, 100, gen, dev)
        w = torch.rand((16_384, 100), generator=gen, device=dev)
        res[f"din_{tag}"] = case(table, ids, w, rules)
    res["grouped_bf16"] = group_case()
    torch.cuda.empty_cache()
    return res


def scores_sha(batch):
    s = sv.score(cfg, params, batch)
    return hashlib.sha256(s.float().cpu().numpy().tobytes()).hexdigest()[:16]


result = {"grouped_entry": grouped}
if variants:
    libs, reports = {}, {}
    def build(name, edits, work):
        csrc = work / name
        csrc.mkdir(parents=True)
        for f in cuda_lib.CSRC.iterdir():
            if f.suffix in (".cuh", ".cu"):
                (csrc / f.name).write_text(f.read_text())
        text = (csrc / "embedding_bag.cu").read_text()
        for old, new in edits:
            if old not in text:
                reports[name] = f"edit not found: {old[:60]!r}"
                return
            text = text.replace(old, new)
        (csrc / "embedding_bag.cu").write_text(text)
        objs, log = [], ""
        for f in ("embedding_bag.cu", "error_string.cu"):
            obj = csrc / (f + ".o")
            r = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS,
                                "-Xptxas", "-v", "-c", str(csrc / f), "-o",
                                str(obj)], capture_output=True, text=True)
            log += r.stdout + r.stderr
            if r.returncode:
                reports[name] = log[-3000:]
                return
            objs.append(str(obj))
        so = csrc / "lib.so"
        subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                        *objs, "-o", str(so)], check=True)
        reports[name] = [l.strip() for l in log.splitlines()
                         if "registers" in l or "spill" in l]
        libs[name] = so
    main_lib = cuda_lib.library()
    with tempfile.TemporaryDirectory() as tmp:
        threads = [threading.Thread(target=build, args=(n, e, Path(tmp)))
                   for n, e in variants.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        result["ptxas"] = reports
        for turn in range(2):
            for name, so in libs.items():
                lib = ctypes.CDLL(str(so))
                lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
                lib.repro_cuda_error_string.restype = ctypes.c_char_p
                cuda_lib._lib, bag.EMBEDDING_BAG._fn = lib, None
                result.setdefault(name, []).append(kernel_cases(("fill",)))
                print(name, json.dumps(result[name][-1]), file=sys.stderr,
                      flush=True)
        cuda_lib._lib, bag.EMBEDDING_BAG._fn = main_lib, None
if "kernels" in sections:
    result["kernels"] = kernel_cases()
if "e2e" in sections:
    sizes = sv.batch_sizes
    gen = torch.Generator(device=dev).manual_seed(21)
    for n in (sizes["serve_p99"], sizes["serve_bulk"]):
        sv.score(cfg, params, cs.recsys_batch(sv, n, gen, dev))
    e2e = {}
    for cell, calls in (("serve_p99", 200), ("serve_bulk", 10)):
        xs = []
        for _ in range(calls):
            batch = cs.recsys_batch(sv, sizes[cell], gen, dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sv.score(cfg, params, batch)
            torch.cuda.synchronize()
            xs.append(time.perf_counter() - t1)
        e2e[cell] = cs.percentiles_ms(xs)
    xs = []
    for _ in range(5):
        ret = cs.retrieval_batch(sv, sv.n_candidates, gen, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sv.retrieval(cfg, params, ret)
        torch.cuda.synchronize()
        xs.append(time.perf_counter() - t1)
    e2e["retrieval_cand"] = cs.percentiles_ms(xs)
    fixed = torch.Generator(device=dev).manual_seed(5)
    for cell in ("serve_p99", "serve_bulk"):
        batch = cs.recsys_batch(sv, sizes[cell], fixed, dev)
        e2e[cell]["scores_sha"] = scores_sha(batch)
        e2e[cell]["profile"] = cs.device_profile(
            lambda: sv.score(cfg, params, batch), top=10,
            match="embedding_bag")
    result["e2e"] = e2e
if "train" in sections:
    del params, tables
    torch.cuda.empty_cache()
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tr = get_training("dlrm-mlperf")
    rows, _ = cs.capped_rows(tr.config.table_rows, cs.TRAIN_ROW_CAP)
    tcfg = dataclasses.replace(tr.config, table_rows=rows)
    tparams = tr.init(tcfg, torch.Generator(device=dev).manual_seed(0),
                      masters=True)
    trainer = Trainer(lambda p, b: tr.loss(tcfg, p, b), tparams,
                      TrainerConfig(opt=tr.opt, log_every=1), device=dev)
    del tparams
    batches = {c: cs.train_batch(tcfg, tr.batch_size, cs.TRAIN_SEED + c, dev)
               for c in range(13)}
    xs = []
    for i in range(13):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.fit(batches.__getitem__, trainer.step_num + 1)
        torch.cuda.synchronize()
        if i >= 3:
            xs.append(time.perf_counter() - t1)
    result["train"] = {"step": cs.percentiles_ms(xs),
                       "losses": [h["loss"] for h in trainer.history]}
print("RESULT " + json.dumps(result))
"""


def run(tree: Path, sections: str, variants=None) -> dict:
    cmd = [sys.executable, "-c", CHILD, sections]
    if variants is not None:
        cmd.append(json.dumps(variants))
    proc = subprocess.run(cmd, cwd=tree, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=1500)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")


def wrong(result: dict) -> list:
    """The cases of a run that disagreed with the plain version."""
    runs = [result.get("kernels", {})] + [
        r for name, rs in result.items() if isinstance(rs, list)
        and name not in ("ptxas",) for r in rs]
    return [f"{where}/{rule}" for cases in runs for where, case in
            cases.items() for rule, c in case.items() if not c["correct"]]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--variants", type=Path, default=None,
                    help="JSON: variant name -> [[old, new], ...] edits")
    ap.add_argument("--sections", default="kernels,e2e,train",
                    help="what each tree's run times; empty: variants only")
    ap.add_argument("--out", default=None, help="also write the runs here")
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    runs = [{"smi": smi.strip()}]
    failed = []
    for tag, tree in (("old", args.old), ("new", args.new),
                      ("new", args.new), ("old", args.old)):
        if not args.sections:
            break
        result = {"tree": tag, **run(tree.resolve(), args.sections)}
        print(json.dumps(result), flush=True)
        runs.append(result)
        failed += [f"{tag}: {w}" for w in wrong(result)]
    if args.variants is not None:
        result = {"tree": "variants", **run(
            args.new.resolve(), "", json.loads(args.variants.read_text()))}
        print(json.dumps(result), flush=True)
        runs.append(result)
        failed += [f"variants: {w}" for w in wrong(result)]
    shas = {json.dumps({c: r["e2e"][c]["scores_sha"]
                        for c in ("serve_p99", "serve_bulk")})
            for r in runs[1:5] if "e2e" in r}
    if len(shas) > 1:
        failed.append(f"the trees' DLRM scores differ: {sorted(shas)}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))
    if failed:
        print(f"bag_ab: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
