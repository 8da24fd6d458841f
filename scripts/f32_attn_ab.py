#!/usr/bin/env python3
"""Time the port's two f32 flash-attention routes from two checkouts of the
repository in turns on one CUDA card, so that two versions of the kernels
are compared on the same card and host.

    python3 scripts/f32_attn_ab.py OLD_TREE NEW_TREE [--out PATH]
    python3 scripts/f32_attn_ab.py --check TREE

Runs OLD, NEW, NEW, OLD, each in a process of its own started in that
tree, which builds the tree's kernels and times (CUDA events, the tree's
``chip_smoke.cuda_ms``) the forward ``flash_attention`` route at the serve
shape (32 heads over 8, S 1,012, D 64), the deployment shape (S 4,096) and
the REDUCED configs' shapes (8 over 2 and 4 over 4, S 517, D 8 and 16),
all f32 and causal, and bf16 at serve and deployment (the route's old/new
ratio beside the wgmma kernel); and the backward ``flash_attention_backward``
route at f32 D 64 (32 over 8, S 1,024) and the REDUCED shapes.  Every
f32 result is held to a float64 reference within ``chip_smoke.F32_TOL``
(at D 64 and S 1,024 the plain f32 version's own error takes most of
that limit), with its ratio to ``chip_smoke``'s check against the plain
version beside it; bf16 results are held by that check.  The first NEW
run also times the plain versions, ``scaled_dot_product_attention`` (K/V
expanded outside its timing) and its backward, and names their kernels
and the backward's own from the profiler.  ``--check`` runs TREE once
with the compiler's register report and more shapes (S 1, 37, 129, 200;
D 8 to 128; GQA; non-causal; (B, S, H, D) views), checked, not timed.
Prints the card's name and power limit, then one JSON line per run;
compare the runs of one call only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# 3xTF32: three products at the H100's dense TF32 rate, 495 TFLOP/s
F32_TC_OPS_PER_S = 495e12 / 3

CHILD = r"""
import json, sys
import torch
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_backward_plain, flash_attention_plain)

MODE = sys.argv[1]           # "time", "yardstick" (time + SDPA) or "check"
F32_TC_OPS_PER_S = float(sys.argv[2])
sys.path.insert(0, sys.argv[3])  # this script's directory
from tf32_variants import reference64, register_report
if MODE == "check":  # the register report of the two routes' kernels
    import contextlib, io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cuda_lib.build(verbose=True)
    print("\n".join(register_report(buf.getvalue())), file=sys.stderr)
    if "error" in buf.getvalue():
        print(buf.getvalue()[-6000:], file=sys.stderr)
cuda_lib.build()
dev = torch.device("cuda")
f32, bf = torch.float32, torch.bfloat16
FWD = {  # name: (B, H, Hkv, S, D), dtype, causal, views
    "serve_f32": ((1, 32, 8, 1012, 64), f32, True, False),
    "deploy_f32": ((1, 32, 8, 4096, 64), f32, True, False),
    "reduced_d8_f32": ((2, 8, 2, 517, 8), f32, True, False),
    "reduced_d16_f32": ((2, 4, 4, 517, 16), f32, True, False),
    "serve_bf16": ((1, 32, 8, 1012, 64), bf, True, False),
    "deploy_bf16": ((1, 32, 8, 4096, 64), bf, True, False),
}
BWD = {
    "d64_f32": ((1, 32, 8, 1024, 64), f32, True, False),
    "reduced_d8_f32": ((2, 8, 2, 517, 8), f32, True, False),
    "reduced_d16_f32": ((2, 4, 4, 517, 16), f32, True, False),
}
if MODE == "check":
    for S in (1, 37, 129, 200):
        for D in (8, 16, 32, 64, 128):
            FWD[f"s{S}_d{D}_f32"] = ((1, 4, 1, S, D), f32, S != 37, False)
            BWD[f"s{S}_d{D}_f32"] = ((1, 4, 1, S, D), f32, S != 37, False)
    for D in (8, 16, 32):
        FWD[f"s129_d{D}_bf16"] = ((2, 4, 2, 129, D), bf, True, False)
        BWD[f"s129_d{D}_bf16"] = ((2, 4, 2, 129, D), bf, True, False)
    FWD["d128_f32"] = ((1, 16, 16, 1023, 128), f32, True, False)
    BWD["d128_f32"] = ((1, 16, 4, 1023, 128), f32, True, False)
    FWD["noncausal_views_f32"] = ((2, 8, 2, 1000, 64), f32, False, True)
    BWD["noncausal_views_f32"] = ((2, 8, 2, 1000, 64), f32, False, True)
    BWD["views_d16_f32"] = ((2, 8, 2, 300, 16), f32, True, True)


def kernel_names(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t > 0:
            rows.append((e.key, t / 1e3))
    return sorted(rows, key=lambda r: -r[1])[:4]


def bound(flops, nbytes, dtype):
    rate = cs.BF16_OPS_PER_S if dtype == bf else F32_TC_OPS_PER_S
    return max(flops / rate, nbytes / cs.HBM_BYTES_PER_S) * 1e3


result = {"forward": {}, "backward": {}}
gen = torch.Generator(device=dev).manual_seed(7)
for name, (shape, dtype, causal, views) in FWD.items():
    B, H, Hkv, S, D = shape
    q, k, v = cs.flash_inputs(B, H, Hkv, S, D, dtype, gen, dev, views)
    got, got_lse = fk.run_kernel(fk.FLASH_ATTENTION, q, k, v, causal,
                                 return_lse=True)
    plain, plain_lse = flash_attention_plain(q, k, v, causal, True)
    check = cs.attention_check(got, plain)
    lse = cs.lse_check(got_lse, plain_lse)
    pairs = S * (S + 1) / 2 if causal else S * S
    flops = 4 * B * H * D * pairs
    nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * q.element_size()
    row = {"max_abs_err": check["max_abs_err"],
           "check_ratio": check["max_err_ratio"],
           "correct": check["within_tolerance"] and lse["within_tolerance"],
           "bound_ms": bound(flops, nbytes, dtype)}
    if dtype == f32:
        err = (got.double() - reference64(q, k, v, None, causal)[0]).abs()
        row["err64"] = float(err.max())
        row["correct"] = row["err64"] <= cs.F32_TOL and \
            lse["within_tolerance"]
    if MODE != "check":
        row["ms"] = cs.cuda_ms(lambda: fk.run_kernel(fk.FLASH_ATTENTION, q, k,
                                                      v, causal))
    if MODE == "yardstick":
        ke = k.repeat_interleave(H // Hkv, dim=1)
        ve = v.repeat_interleave(H // Hkv, dim=1)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, ke, ve, is_causal=causal)
        row["sdpa_ms"] = cs.cuda_ms(sdpa)
        row["plain_ms"] = cs.cuda_ms(
            lambda: flash_attention_plain(q, k, v, causal))
        row["sdpa_kernels"] = kernel_names(sdpa)
    result["forward"][name] = row
    print(name, json.dumps(row), file=sys.stderr, flush=True)
    del q, k, v, got, plain
    torch.cuda.empty_cache()
for name, (shape, dtype, causal, views) in BWD.items():
    B, H, Hkv, S, D = shape
    q, k, v = cs.flash_inputs(B, H, Hkv, S, D, dtype, gen, dev, views)
    do = cs.flash_inputs(B, H, H, S, D, dtype, gen, dev, views)[0]
    out, lse = fk.run_kernel(fk.FLASH_ATTENTION, q, k, v, causal,
                             return_lse=True)
    kern = fk.FLASH_ATTENTION_BACKWARD
    call = lambda: fk.run_backward(kern, q, k, v, out, lse, do, causal)
    got, again = call(), call()
    plain = flash_attention_backward_plain(q, k, v, do, causal, out=out)
    check = cs.backward_check(got, plain)
    pairs = S * (S + 1) / 2 if causal else S * S
    flops = 5 * 2 * B * H * D * pairs
    nbytes = 4 * (B * H + B * Hkv) * S * D * q.element_size() + 4 * B * H * S
    row = {"max_abs_err": max(check[g]["max_abs_err"] for g in cs.GRADS),
           "check_ratio": {g: check[g]["max_err_ratio"] for g in cs.GRADS},
           "correct": check["within_tolerance"],
           "bit_identical_rerun": all(
               torch.equal(a, b) for a, b in zip(got, again)),
           "bound_ms": bound(flops, nbytes, dtype)}
    if dtype == f32:
        grads = reference64(q, k, v, do, causal)[1]
        row["err64"] = {g: float((x.double() - r).abs().max())
                        for g, x, r in zip(cs.GRADS, got, grads)}
        row["correct"] = max(row["err64"].values()) <= cs.F32_TOL
        del grads
    if MODE != "check":
        row["ms"] = cs.cuda_ms(call)
    if MODE == "yardstick":
        ke = k.repeat_interleave(H // Hkv, dim=1).requires_grad_(True)
        ve = v.repeat_interleave(H // Hkv, dim=1).requires_grad_(True)
        qs = q.detach().requires_grad_(True)
        sd = torch.nn.functional.scaled_dot_product_attention(
            qs, ke, ve, is_causal=causal)
        grad = lambda: torch.autograd.grad(sd, (qs, ke, ve), do,
                                           retain_graph=True)
        row["sdpa_ms"] = cs.cuda_ms(grad)
        row["plain_ms"] = cs.cuda_ms(lambda: flash_attention_backward_plain(
            q, k, v, do, causal, out=out), reps=5)
        row["sdpa_kernels"] = kernel_names(grad)
        row["kernels_ms"] = kernel_names(call)
    result["backward"][name] = row
    print(name, json.dumps(row), file=sys.stderr, flush=True)
    del q, k, v, do, out, lse, got, again, plain
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(result))
"""


def run(tree: Path, mode: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, mode, str(F32_TC_OPS_PER_S),
         str(Path(__file__).resolve().parent)], cwd=tree,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=900)
    if mode == "check":
        print(proc.stderr[-16000:])
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(
        f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")


def correct(result: dict) -> bool:
    return all(row["correct"] and row.get("bit_identical_rerun", True)
               for part in ("forward", "backward")
               for row in result[part].values())


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", type=Path, nargs="+",
                    help="OLD NEW, or the one TREE of --check")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--out", default=None, help="also write the runs here")
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    runs = [{"smi": smi.strip()}]
    if args.check:
        turns = (("check", args.trees[0], "check"),)
    else:
        old, new = args.trees
        turns = (("old", old, "time"), ("new", new, "yardstick"),
                 ("new", new, "time"), ("old", old, "time"))
    for tag, tree, mode in turns:
        result = {"tree": tag, **run(tree.resolve(), mode)}
        print(json.dumps(result), flush=True)
        runs.append(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))
    failed = [r["tree"] for r in runs[1:] if not correct(r)]
    if failed:
        print(f"f32_attn_ab: a case disagreed in {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
