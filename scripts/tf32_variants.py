#!/usr/bin/env python3
"""Build edited copies of the port's CUDA sources side by side and hold
the f32 flash-attention routes of each (``flash_attention`` and
``flash_attention_backward``, split-TF32 on the tensor cores) to a float64
reference on one CUDA card, so that a design choice of
``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu`` or
``csrc/tf32.cuh`` is measured against the sources as they stand, within
one call.

    python3 scripts/tf32_variants.py EDITS.json [--out PATH]

EDITS.json maps a variant's name to a list of ``[file, old, new]`` text
edits of files in ``csrc/`` (``[]`` is the sources unedited).  Every
variant's two sources are compiled by their own ``nvcc`` (all started
together, with ``-Xptxas -v``: the registers and spill bytes of the f32
routes' kernels are printed).  Then, on the same seeded inputs, each
variant runs the forward at the deployment shape (32 heads over 8, S
4,096, D 64) and the backward at f32 D 64 (32 over 8, S 1,024), both
causal: each output's largest error against the float64 reference, the
same for the plain PyTorch version, ``chip_smoke``'s check against the
plain version, and CUDA-event ms, twice in turn.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "error_string.cu")
FORWARD = (1, 32, 8, 4096, 64)
# the mangled names of the f32 routes' kernels: name, dtype, D
KERNEL_NAME = re.compile(r"(flash_attention_kernel|dkdv_tf32_kernel|"
                         r"dq_tf32_kernel)I(f|13__nv_bfloat16)Li(\d+)E")
BACKWARD = (1, 32, 8, 1024, 64)


def build(cuda_lib, name: str, edits, work: Path, libs: dict,
          reports: dict) -> None:
    """Compile ``name``'s edited sources into ``work/name/lib.so``; keep
    the ptxas lines of the f32 routes' kernels."""
    csrc = work / name
    csrc.mkdir(parents=True)
    for f in cuda_lib.CSRC.iterdir():
        if f.suffix in (".cuh", ".cu"):
            (csrc / f.name).write_text(f.read_text())
    for fname, old, new in edits:
        text = (csrc / fname).read_text()
        if old not in text:
            reports[name] = f"edit of {fname} not found: {old[:60]!r}"
            return
        (csrc / fname).write_text(text.replace(old, new))
    objs, log = [], ""
    for f in SOURCES:
        obj = csrc / (f + ".o")
        r = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas",
                            "-v", "-c", str(csrc / f), "-o", str(obj)],
                           capture_output=True, text=True)
        log += r.stdout + r.stderr
        if r.returncode:
            reports[name] = log[-3000:]
            return
        objs.append(str(obj))
    so = csrc / "lib.so"
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", *objs,
                    "-o", str(so)], check=True)
    reports[name] = "\n".join(register_report(log))
    libs[name] = so


def register_report(log: str) -> list:
    """``kernel<dtype, D>: registers ...`` and its spills, for each f32
    route kernel in a ``-Xptxas -v`` log."""
    keep, tag = [], None
    for line in log.splitlines():
        if "entry function" in line:
            m = KERNEL_NAME.search(line)
            tag = m and (f"{m.group(1)}<"
                         f"{'f32' if m.group(2) == 'f' else 'bf16'}, "
                         f"{m.group(3)}>")
        elif tag and ("registers" in line or "spill" in line):
            keep.append(f"{tag}: {line.split(':', 1)[-1].strip()}")
    return keep


def reference64(q, k, v, do, causal):
    """Output and (dq, dk, dv) of attention in float64 (the output alone
    when ``do`` is None)."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    qd = q.double()
    kd = k.double().repeat_interleave(G, 1)
    vd = v.double().repeat_interleave(G, 1)
    s = qd @ kd.transpose(-1, -2) / math.sqrt(D)
    if causal:
        pos = torch.arange(S, device=q.device)
        s.masked_fill_(pos[None, :] > pos[:, None], -math.inf)
    p = torch.softmax(s, -1)
    del s
    o = p @ vd
    if do is None:
        return o, None
    dod = do.double()
    dv = p.transpose(-1, -2) @ dod
    ds = p * (dod @ vd.transpose(-1, -2) - (dod * o).sum(-1, keepdim=True))
    del p
    dq = ds @ kd / math.sqrt(D)
    dk = ds.transpose(-1, -2) @ qd / math.sqrt(D)
    fold = lambda t: t.reshape(B, H // G, G, S, D).sum(2)
    return o, (dq, fold(dk), fold(dv))


def max_err(got, want) -> float:
    return float((got.double() - want).abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("edits", type=Path)
    ap.add_argument("--out", default="build/tf32_variants.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tf32_variants: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_backward_plain, flash_attention_plain,
    )

    variants = json.loads(args.edits.read_text())
    libs, reports = {}, {}
    cuda_lib.build()
    main_lib = cuda_lib.library()
    kernels = (fk.FLASH_ATTENTION, fk.FLASH_ATTENTION_BACKWARD)
    device = torch.device("cuda")
    results: dict = {"smi": cs.smi_line(), "ptxas": reports}
    with tempfile.TemporaryDirectory() as tmp:
        threads = [threading.Thread(target=build, args=(
            cuda_lib, name, edits, Path(tmp), libs, reports))
            for name, edits in variants.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for name in variants:
            print(f"== {name}\n{reports.get(name, '')}", flush=True)
        print(cs.smi_line(), flush=True)
        gen = torch.Generator(device=device).manual_seed(48)
        f32 = torch.float32
        q, k, v = cs.flash_inputs(*FORWARD, f32, gen, device)
        qb, kb, vb = cs.flash_inputs(*BACKWARD, f32, gen, device)
        dob = cs.flash_inputs(*BACKWARD[:2], BACKWARD[1], *BACKWARD[3:], f32,
                              gen, device)[0]
        ob64, grads64 = reference64(qb, kb, vb, dob, True)
        of64 = reference64(q, k, v, None, True)[0]
        torch.cuda.empty_cache()
        plain_f = flash_attention_plain(q, k, v, True)
        outb = flash_attention_plain(qb, kb, vb, True)
        plain_b = flash_attention_backward_plain(qb, kb, vb, dob, True,
                                                 out=outb)
        results["plain"] = {
            "forward_err64": max_err(plain_f, of64),
            "backward_err64": {g: max_err(x, r) for g, x, r in
                               zip(cs.GRADS, plain_b, grads64)}}
        print("plain", json.dumps(results["plain"]), flush=True)
        for turn in range(2):
            for name, path in libs.items():
                lib = ctypes.CDLL(str(path))
                lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
                lib.repro_cuda_error_string.restype = ctypes.c_char_p
                cuda_lib._lib = lib
                for kern in kernels:
                    kern._fn = None
                fwd = lambda: fk.run_kernel(fk.FLASH_ATTENTION, q, k, v, True)
                out = fwd()
                ob, lse = fk.run_kernel(fk.FLASH_ATTENTION, qb, kb, vb, True,
                                        return_lse=True)
                bwd = lambda: fk.run_backward(fk.FLASH_ATTENTION_BACKWARD, qb,
                                              kb, vb, ob, lse, dob, True)
                got = bwd()
                row = results.setdefault(name, {"forward_ms": [],
                                                "backward_ms": []})
                row["forward_ms"].append(cs.cuda_ms(fwd))
                row["backward_ms"].append(cs.cuda_ms(bwd))
                row["forward_err64"] = max_err(out, of64)
                row["forward_check"] = cs.attention_check(out, plain_f)[
                    "max_err_ratio"]
                row["backward_err64"] = {g: max_err(x, r) for g, x, r in
                                         zip(cs.GRADS, got, grads64)}
                check = cs.backward_check(got, plain_b)
                row["backward_check"] = {g: check[g]["max_err_ratio"]
                                         for g in cs.GRADS}
                print(name, json.dumps(row), flush=True)
                del out, ob, lse, got
        cuda_lib._lib = main_lib
        for kern in kernels:
            kern._fn = None
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
