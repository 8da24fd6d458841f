#!/usr/bin/env python3
"""Build edited copies of the flash backward's CUDA source side by side and
time each on one CUDA card, so that a design choice of
``src/repro_torch/csrc/flash_attention_bwd.cu`` is measured against the
source as it stands, within one call.

    python3 scripts/bwd_variants.py EDITS.json [--out PATH]

EDITS.json maps a variant's name to a list of ``[old, new]`` text edits
of ``flash_attention_bwd.cu`` (``[]`` is the source unedited).  Every
variant is compiled by its own ``nvcc`` (all started together, with
``-Xptxas -v``: each kernel's registers and spill bytes are printed),
then, twice in turn, each runs the wgmma backward at granite's lm-train
microbatch (B 2, 32 heads over 8, S 4,096, D 64, (B, S, H, D) views) and
a ragged non-causal case (8 over 2, S 1,000) on the same inputs: the card's
element-wise check against the plain backward, bit identity of two calls,
CUDA-event ms and, in the first turn, the profiler's ms of its three
kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = "flash_attention_bwd.cu"
SHAPES = (((2, 32, 8, 4096, 64), True, True),
          ((1, 8, 2, 1000, 64), False, False))


def build(cuda_lib, name: str, edits, work: Path, libs: dict,
          reports: dict) -> None:
    """Compile ``name``'s edited source with the library's error helper
    into ``work/name/lib.so``; keep the ptxas lines of its kernels."""
    csrc = work / name
    csrc.mkdir(parents=True)
    for f in cuda_lib.CSRC.iterdir():
        if f.suffix in (".cuh", ".cu"):
            (csrc / f.name).write_text(f.read_text())
    text = (csrc / SOURCE).read_text()
    for old, new in edits:
        if old not in text:
            reports[name] = f"edit not found: {old[:60]!r}"
            return
        text = text.replace(old, new)
    (csrc / SOURCE).write_text(text)
    objs, log = [], ""
    for f in (SOURCE, "error_string.cu"):
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
    lines = log.splitlines()
    reports[name] = "\n".join(
        line for i, line in enumerate(lines)
        if "wgmma_kernel" in "".join(lines[max(0, i - 2):i + 1])
        and ("registers" in line or "spill" in line))
    libs[name] = so


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("edits", type=Path)
    ap.add_argument("--out", default="build/bwd_variants.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_variants: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_backward_plain,
    )

    variants = json.loads(args.edits.read_text())
    libs, reports = {}, {}
    cuda_lib.build()
    main_lib = cuda_lib.library()
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
        kernel = fk.FLASH_ATTENTION_BACKWARD_WGMMA
        bf = torch.bfloat16
        device = torch.device("cuda")
        results: dict = {"smi": cs.smi_line(), "ptxas": reports}
        for shape, causal, views in SHAPES:
            gen = torch.Generator(device=device).manual_seed(48)
            B, H, Hkv, S, D = shape
            q, k, v = cs.flash_inputs(B, H, Hkv, S, D, bf, gen, device,
                                      views=views)
            do = cs.flash_inputs(B, H, H, S, D, bf, gen, device,
                                 views=views)[0]
            cuda_lib._lib, kernel._fn = main_lib, None
            out, lse = fk.run_kernel(fk.FLASH_ATTENTION_WGMMA, q, k, v, causal,
                                     return_lse=True)
            plain = flash_attention_backward_plain(q, k, v, do, causal,
                                                   out=out)
            for turn in range(2):
                for name, path in libs.items():
                    lib = ctypes.CDLL(str(path))
                    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
                    lib.repro_cuda_error_string.restype = ctypes.c_char_p
                    cuda_lib._lib, kernel._fn = lib, None

                    def call():
                        return fk.run_backward(kernel, q, k, v, out, lse, do,
                                               causal)
                    got, again = call(), call()
                    check = cs.backward_check(got, plain)
                    row = results.setdefault(str(shape), {}).setdefault(
                        name, {"ms": []})
                    row["ms"].append(cs.cuda_ms(call))
                    row["within_tolerance"] = check["within_tolerance"]
                    row["bit_identical_rerun"] = all(
                        torch.equal(a, b) for a, b in zip(got, again))
                    if turn == 0:
                        row["kernels_ms"] = cs.kernel_device_ms(
                            call, cs.BACKWARD_KERNEL_NAMES)
                    print(shape, name, json.dumps(row), flush=True)
            cuda_lib._lib, kernel._fn = main_lib, None
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
