#!/usr/bin/env python3
"""Serve granite-3-2b from two checkouts of the repository in turns on one
CUDA card, so that two versions of the port's LM path are compared on the
same card and host.

    python3 scripts/serve_ab.py OLD_TREE NEW_TREE [--out PATH]

Runs OLD, NEW, NEW, OLD, each in a process of its own started in that
tree: the tree's ``chip_smoke.serve_phase`` (granite-3-2b at its published
widths, 32 requests of 512-1,024 prompt tokens, 64 new tokens each), then
one 1,024-token prefill under ``torch.profiler`` (the tree's
``chip_smoke.device_profile``).  Prints one JSON line per run: prefill
and decode-step percentiles, mean prefill, tokens/s, launches, and the
prefill's wall time, device busy time and flash-kernel time.  Host times
spread from call to call; compare the runs of one call only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.configs.granite_3_2b import CONFIG as cfg
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.paged_attention.kernel import PAGED_ATTENTION
from repro_torch.models.transformer import init_params
from repro_torch.serve import engine as engine_mod

torch.backends.cuda.matmul.allow_tf32 = False
cuda_lib.build()
device = torch.device("cuda")
flash = [k for k in (getattr(fk, "FLASH_ATTENTION_WGMMA", None),
                     fk.FLASH_ATTENTION) if k is not None]
serve = cs.serve_phase(device, (*flash, PAGED_ATTENTION))
torch.cuda.empty_cache()
params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
prompt = torch.as_tensor(
    np.random.RandomState(14).randint(0, cfg.vocab, cs.SERVE_PROMPT[1]),
    device=device)[None, :]
engine_mod.prefill(cfg, params, prompt)
prof = cs.device_profile(lambda: engine_mod.prefill(cfg, params, prompt),
                         match="flash_attention")
print("RESULT " + json.dumps({
    "prefill": serve["prefill"], "decode_step": serve["decode_step"],
    "prefill_mean_ms": serve["prefill_s_total"] * 1e3 / serve["prefill"]["n"],
    "tokens_per_s": serve["tokens_per_s"], "launches": serve["launches"],
    "failures": serve["failures"],
    "prefill_profile": {k: v for k, v in prof.items()
                        if k != "device_kernels"},
}))
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
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
