#!/usr/bin/env python3
"""Train granite-3-2b from two checkouts of the repository in turns on one
CUDA card, so that two versions of the port's LM training path are
compared on the same card and host.

    python3 scripts/train_ab.py OLD_TREE NEW_TREE [--out PATH]

Runs OLD, NEW, NEW, OLD, each in a process of its own started in that
tree: the tree's granite-3-2b bundle at its published widths (f32 masters,
the ``train_4k`` optimizer and microbatches) through ``Trainer`` on the
tree's ``chip_smoke`` batches (LM_TRAIN_BATCH x LM_TRAIN_SEQ from the
launcher's ``synth_lm_batches``), LM_TRAIN_WARMUP warm-up and
LM_TRAIN_TIMED timed steps.  Prints one JSON line per run: step
percentiles, tokens/s, the peak allocation over the steps above what the
trainer held before them, the losses and the flash kernels' launches.
Host times spread from call to call; compare the runs of one call only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, time
import torch
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.configs.registry import get_bundle
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.launch.train import synth_lm_batches
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.backends.cuda.matmul.allow_tf32 = False
cuda_lib.build()
device = torch.device("cuda")
kernels = [k for k in vars(fk).values() if isinstance(k, cuda_lib.CudaKernel)]
bundle = get_bundle("granite-3-2b")
cfg, mb = bundle.config, bundle.microbatches
params = bundle.init(torch.Generator(device=device).manual_seed(0))
data = synth_lm_batches(cfg.vocab, cs.LM_TRAIN_BATCH, cs.LM_TRAIN_SEQ)
n_steps = cs.LM_TRAIN_WARMUP + cs.LM_TRAIN_TIMED
batches = {c: {k: torch.as_tensor(v, device=device)
               for k, v in data(c).items()} for c in range(n_steps)}
trainer = Trainer(bundle.loss_fn(), params, TrainerConfig(
    opt=bundle.opt, microbatches=mb, log_every=1), device=device)
del params
torch.cuda.synchronize()
held = torch.cuda.memory_allocated(device)
torch.cuda.reset_peak_memory_stats(device)
for k in kernels:
    k.launches = 0
step_s = []
for i in range(n_steps):
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.fit(batches.__getitem__, trainer.step_num + 1)
    torch.cuda.synchronize()
    if i >= cs.LM_TRAIN_WARMUP:
        step_s.append(time.perf_counter() - t)
tokens = cs.LM_TRAIN_BATCH * cs.LM_TRAIN_SEQ
print("RESULT " + json.dumps({
    "step": cs.percentiles_ms(step_s),
    "tokens_per_s": tokens * len(step_s) / sum(step_s),
    "held_bytes": held,
    "step_peak_bytes": torch.cuda.max_memory_allocated(device) - held,
    "losses": [h["loss"] for h in trainer.history],
    "launches": {k.symbol: k.launches for k in kernels},
    "smi": cs.smi_line(),
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
