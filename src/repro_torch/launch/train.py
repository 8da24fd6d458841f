"""Training launcher, the port of ``repro.launch.train``: ``--arch <id>``
through ``Trainer`` with ``lm_loss`` (``LMLoss``), on the CUDA card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --steps 200 --ckpt-dir /tmp/ckpt [--device cpu]

Trains the arch's reduced configuration (``--full``: the published one)
from f32 masters drawn from seed 0, with the reference launcher's
optimizer (``OptConfig(lr=3e-3, schedule="wsd", warmup_steps=20)``) on
``synth_lm_batches``, the reference's seeded Zipf batches.  ``--device``
picks the card or the CPU.  ``--mesh single|multi`` trains on the
production mesh, (16, 16) or (2, 16, 16) ranks, as the reference does:
under ``torchrun`` with that many processes (a world of another size
raises the mesh's ``ValueError``), params placed by the bundle's
``param_shardings`` and ``fit`` inside the mesh context
(``launch.mesh``, ``distributed.sharding``); the step computes on the
weights' ``model`` shards (``LMLoss``, ``distributed.tensor_parallel``).  A recsys or GNN id exits
with the reference's message.

    torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
        --arch granite-3-2b --full --mesh single
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import ARCH_IDS, family, get_bundle
from repro_torch.device import resolve_device
from repro_torch.distributed.hooks import use_mesh
from repro_torch.distributed.sharding import place
from repro_torch.models.transformer import LMLoss
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves, tree_map


def synth_lm_batches(vocab: int, batch: int, seq: int
                     ) -> Callable[[int], Dict[str, np.ndarray]]:
    """``fn(cursor)``: the batch of data cursor ``cursor``, seeded by it
    (numpy ``RandomState``, as the reference): sorted Zipf(1.5) tokens
    modulo ``vocab`` and their next tokens as labels (-1 at the end)."""
    def fn(cursor: int):
        rng = np.random.RandomState(cursor)
        toks = np.sort(rng.zipf(1.5, size=(batch, seq)) % vocab, axis=1)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}

    return fn


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="the published config (f32 masters and AdamW "
                    "state: 16 B a parameter on the card)")
    ap.add_argument("--mesh", choices=["host", "single", "multi"],
                    default="host")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--compress-grads", action="store_true")
    args = ap.parse_args(argv)

    if family(args.arch) != "lm":
        raise SystemExit(
            f"{args.arch} is a {family(args.arch)} arch; this launcher drives "
            "the LM family (see examples/ for the others)"
        )
    device = resolve_device(args.device)
    mesh = None
    if args.mesh != "host":
        from repro_torch.launch.mesh import make_production_mesh

        if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
            if device.type == "cuda":   # one card a process, as torchrun
                device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
                torch.cuda.set_device(device)
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo")
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=device)
    bundle = get_bundle(args.arch, reduced=not args.full)
    cfg = bundle.config
    params = bundle.init(torch.Generator(device=device).manual_seed(0))
    n = sum(t.numel() for t in leaves(params))
    print(f"arch={args.arch} params={n/1e6:.1f}M device={device} "
          f"mesh={args.mesh}")
    if mesh is not None:
        params = tree_map(place, params, bundle.param_shardings(mesh))

    trainer = Trainer(
        LMLoss(cfg),
        params,
        TrainerConfig(
            opt=OptConfig(lr=3e-3, schedule="wsd", warmup_steps=20,
                          total_steps=args.steps),
            microbatches=args.microbatches,
            compress_grads=args.compress_grads,
            ckpt_dir=args.ckpt_dir or None,
            ckpt_every=100,
            log_every=20,
        ),
        device=device,
    )
    del params
    if args.ckpt_dir and trainer.try_resume():
        print(f"resumed at step {trainer.step_num}")

    batches = synth_lm_batches(cfg.vocab, args.batch, args.seq)
    t0 = time.time()
    if mesh is not None:
        with use_mesh(mesh):
            last = trainer.fit(batches, args.steps)
    else:
        last = trainer.fit(batches, args.steps)
    dt = time.time() - t0
    print(f"done: {trainer.step_num} steps in {dt:.1f}s, metrics={last}")
    return trainer


if __name__ == "__main__":
    main()
