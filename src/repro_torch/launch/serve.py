"""Serving launcher: continuous batching over the paged-KV substrate, on
the CUDA card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --requests 16 --slots 4 [--device cpu]

Serves the arch's reduced configuration with seeded random weights, as
the reference launcher (``repro.launch.serve``) does: every LM arch,
dense and MoE.  A recsys or GNN id exits with "<arch> is not an LM
arch", as the reference's does.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, family, get_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServeEngine


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-3-2b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--chain-limit", type=int, default=9)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if family(args.arch) != "lm":
        raise SystemExit(f"{args.arch} is not an LM arch")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(
        cfg, params, batch_slots=args.slots, s_max=256,
        page_size=16, chain_limit=args.chain_limit, device=device,
    )
    rng = np.random.RandomState(0)
    for i in range(args.requests):
        engine.submit(Request(
            req_id=i,
            prompt=rng.randint(0, cfg.vocab, args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new,
        ))
    t0 = time.time()
    done = engine.run_until_done(max_steps=2000)
    dt = time.time() - t0
    s = engine.stats()
    tokens = sum(len(r.out_tokens) for r in done)
    print(f"{len(done)} requests, {tokens} tokens in {s['steps']} steps "
          f"({dt:.1f}s, {tokens/max(dt,1e-9):.1f} tok/s host-side, "
          f"{device})")
    print(f"paged-KV: gather depth <= {s['kv']['max_gather_depth']} "
          f"(limit {args.chain_limit}), {s['kv']['compactions']} compactions, "
          f"fragmentation {s['fragmentation']:.2f}")
    return s


if __name__ == "__main__":
    main()
