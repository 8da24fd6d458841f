#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s recsys, MoE, LM-training and
GNN-training phases alone on one CUDA card, to iterate on them without
the whole smoke run.

    python3 scripts/smoke_phases.py recsys,mserve,rtrain,moe,qwen3,mparity,lm,mesh,guard,attn,gnn \
        [--seed 0] [--out build/smoke_phases.json]

Phases: ``kattn`` (the attention kernels against their plain versions
at the serve configuration's and deployment shapes, the smoke run's
attention phase: the paged kernel with its log-sum-exp and the merge of
a cache's sequence blocks among them), ``recsys`` (DLRM-MLPerf served at
its published config, the four
recsys archs card against CPU, and the bag kernel's cases, the grouped
launch among them), ``mserve`` (the four recsys archs' serve cells at
published widths on a one-rank NCCL mesh against the same calls
unsharded, on DLRM's tables from ``recsys`` where it ran before, as the
smoke run does, else drawn anew), ``rtrain`` (DLRM-MLPerf trained with tables capped at
2^22 rows), ``adamw`` (the fused AdamW kernel against its plain
version at DLRM's capped table and granite's largest leaf, timed beside
its bound, the plain version and ``torch.optim.AdamW(fused=True)``),
``moe`` (Moonlight-16B-A3B served at its full config), ``qwen3``
(Qwen3-235B-A22B widths at 8 layers), ``mparity`` (both MoE configs at
REDUCED, card against CPU), ``lm`` (granite-3-2b trained at its published
widths), ``mesh`` (granite-3-2b's step and moonshot-v1-16b-a3b's at 2
layers on a one-rank NCCL mesh through the tensor-parallel route, then
dlrm-mlperf's and two-tower-retrieval's through the row-sharded route,
each against its unsharded step with the counts of collectives, the
LM serve cells on the mesh (granite-3-2b's prefill and decode steps,
moonshot-v1-16b-a3b's at 4 layers) against the same steps unsharded,
``compressed_psum`` and a bf16 checkpoint on the card), ``guard`` (the
attention wrappers' grad guard and the flash
``Function``), ``attn`` (both attention kernels at the shapes the
``moe``, ``qwen3`` and ``lm`` phases gave them), ``bwd`` (the flash
backward kernel on both routes against the plain backward at the cases
the ``lm`` phase checks, without the training), ``gnn`` (MACE trained at
its published widths in the GNN bundle's four cells, data from
``--seed``; no hand kernel may launch), ``mgnn`` (Cora's and the
molecules' steps at those widths on a one-rank NCCL mesh, on their node
and edge blocks, against the same steps unsharded, bit for bit, with
the route's count of collectives), ``dryrun`` (granite-3-2b's step
on a one-rank NCCL mesh held to its own dry run, then the dry run of the
cells; ``--dryrun-cells ARCH,...`` traces only those archs' cells on
the (16, 16) mesh).  Builds the kernels,
turns TF32 off as the smoke run does, runs the phases in that order,
prints each one's failures and main numbers, writes the full reports as
JSON, and exits 1 if any phase failed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("kattn", "recsys", "mserve", "rtrain", "adamw", "moe", "qwen3",
          "mparity", "lm", "mesh", "guard", "attn", "bwd", "gnn", "mgnn",
          "dryrun")
PATH_NAMES = {"moe": "moe_serve", "qwen3": "moe_serve_qwen3", "lm": "lm_train"}
SUMMARY_KEYS = ("tokens_per_s", "prefill", "decode_step", "dropped",
                "peak_mem_bytes", "serve_peak_mem_bytes", "launches", "step",
                "grad_check", "configs", "reduced_checks", "backward",
                "adamw_ms", "setup_s", "split_s", "checks",
                "reduced_checks", "hand_kernel_launches", "adamw_launches",
                "seconds", "unsharded", "sharded", "step_peak_ratio",
                "model_collectives", "moe", "peak_ratio", "roofline_share",
                "real", "cells", "cells_s", "archs", "failures")


def backward_phase(cs, device) -> dict:
    """``chip_smoke.flash_backward_cases`` at granite's lm train shape,
    each case's failure as the lm phase words it."""
    from repro_torch.configs.granite_3_2b import CONFIG as cfg

    cases = cs.flash_backward_cases(
        (cs.LM_TRAIN_BATCH // 4, cfg.n_heads, cfg.n_kv_heads,
         cs.LM_TRAIN_SEQ, cfg.d_head), device)
    failures = [f"{name}: {case['kernel']} differs from the plain backward"
                for name, case in cases.items()
                if not case["within_tolerance"]]
    failures += [f"{name}: two calls gave different bits"
                 for name, case in cases.items()
                 if case.get("bit_identical_rerun") is False]
    return {"cases": cases, "failures": failures}


def kernel_attention_phase(cs, device) -> dict:
    """``chip_smoke.attention_phase`` at the serve configuration's
    shapes (no serve phase ran), each case's failure as the smoke run
    words it."""
    cases = cs.attention_phase({"flash_attention_wgmma": None,
                                "paged_attention": None}, device)
    failures = [f"{name} disagrees with its plain version at {where} "
                f"shape {case['shape']}: error {case['max_err_ratio']:.3g} "
                f"times its limit"
                for name, by in cases.items() for where, case in by.items()
                if not case["within_tolerance"]]
    return {"cases": cases, "failures": failures}


def recsys_phase(cs, device, bag, drawn: dict) -> dict:
    """The smoke run's recsys serve, parity and bag-kernel phases; with
    ``drawn`` a dict, DLRM's params are left in it for ``mserve``."""
    serve, params = cs.recsys_serve_phase(device, bag)
    parity = cs.recsys_parity_phase(device)
    bags = cs.bag_phase(params, device)
    if drawn is not None:
        drawn["dlrm-mlperf"] = params
    del params
    return {"serve": serve, "parity": parity, "bags": bags,
            "launches": serve["launches"],
            "failures": serve["failures"] + parity["failures"]
            + cs.bag_failures(bags)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phases", help="comma-separated, of " + ",".join(PHASES))
    ap.add_argument("--out", default="build/smoke_phases.json")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the gnn phase's synthetic data")
    ap.add_argument("--dryrun-cells", default="",
                    help="the dryrun phase's archs (default: every cell, "
                    "as the smoke run)")
    args = ap.parse_args(argv)
    wanted = args.phases.split(",")
    unknown = set(wanted) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.adamw import ADAMW
    from repro_torch.kernels.embedding_bag.kernel import EMBEDDING_BAG
    from repro_torch.kernels.flash_attention.kernel import (
        FLASH_ATTENTION,
        FLASH_ATTENTION_BACKWARD,
        FLASH_ATTENTION_BACKWARD_WGMMA,
        FLASH_ATTENTION_WGMMA,
    )
    from repro_torch.kernels.intersect.kernel import SORTED_MEMBER_MASK
    from repro_torch.kernels.paged_attention.kernel import PAGED_ATTENTION
    from repro_torch.kernels.posting_decode.kernel import VARINT_DECODE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    kernels = (FLASH_ATTENTION_WGMMA, FLASH_ATTENTION, PAGED_ATTENTION,
               FLASH_ATTENTION_BACKWARD_WGMMA, FLASH_ATTENTION_BACKWARD)
    # what the training phases reset and count: the optimizer's kernel too
    step_kernels = kernels + (ADAMW,)
    t0 = time.perf_counter()
    cuda_lib.build()
    cs.log(f"build: {time.perf_counter() - t0:.1f} s")
    cs.log(cs.smi_line())
    calls = {
        "kattn": lambda: kernel_attention_phase(cs, device),
        "recsys": lambda: recsys_phase(
            cs, device, EMBEDDING_BAG,
            drawn if "mserve" in wanted else None),
        "mserve": lambda: cs.mesh_recsys_serve_phase(device, EMBEDDING_BAG,
                                                     drawn),
        "rtrain": lambda: cs.recsys_train_phase(device, EMBEDDING_BAG,
                                                ADAMW),
        "adamw": lambda: cs.adamw_phase(device, ADAMW),
        "moe": lambda: cs.moe_serve_phase(device, kernels),
        "qwen3": lambda: cs.moe_qwen3_phase(device, kernels),
        "mparity": lambda: cs.moe_parity_phase(device, kernels),
        "lm": lambda: cs.lm_train_phase(device, step_kernels),
        "mesh": lambda: cs.mesh_phase(device, step_kernels, EMBEDDING_BAG),
        "guard": lambda: {"failures": cs.attention_grad_guard(device)},
        "attn": lambda: {"failures": [], "cases": cs.path_attention_phase(
            {PATH_NAMES[k]: out[k] for k in PATH_NAMES if k in out},
            device)},
        "bwd": lambda: backward_phase(cs, device),
        "gnn": lambda: cs.gnn_train_phase(
            device, step_kernels + (VARINT_DECODE, SORTED_MEMBER_MASK,
                                    EMBEDDING_BAG), args.seed),
        "mgnn": lambda: cs.mesh_gnn_phase(
            device, step_kernels + (VARINT_DECODE, SORTED_MEMBER_MASK,
                                    EMBEDDING_BAG), args.seed),
        "dryrun": lambda: cs.dryrun_phase(
            device, step_kernels + (VARINT_DECODE, SORTED_MEMBER_MASK,
                                    EMBEDDING_BAG), out["smi"],
            [(f"--arch {args.dryrun_cells} --mesh single",)]
            if args.dryrun_cells else cs.DRYRUN_CELLS),
    }
    out: dict = {"smi": cs.smi_line()}
    drawn: dict = {}
    failed = False
    for name in PHASES:
        if name not in wanted:
            continue
        t0 = time.perf_counter()
        out[name] = calls[name]()
        failed |= bool(out[name]["failures"])
        cs.log(f"{name}: {time.perf_counter() - t0:.1f} s, " + json.dumps(
            {k: v for k, v in out[name].items() if k in SUMMARY_KEYS}))
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
