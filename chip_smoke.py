#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card: the search stack, the
LM serving path, recsys serving and training, MoE serving, LM training
and GNN training.

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
     aside) and per-device ``IOStats`` to the byte; both search kernels'
     launch counters must rise during the ``cuda`` runs, and
     ``sorted_member_mask`` must launch once per join round with a
     non-empty pair, as the ``numpy`` run forms them (``JoinRoundLog``).
     Prints qps and per-query p50/p99 latency per backend, and for each
     1-shard cell
     where one cold ``cuda`` batch spends its time (device busy time
     and idle share from ``torch.profiler``, top host functions);
  3. search replica: the same world and 256 queries through the port's
     durable store and replica fabric.  A ``DurableIndexStore`` primary of
     2 shards (fsync on) in a temporary directory takes ``parts[0]``,
     compacts and checkpoints; ``open_replica`` reopens it at the
     primary's generation vector, and a ``ReplicaSetReader`` of 2
     replicas a shard per backend (``numpy`` and ``cuda``) serves three
     cold batches: with ``s0r0`` dying mid-batch after a fixed number of
     serves, after the primary applies ``parts[1]`` and the replica store
     polls the WAL, and after ``s0r0`` is revived.  The two fabrics must
     agree in results, traces (the ``replicas`` block included) and
     per-replica ``IOStats`` at every step, with a failover in the first
     batch and equal catch-up ledgers (``replica_check``); after the poll
     and the revive both must serve what a ``numpy`` service over the
     primary serves.
     ``varint_decode`` must launch and ``sorted_member_mask`` once per
     join round the ``numpy`` run forms.  Prints qps and p50/p99 per
     backend, failovers, catch-up modes, read bytes per replica, WAL
     bytes, recovery info, the store's step times and the device's idle
     share over one cold ``cuda`` fabric batch;
  4. search kernels: each against its plain PyTorch version on the card,
     bit for bit, at the largest shape the search phase gave it and at
     deployment size (2^24 postings varint-encoded; two sorted 2^24-id
     lists), timed with CUDA events beside its bound and the one-call
     PyTorch yardstick.  ``sorted_member_mask`` (segmented) also against
     ``torch.isin`` (over segment tags where there are several segments)
     at the largest single pair and the largest join round the search
     gave it, 2^24 posting docs (runs of mean 4) in 2^24, 2^14 in 2^24
     and 2^24 in 2^14, 4,096 segments of 4,096 in 4,096, the edges (ties
     at tile and segment edges, empty sides, keys past 2^40, N = 0, M = 0)
     and b of 2^24 with a 16 and 32 times shorter (either side of the
     route threshold); both routes checked bit for bit everywhere, and
     timed at 2^24 in 2^24 and at the threshold with ``torch.profiler``'s
     kernel time (the merge route's partition pass apart; the full sweeps
     of the threshold and the tile are ``scripts/member_sweep.py``'s).
     ``varint_decode`` also over 1.5 MB of 5- to
     10-byte varints (at an aligned and an unaligned base), one byte and
     an empty buffer; at the search shape beside its device time from
     ``torch.profiler``, the same launch inside a ``torch.cuda.device``
     context, and the host time of ``unpack_varints`` under the ``cuda``
     backend (raw bytes to the kernel) and the ``torch`` one (host byte
     prep, two int64 copies, ``index_add_``).  The hot cells must launch
     ``varint_decode``;
  5. serve: ``ServeEngine`` for granite-3-2b at its published widths
     (40 layers, d_model 2048, 32 heads over 8 KV heads, vocab 49,155;
     seeded random bf16 weights), 16 slots of 4,096 tokens in 16-token
     pages, 32 requests of 512-1,024 prompt tokens and 64 new tokens
     each.  Prefill (bf16, D 64) must launch the wgmma flash kernel once
     per layer and prefill and the f32-route flash kernel never; decode the
     paged kernel once per layer and step; every logit must be finite.  Prints tokens/s, p50/p99 per prefill and per decode step,
     launches, the paged-KV manager's stats, and the device's busy share
     over one decode step of 16 active slots and over one prefill of
     1,024 tokens, with the flash kernels' share (``torch.profiler``);
  6. serve parity: granite-3-2b widths at 2 layers in float32, served on
     the card (through the kernels) and replayed on the CPU (through the
     plain versions) with the card's tokens forced: every step's logits
     must agree within 1e-4 and ``stats()`` must be equal.  f32 prefill
     is the f32-route flash kernel's path: it must launch once per layer and
     prompt on the card, the wgmma kernel never;
  7. attention kernels: each against its plain version on the card,
     element by element (f32 within 2e-5; bf16 within one bf16 rounding
     of each side plus that), timed beside its bound and
     ``scaled_dot_product_attention`` on the same operands.  The wgmma
     flash kernel in bf16 at the serve phase's largest shape, at
     deployment (S 4,096), at S 1, 37 and 129, non-causal, at D 128
     (qwen1.5-4b: 20 heads over 20, S 2,048) and on (B, S, H, D) views
     as ``models.attention.attention`` passes them; the split-TF32 flash
     kernel in f32 at the serve and deployment shapes and at the REDUCED
     configs' (S 517, D 8 and 16), and in bf16 on the
     wgmma kernel's serve and deployment operands (the old/new ratio on
     one card); the paged kernel in bf16 and f32 at the serve phase's
     largest shape (also timed cold, over pool copies that exceed the
     L2), at deployment (128 rows x 256 pages) and at the split's edges
     (lengths 1, page and split edges, splits wholly past the length,
     empty rows), each also with the log-sum-exp it writes on request
     (within 1e-5 of the plain version's, a row of length 0 at the
     sentinel exactly, the output bit for bit as without it, timed
     beside it); and the deployment cache cut into 2 and 4 blocks of its
     sequence at D 64 and D 128, each block through the kernel with its
     log-sum-exp and the blocks merged (``merge_attention_blocks``),
     against the whole cache's launch;
  8. recsys serve: dlrm-mlperf at its published config (26 bf16 tables of
     177,944,225 rows in all, 45.6 GB; seeded random weights): 200
     ``serve_p99`` calls of 512 rows, 10 ``serve_bulk`` calls of 262,144
     and 5 ``retrieval_cand`` calls over 1,000,000 candidates, ids drawn
     in each table's range and dense features uniform in [0, 1).  The bag
     kernel's counter must rise by one a forward (all 26 tables in one
     launch, written into the interaction's input); every score must be
     finite, and a p99 and a bulk batch must score bit for bit as the
     per-table launches and the stack of the earlier design do.  Prints
     table bytes, peak device memory, p50/p99, samples/s, and over one
     call of each serve cell the device's busy share, top kernels and the
     bag kernel's share (``torch.profiler``);
  9. recsys parity: the four recsys archs in float32, card against CPU
     with the same weights (dlrm-mlperf at its published widths with each
     table cut to 10,000 rows; the others at REDUCED): scores within
     1e-4, top-100 ids equal but for adjacent pairs of scores within it;
 10. embedding_bag kernel: against its plain version in bf16 and f32 at
     DLRM's one-table serve launch (262,144 bags, K = 1, w = 1: bit
     identical), over t19's 48,937,457 rows (and a 20M-row f32 table)
     with K = 8 and ids among the tables' last rows, at DIN's D = 18,
     K = 100, and grouped: the 26 DLRM tables at ``serve_bulk``'s batch
     in one launch, bit for bit against the per-table plain versions
     (also with out-of-range ids under both rules), and again with each
     table cut in two by row windows (each half bit for bit against its
     plain version, the halves summing to the whole launch); timed
     beside its bytes bound (each distinct row its ids read counted
     once) and ``torch.nn.functional.embedding_bag``.  Then the mesh
     recsys serve check (``mesh_recsys_serve_phase``, its own one-rank
     NCCL mesh): each recsys arch's ``serve_p99`` (B 512), ``serve_bulk``
     (B 262,144) and ``retrieval_cand`` (1,000,000 candidates) at its
     published widths through ``RecsysBundle.serve_step``, unsharded and
     on the mesh (weights placed by the rules, a view of DLRM's 45.55 GB
     of tables from phase 8; the batch placed by the cell's layout, the
     candidates split over ``data`` and their top 100 merged): scores
     bit for bit, ids equal, the bag kernel once a DLRM forward, the
     lookups', ``model``'s and the merge's collectives where the route
     issues them, the peak at most 1.10 of the unsharded call's;
 11. recsys train: dlrm-mlperf at its published widths with each table
     capped at 2^22 rows (5 of 26 cut: 23,458,556 rows, 3.0G parameters;
     the cut is printed as ``reduced``), f32 masters drawn on the card,
     trained through ``Trainer`` with the recsys bundle's AdamW on
     batches of 65,536 drawn on the card per data cursor.  First one
     batch's loss and table gradients through the kernel (the bag's
     ``autograd.Function``) and through its plain version under
     autograd: equal losses, and every table's gradient within the
     f32 bound of ``table_grad_check`` of the exact sum and non-zero on
     the rows the batch touched; then 3 warm-up and 10 timed steps (the
     bag kernel must launch once a step), one profiled step (device
     busy share, top ops, the bag forward, the bag backward and AdamW
     apart), AdamW and the bag's backward timed alone (beside its bound
     and ``F.embedding``'s backward); REDUCED in f32, 3 steps card
     against CPU and 6 steps straight against 3, an async checkpoint, a
     fresh ``Trainer.try_resume`` and 3 more.  Prints step p50/p99,
     samples/s, peak memory and the profile;
 12. moe serve: Moonlight-16B-A3B at the repo's full config (48 layers,
     64 experts top-6 with 2 shared, 28.55B parameters, 57.1 GB of bf16
     weights, the router in f32; seeded random weights) through
     ``ServeEngine``: 16 slots of 2,048 tokens (S_max cut from 4,096 to
     fit beside the weights), 32 requests of 512-1,024 prompt tokens and
     32 new tokens each.  The wgmma flash kernel must launch once per
     layer and prefill, the paged kernel once per layer and decode step,
     the f32-route flash kernel never; every request completes with finite
     logits.  Prints tokens/s, p50/p99 per prefill and decode step, the
     picks dropped by capacity per prefill and per decode step, peak
     memory and a profiled decode step's busy share and top kernels;
     then Qwen3-235B-A22B at its published widths cut to 8 layers (42.4
     GB), 4 slots of 2,048, 8 requests of 16 new tokens: the wgmma
     kernel at GQA 16:1 and the paged kernel with 16 heads a row;
 13. moe parity: both MoE configs at REDUCED in float32, card against
     CPU with the card's tokens forced: logits within 1e-4, equal
     ``stats()``, the same expert picks in every MoE layer call and the
     same dropped count;
 14. lm train: granite-3-2b at its published widths and depth (40
     layers, 2,533,531,648 f32 masters and AdamW state, 40.5 GB) through
     ``Trainer`` with the bundle's ``train_4k`` optimizer and 4
     microbatches, on batches of 8 x 4,096 tokens (cut from 256 x 4,096)
     from the launcher's ``synth_lm_batches``.  First one microbatch's
     loss and gradients with attention through the flash kernel's
     ``autograd.Function`` and through its plain version under autograd
     (``LM_GRAD_LOSS_RTOL``, ``LM_GRAD_REL_L2``); then 2 warm-up and 5
     timed steps (the wgmma kernel must launch 2 x 40 x 4 times a step,
     the forward and the remat recompute, and the backward kernel of
     ``csrc/flash_attention_bwd.cu`` 40 x 4 times), one profiled step
     (busy share, the flash forward, the backward kernel and AdamW apart),
     AdamW alone, and the backward kernel on both routes against the plain
     backward element by element (bf16 within one rounding of each side
     plus 2e-5, f32 within 2e-5) and timed beside its bound, the plain
     backward and SDPA's backward: the lm train microbatch (twice, bit for
     bit), D 128, ragged S 1 / 37 / 129 non-causal, f32 at D 8, 16 and
     64, bf16 at D 16; REDUCED granite and Moonshot in f32, 3 steps card
     against CPU (the f32-route backward must launch once a layer and
     microbatch); the bare attention wrappers must raise on a ``q`` that
     requires grad, and the ``Function`` must give the plain version's
     gradient.  Then the mesh phase on a one-rank NCCL (1, 1) mesh: the
     granite step through the tensor-parallel route
     (``distributed.tensor_parallel``) bit for bit against the unsharded
     step, with its count of ``model`` collectives, moonshot at its
     published widths cut to 2 layers likewise, and DLRM's and
     two-tower's steps through the row-sharded route
     (``distributed.row_parallel``: tables looked up where their rows
     lie, MLPs on their columns; two-tower at B 32,768 with 2^23 user
     rows, the most of ``train_batch`` that fits a card) bit for bit
     against theirs (``mesh_phase``); and the LM serve cells on the
     mesh (``LMBundle.serve_step``: the weights' ``model`` shards, the
     decode cache's sequence over ``model``, the ranks' attention merged
     by the paged kernel's log-sum-exp): granite-3-2b at its published
     widths, a prefill of 16 x 4,096 and 8 decode steps of those rows,
     logits and cache bit for bit against the same steps without a mesh,
     and moonshot cut to 4 layers (8 x 1,024) within 1e-5, with their
     ``model`` collectives and launches.  Then
     both attention kernels against their plain versions (outputs and
     log-sum-exps) at the shapes these paths gave them;
 15. gnn train: MACE at its published widths (2 layers, k 128, l_max 2,
     correlation 3, 8 radial functions) through ``get_bundle("mace")``'s
     four cells and ``Trainer`` with the bundle's AdamW, data synthetic
     from ``--seed``: Cora's size (2,708 nodes, 10,556 edges, 1,433
     features, 7 classes), the sampled cell (1,024 fresh seeds a step,
     fanout [15, 10], padded to 169,984 nodes and 168,960 edges, from a
     Reddit-sized graph of 232,965 nodes at mean degree 492 sampled on
     the host, its 602-wide feature table on the card), ogbn-products'
     size (2,449,029 nodes, 61,859,140 edges in 30 chunks of 2^21, 100
     features, 47 classes) and 128 molecules of 30 atoms and 64 edges.
     Each cell: 2 warm-up and 5 timed steps (finite losses, every
     parameter moved), peak memory and a profiled step; the sampler's
     host time.  Then E(3) invariance and card against CPU (loss,
     every gradient leaf) at full width on Cora and molecule, and all
     four cells at REDUCED, 3 steps card against CPU.  TF32 must be off
     and no hand kernel may launch: the reference's MACE reaches no
     Pallas kernel.  Then "mesh gnn": Cora and the molecules at those
     widths, one step each unsharded and on a one-rank NCCL mesh (the
     batch on its node and edge blocks, ``graph_parallel``), from the
     same params and batch under deterministic algorithms: the loss and
     every param bit for bit, ``GRAPH_COLLECTIVES`` as worked out from
     the layers, no hand kernel launched, the step's peak at most
     MESH_PEAK_RATIO of the unsharded step's;
 16. dryrun: granite-3-2b's step on a one-rank NCCL mesh at 8 x 4,096 in
     4 microbatches held to its own dry run (``launch.dryrun``) at that
     shape: each hand kernel's charges equal its launches, the ``model``
     collectives equal ``MODEL_COLLECTIVES``, the aten dot FLOPs equal
     ``FlopCounterMode``'s total; the dry run's peak over
     ``torch.cuda.max_memory_allocated()`` and its roofline bound over
     the step's p50 are printed with the card's name and power limit;
     granite's ``decode_32k`` step at 16 x 4,096 on that mesh likewise
     (the paged kernel once a layer, the flash kernels never, the
     ``model`` collectives, dot FLOPs, the peak's ratio).
     Then the dry run of every arch x cell on the (16, 16) mesh but the
     two MoE archs' ``train_4k`` (left to the CLI run ``PERF.md``
     records), and of granite-3-2b's ``train_4k`` on the (2, 16, 16) one,
     traced on the CPU in three processes (no card, no data; each cell
     must be ``ok``, with its roofline terms in ms, the dominant one and
     its peak GB a rank against 80);
 17. print the kernels line (eight kernels: both flash forward routes,
     both flash backward routes, their launches and the paged kernel's
     by path, and the paged kernel's log-sum-exp route; the search
     kernels' launches summed over the search and replica phases, the
     bag's over recsys serving, the mesh serve check and training), then
     the result line.

Exits with code 2 when no CUDA device is present.  Imports nothing of
JAX or of the ``repro`` package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import os
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's figures (launch.mesh.HW) and each kernel's least work
# (kernels.costs): the bound column of the kernels line
from repro_torch.kernels.costs import (  # noqa: E402
    Cost,
    adamw_cost,
    bag_bytes,
    flash_backward_cost,
    flash_cost,
    member_cost,
    paged_cost,
    varint_cost,
)
from repro_torch.launch.mesh import HW  # noqa: E402

WALL_CLOCK_KEYS = ("shard_fetch_s", "query_s", "busy_s")
N_QUERIES = 256
N_HOT_QUERIES = 64
REPLICA_KILL_AFTER = 25     # serves of s0r0 before its injected death
TOP_K = 10
DEPLOY_N = 1 << 24
STRADDLE_VALUES = 200_000   # about 1.5 MB of 5- to 10-byte varints

# serve phase: granite-3-2b at its published widths
SERVE_SLOTS = 16
SERVE_S_MAX = 4096
SERVE_PAGE = 16
SERVE_CHAIN = 9
SERVE_REQUESTS = 32
SERVE_PROMPT = (512, 1024)
SERVE_NEW = 64
# card (kernels) against CPU (plain versions), float32 logits: the two
# sum d_model = 2048 and d_ff = 8192 products in other orders (cuBLAS and
# the kernels' reductions against the CPU's), which moves logits of unit
# scale by up to about 1e-5 on an H100; 1e-4 leaves a margin and still
# catches a wrong mask, scale or head mapping, which moves them by 1e-2
# or more
PARITY_TOL = 1e-4
# attention kernel against its plain version on the same inputs, element
# by element.  Both compute in f32 and differ only in summation order
# (at most 1e-6 measured on an H100), held to F32_TOL.  A bf16 output is
# that f32 value rounded once, which moves it by at most half a bf16 step,
# 2^-8 of the rounded value; so each bf16 element is held to
# BF16_REL * (|got| + |plain|) + F32_TOL, one rounding on each side.  A
# fixed bf16 limit would not do: at S = 4096 the outputs themselves are
# about 0.02 in size, and a kernel that dropped a few tokens of each row
# would stay within any limit that large
F32_TOL = 2e-5
BF16_REL = 2.0 ** -8
# the paged kernel's log-sum-exp against its plain version's, absolute:
# both are f32 logs of a row's summed exponentials (values of order 10),
# which agree to a few f32 steps; a row that dropped or doubled a token
# moves by far more.  A row of length 0 must carry LSE_EMPTY exactly
PAGED_LSE_TOL = 1e-5
# the deployment cache cut into this many blocks of its sequence, each
# attended with its log-sum-exp and merged (``merge_attention_blocks``)
MERGE_BLOCKS = (2, 4)
GRADS = ("dq", "dk", "dv")

# recsys phases: dlrm-mlperf at its published config
RECSYS_P99_CALLS = 200
RECSYS_BULK_CALLS = 10
RECSYS_RETRIEVAL_CALLS = 5
# card (kernel, cuBLAS) against CPU (plain versions) in float32 with TF32
# off: the two sum the MLPs' products in other orders, which moves scores
# by about 1e-6 of their size (0.005 to 3 here; each arch's mean size is
# reported beside its error)
RECSYS_PARITY_TOL = 1e-4
RECSYS_PARITY_ROWS = 10_000
RECSYS_PARITY_BATCH = 512
RECSYS_PARITY_CANDIDATES = 1000
# bag kernel against its plain version: f32 within the reference's own
# limit (tests/test_kernels.py), bf16 within one rounding of each side
BAG_F32_TOL = 1e-5
BAG_SERVE_B = 262_144        # DLRM's serve launch: serve_bulk's batch
BAG_F32_ROWS = 20_000_000     # 10.24 GB of f32 at D = 128: past 2^31
BAG_DEPLOY_B, BAG_DEPLOY_K = 262_144, 8   # kernel_bench's K
BAG_DIN_ROWS, BAG_DIN_D = 1_000_000, 18   # DIN's items and width
BAG_DIN_B, BAG_DIN_K = 16_384, 100        # and its history length
BAG_BAD_EVERY = 4_099        # one out-of-range id a this many in a rule case
# recsys train: dlrm-mlperf at its published widths; at 16 B a parameter
# (f32 masters, gradients, mu, nu) its 177,944,225 rows need 364 GB, so
# each table is capped at 2^22 rows (23,458,556 rows, 48.0 GB of state)
TRAIN_ROW_CAP = 1 << 22
TRAIN_CTR = 0.5              # labels Bernoulli(TRAIN_CTR)
TRAIN_SEED = 1000            # batch of data cursor c: seed TRAIN_SEED + c
TRAIN_WARMUP_STEPS = 3
TRAIN_TIMED_STEPS = 10
TRAIN_FREE_BYTES = 4 << 30   # left allocated by the earlier phases, at most
TRAIN_PARITY_STEPS = 3       # REDUCED, card against CPU
TRAIN_RESUME_STEPS = 6       # REDUCED, straight against resumed
TRAIN_RESUME_SPLIT = 3
# REDUCED in f32, card against CPU and resumed against straight: losses
# within 1e-5 relative (measured on the CPU against the reference: 2e-7).
# Parameters and optimizer state within 1e-5: the two sides' f32
# gradients differ by summation order, about 1e-9 here, and Adam's step
# turns a gradient difference dg near zero into at most lr * dg / eps,
# 1e-6 a step at the warm-up lr of these steps (1e-5 per step number);
# a missing or wrong gradient moves a parameter by lr a step, 6e-5 over
# three steps
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_TOL = 1e-5
# moe serve: Moonlight-16B-A3B at the repo's full config (48 layers, 64
# experts top-6, 28.55B parameters, 57.1 GB in bf16).  S_max is cut from
# the granite cell's 4,096 to 2,048: 16 slots of 4,096 tokens would take
# 25.8 GB of KV cache, which does not fit beside the weights on 80 GB
MOE_SLOTS = 16
MOE_S_MAX = 2048
MOE_REQUESTS = 32
MOE_PROMPT = (512, 1024)
MOE_NEW = 32
# Qwen3-235B-A22B at its published widths, cut in depth from 94 layers
# to 8: 470 GB of bf16 does not fit one card; 8 layers of 4.98 GB and
# 2.49 GB of untied embeddings are 42.4 GB
QWEN3_LAYERS = 8
QWEN3_SLOTS = 4
QWEN3_S_MAX = 2048
QWEN3_REQUESTS = 8
QWEN3_NEW = 16
SERVE_FREE_BYTES = 4 << 30   # left allocated before a large phase, at most
# lm train: granite-3-2b at its published widths and depth, f32 masters
# and AdamW state (16 B a parameter, 40.5 GB); the reference's train_4k
# batch of 256 x 4,096 is cut to 8 x 4,096, in the bundle's 4 microbatches
LM_TRAIN_BATCH = 8
LM_TRAIN_SEQ = 4096
LM_TRAIN_WARMUP = 2
LM_TRAIN_TIMED = 5
LM_TRAIN_PARITY_STEPS = 3    # REDUCED, card against CPU
# the mesh phase: a one-rank NCCL mesh's granite step against the
# unsharded one, its peak at most this much above that step's
MESH_PEAK_RATIO = 1.05
MESH_MOE_LAYERS = 2              # moonshot-v1-16b-a3b cut to 2 layers
MESH_MOE_BATCH = (2, 1024)       # one microbatch of 2 x 1,024 tokens
MESH_MOE_RTOL = 1e-6             # the CPU mesh tests' relative tolerance
MESH_PSUM_SHAPE = (2048, 8192)   # one of granite's (d, d_ff) gradients
# the serve steps on the mesh: granite's prefill of rows x tokens, then
# MESH_SERVE_STEPS decode steps of those rows on a cache of S_max = the
# prompt's length, each row cut back to a length of its own first
# (MESH_SERVE_LENS) so that every step writes; Moonshot at its published
# widths cut to MESH_SERVE_MOE_LAYERS layers (5.2 GB of bf16 weights,
# the caches and the one-hot dispatch of two runs beside them) on a
# smaller prompt, held within MESH_SERVE_MOE_RTOL of its largest logit
MESH_SERVE_BATCH = (16, 4096)
MESH_SERVE_STEPS = 8
MESH_SERVE_MOE_LAYERS = 4
MESH_SERVE_MOE_BATCH = (8, 1024)
MESH_SERVE_MOE_RTOL = 1e-5
MESH_RECSYS = ("dlrm-mlperf", "two-tower-retrieval")   # tables where rows lie
# two-tower's one-rank step (scripts/mesh_fit.py on an H100 80GB): its
# train_batch of 65,536 runs out of memory whatever the user rows (the
# (B, B) f32 logits' temporaries alone are about 74 GB), and at B 32,768
# its 10M user rows do too (AdamW's f32 temporaries of the 10.24 GB
# table); 2^23 rows peak at 69.3 GB, 9M at 73.6
MESH_TWO_TOWER_BATCH = 32_768
MESH_TWO_TOWER_USERS = 1 << 23
# mesh recsys serve: each recsys arch's three serve cells at published
# widths on a one-rank NCCL mesh against the same calls unsharded.  The
# mesh call's peak of allocated bytes (weights included) at most this
# much above the unsharded call's: the route's own buffers (a lookup's
# gathered ids and partial rows, its reduce-scatter's output) are a few
# percent of a call (the dry run of the one-rank route counts 1.016 for
# DLRM's serve_bulk and 1.069 for two-tower's, 1.000 for the others); a
# copy of any table made by placing or gathering it would be far more
MESH_SERVE_PEAK_RATIO = 1.10
# placing the serving weights on the one-rank mesh is a view: at most
# this many bytes allocated by it
MESH_PLACE_BYTES = 1 << 20
# the archs in the order the check runs them: DLRM on the tables the
# recsys serve phase drew, then the others, DIN's retrieval of 1,000,000
# candidates (68.1 GB of live bytes at its peak, dry run) last
MESH_SERVE_ARCHS = ("dlrm-mlperf", "two-tower-retrieval", "sasrec", "din")

# dry run phase: the card's granite step at LM_TRAIN_BATCH x LM_TRAIN_SEQ
# held to its own dry run, and the cells traced on the CPU (no card:
# launch.dryrun on a fake process group) in three processes side by
# side, each a sequence of launch.dryrun arguments.  The two MoE archs'
# train_4k (about 245 and 60 s of trace on the card's host) are left to
# the CLI run that PERF.md records.
DRYRUN_CELLS = (
    ("--arch moonshot-v1-16b-a3b,qwen3-moe-235b-a22b "
     "--shape prefill_32k,decode_32k,long_500k --mesh single",),
    ("--arch minicpm-2b,granite-3-2b,qwen1.5-4b --mesh single",),
    ("--arch mace,dlrm-mlperf,din,sasrec,two-tower-retrieval --mesh single",
     "--arch granite-3-2b --shape train_4k --mesh multi"),
)
DRYRUN_TIMED = 3             # timed granite steps for the roofline share
# granite's decode step (rows, S_max) on the one-rank mesh held to its dry
# run at that shape
DRYRUN_DECODE = (16, 4096)
DRYRUN_CELLS_TIMEOUT = 600   # s, for the cells' processes
# kernel route against plain route, one microbatch in bf16.  The two
# forwards differ only in the order of f32 sums before each attention
# output's one bf16 rounding, so an output element differs by one bf16
# step (2^-8 of it) where its rounding falls the other way, and by
# nothing elsewhere.  That difference is carried through 40 layers of
# bf16 products, each of which rounds again, and then back through the
# same layers; the gradients of the two routes are two bf16 computations
# of one function, and bf16 training tolerates such differences by
# design.  Held: the loss within 2^-8 relative (one rounding), every
# leaf's gradient within 2^-4 in relative L2 norm (16 roundings' worth,
# the depth of the network at about half a step a layer), and every
# leaf's gradient non-zero.  A wrong backward (scale, mask, GQA sum, a
# dropped dk or dv) moves a leaf's gradient by its own size, 2^0
LM_GRAD_LOSS_RTOL = 2.0 ** -8
LM_GRAD_REL_L2 = 2.0 ** -4
# gnn train: MACE at CONFIG's widths in the bundle's four cells, data
# synthetic from --seed.  Cora and ogbn-products at their published node
# and edge counts; the sampled cell on GraphSAGE's Reddit graph
# (arXiv:1706.02216, as PyG's Reddit has it: 232,965 nodes at mean
# degree 492, about 114.6M edges)
GNN_WARMUP = 2
GNN_TIMED = 5
GNN_PARITY_STEPS = 3         # REDUCED, card against CPU
REDDIT_NODES = 232_965
REDDIT_DEGREE = 492
# E(3) invariance within 1e-4 of the output's largest magnitude (as
# tests/test_models.py asks of the reference); card against CPU at full
# width: the loss within 1e-5 relative, each gradient leaf within 1e-4
# relative L2 (the two sides sum the same f32 terms in other orders)
GNN_INVARIANCE_TOL = 1e-4
GNN_LOSS_RTOL = 1e-5
GNN_GRAD_REL_L2 = 1e-4
# mesh gnn: the cells stepped unsharded and on a one-rank mesh
MESH_GNN = ("full_graph_sm", "molecule")


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


def same_results(ref, got, queries=None) -> List[str]:
    """Element-wise result identity.  With ``queries``, the scanned count
    of a top-k query is not compared: a warm cache serves a whole list as
    one chunk, so early termination skips other amounts."""
    bad = []
    for i, (r, g) in enumerate(zip(ref, got)):
        scanned = queries is not None and queries[i].top_k is not None
        ok = (r.route == g.route
              and np.array_equal(r.docs, g.docs)
              and np.array_equal(r.witnesses, g.witnesses)
              and r.lookups == g.lookups
              and (scanned or r.postings_scanned == g.postings_scanned)
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
    out.update(time_service(svc, queries, device))
    return out


def time_service(svc, queries, device) -> Dict[str, float]:
    """Warm passes of the batch (qps: the median of 3) and each query as
    a batch of its own (per-query p50/p99), on the host clock."""
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
    return {"qps": len(queries) / float(np.median(warm)),
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3}


def device_profile(fn: Callable[[], object], top: int = 8,
                   match: Optional[str] = None) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time, the
    device's busy time summed over its kernels (the busy share is their
    ratio), the top device kernels by time and, with ``match``, the time
    and share of device time of the kernels whose name holds it.
    ``captured`` says whether any device activity came back: a session
    can, rarely, return none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [
        (e.key, e.count, e.self_device_time_total)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_us = sum(k[2] for k in kernels)
    kernels.sort(key=lambda k: -k[2])
    out = {
        "captured": bool(kernels),
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "device_kernels": [{"name": n[:60], "count": c, "ms": us / 1e3}
                           for n, c, us in kernels[:top]],
    }
    if match is not None:
        hit = [k for k in kernels if match in k[0]]
        out[f"{match}_launches"] = sum(k[1] for k in hit)
        out[f"{match}_ms"] = sum(k[2] for k in hit) / 1e3
        out[f"{match}_share_of_device"] = (sum(k[2] for k in hit) / busy_us
                                           if busy_us else 0.0)
    return out


def host_profile(fn: Callable[[], object], top: int = 10) -> List[dict]:
    """The top host functions of one call of ``fn`` by own time
    (cProfile)."""
    import cProfile
    import pstats

    prof_host = cProfile.Profile()
    prof_host.enable()
    fn()
    prof_host.disable()
    stats = pstats.Stats(prof_host).stats
    host = sorted(
        ((f"{Path(fn_[0]).name}:{fn_[2]}", cc, tt)
         for fn_, (cc, nc, tt, ct, callers) in stats.items()),
        key=lambda h: -h[2])[:top]
    return [{"fn": n, "calls": c, "s": t} for n, c, t in host]


def profile_cell(make_source: Callable[[], object], queries, device) -> dict:
    """Where one cold ``cuda`` batch spends its time: device busy time
    against wall time from ``torch.profiler`` (the device's idle share),
    the top device kernels, and the top host functions from cProfile.
    ``make_source`` gives each service its substrate or a fresh fabric."""
    from repro_torch.search import SearchService

    def fresh():
        return SearchService(make_source(), window=3, backend="cuda",
                             device=device)

    svc = fresh()
    dev = device_profile(lambda: svc.search_batch(queries), top=6)
    svc = fresh()
    return {
        "wall_ms": dev["wall_ms"],
        "device_busy_ms": dev["device_busy_ms"],
        "device_idle_share": 1.0 - dev["device_busy_share"],
        "device_kernels": dev["device_kernels"],
        "host_tottime": host_profile(lambda: svc.search_batch(queries)),
    }


class JoinRoundLog:
    """Wraps ``SearchService._join_many``, where a join round is formed,
    for the length of a ``with`` block.  It counts, per backend, the
    rounds with a non-empty pair and those pairs: the ``numpy`` oracle's
    count is what a ``cuda`` run must launch ``sorted_member_mask`` for,
    one launch a round, never one a pair.  It keeps the segments (keys of
    a, distinct docs of b) of the largest round and the largest pair, by
    rows, for the kernel phase."""

    def __init__(self, service_cls):
        self.cls = service_cls
        self.orig = service_cls._join_many
        self.rounds: Dict[str, int] = {}
        self.pairs: Dict[str, int] = {}
        self.round_rows = self.pair_rows = 0
        self.largest_round: Optional[List[List[int]]] = None
        self.largest_pair: Optional[List[int]] = None

    def _record(self, backend: str, pairs) -> None:
        live = [(a, b) for a, b, _ in pairs if a.size and b.size]
        if not live:
            return
        self.rounds[backend] = self.rounds.get(backend, 0) + 1
        self.pairs[backend] = self.pairs.get(backend, 0) + len(live)
        rows = [len(a) + len(b) for a, b in live]
        if sum(rows) > self.round_rows or max(rows) > self.pair_rows:
            sizes = [[len(a), int(np.unique(b[:, 0]).size)] for a, b in live]
            if sum(rows) > self.round_rows:
                self.round_rows, self.largest_round = sum(rows), sizes
            if max(rows) > self.pair_rows:
                self.pair_rows = max(rows)
                self.largest_pair = sizes[int(np.argmax(rows))]

    def __enter__(self):
        def join_many(svc, pairs):
            self._record(str(svc.backend), pairs)
            return self.orig(svc, pairs)
        self.cls._join_many = join_many
        return self

    def __exit__(self, *exc):
        self.cls._join_many = self.orig
        return False


def search_phase(scale: float, device, kernels) -> dict:
    from repro_torch.data.world import (
        HOT_GEOMETRY, build_index_set, build_sharded_index_set,
        make_hot_world, make_world,
    )
    from repro_torch.search import Query, SearchService

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
    joins = JoinRoundLog(SearchService)
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
            before = {k.symbol: k.launches for k in kernels}
            joins.rounds, joins.pairs = {}, {}
            with joins:
                runs = {b: serve(sub, qs, b, device)
                        for b in ("numpy", "cuda")}
            launched = {k.symbol: k.launches - before[k.symbol]
                        for k in kernels}
            rounds = {b: joins.rounds.get(b, 0) for b in runs}
            pairs = {b: joins.pairs.get(b, 0) for b in runs}
            ref, got = runs["numpy"], runs["cuda"]
            routes = sorted({r.route for r in ref["results"]})
            bad = same_results(ref["results"], got["results"])
            if ref["trace"] != got["trace"]:
                bad.append("last_trace differs")
            if ref["io"] != got["io"]:
                bad.append("per-device IOStats differ")
            # the hot cell's pooled top-k streams decode on the device
            if name == "hot" and launched["varint_decode"] == 0:
                bad.append("varint_decode was never launched")
            # one membership launch a join round with a non-empty pair,
            # as the numpy oracle forms them
            if rounds["cuda"] != rounds["numpy"]:
                bad.append(f"join rounds differ: {rounds}")
            if launched["sorted_member_mask"] != rounds["numpy"]:
                bad.append(f"{launched['sorted_member_mask']} "
                           f"sorted_member_mask launches for "
                           f"{rounds['numpy']} join rounds with a "
                           f"non-empty pair ({pairs['numpy']} pairs)")
            read_bytes = sum(d["read_bytes"] for shard in got["io"]
                             for d in shard.values())
            cell = {"world": name, "shards": n_shards, "queries": len(qs),
                    "routes": routes, "build_s": build_s,
                    "read_bytes": read_bytes, "match": not bad,
                    "launches": launched, "join_rounds": rounds["numpy"],
                    "join_pairs": pairs["numpy"]}
            for b, r in runs.items():
                cell[b] = {k: r[k] for k in ("qps", "p50_ms", "p99_ms")}
            report["cells"].append(cell)
            log("search: " + json.dumps(cell))
            failures += [f"{name} x{n_shards}: {b}" for b in bad]
    report["launches"] = {k.symbol: k.launches for k in kernels}
    report["largest"] = {k.symbol: k.largest for k in kernels}
    report["largest_join_round"] = joins.largest_round
    report["largest_join_pair"] = joins.largest_pair
    report["seconds"] = time.perf_counter() - t0
    # after the launch counts are read: profiling runs do not count
    report["profile"] = {}
    for name, (sub, qs) in single.items():
        report["profile"][name] = profile_cell(lambda sub=sub: sub, qs,
                                               device)
        log(f"profile {name}: " + json.dumps(report["profile"][name]))
    for k in kernels:
        if k.launches == 0:
            failures.append(f"{k.symbol} was never launched by the search")
    if not any(set(c["routes"]) >= {"ordinary", "stopseq", "wv", "multi"}
               for c in report["cells"]):
        failures.append("no batch covered all four routes")
    report["failures"] = failures
    # the replica cell's inputs; main takes them out of the report
    report["world"], report["queries"] = world, std_q
    return report


# ------------------------------------------------------ search replica --
def kill_after(n: int, error):
    """A one-shot injected fault: the replica serves ``n`` more ops, then
    dies mid-batch (``tests/test_replica.py::_kill_after``)."""
    served = [0]

    def fault(rep, op):
        served[0] += 1
        if served[0] > n:
            raise error(f"injected after {n} serves ({op})")

    return fault


def replica_io(fab) -> List[List[Dict[str, Dict[str, int]]]]:
    """``fab.io_stats_per_replica()`` as plain values, replica by replica."""
    return [[{name: dataclasses.asdict(st) for name, st in rep.items()}
             for rep in row] for row in fab.io_stats_per_replica()]


def replica_runs(world, queries, device, root: Path,
                 stack: contextlib.ExitStack,
                 backends: Sequence[str] = ("numpy", "cuda")) -> tuple:
    """The "search replica" cell: a durable primary of 2 shards (``set2``,
    every ordinary index, the store's fsync kept) holds ``world.parts[0]``,
    then one compaction cycle and one checkpoint; a replica store opens
    its directory, and one fabric of 2 replicas a shard per backend
    serves ``queries`` three times: with ``s0r0`` dying mid-batch after
    ``REPLICA_KILL_AFTER`` serves (the same point in every fabric), after
    the primary applies ``world.parts[1]`` and the replica store polls
    its WAL, and after ``s0r0`` is revived.  The stores live in ``root``
    and close with ``stack``.  Returns ``(runs, info)``: per backend each
    batch's results, trace (wall clock aside) and per-replica ``IOStats``
    and the catch-up ledgers; ``info`` holds the stores, fabrics and
    services, the store's numbers and the failures of the steps between
    batches."""
    from repro_torch.data.world import bench_index_config
    from repro_torch.search import (
        ReplicaDeadError, ReplicaSetReader, SearchService,
    )
    from repro_torch.store import DurableIndexStore

    cfg = bench_index_config("set2", build_ordinary_all=True)
    lex, failures = world.lexicon, []
    ts = [time.perf_counter()]
    primary = stack.enter_context(
        DurableIndexStore(root / "store", cfg, lex, n_shards=2))
    (toks, offs), doc0 = world.parts[0], world.doc_starts[0]
    primary.add_documents(toks, offs, doc0)
    ts.append(time.perf_counter())
    # one checkpoint, after the cycle (compact() alone would publish one
    # before it as well, since a part is pending)
    primary.compact(checkpoint=False)
    ts.append(time.perf_counter())
    primary.checkpoint()
    ts.append(time.perf_counter())
    replica = stack.enter_context(DurableIndexStore.open_replica(
        root / "store", cfg, lex, n_shards=2))
    ts.append(time.perf_counter())
    info = {"primary": primary, "replica": replica,
            **{f"{step}_s": b - a for step, a, b in zip(
                ("primary_part", "compact", "checkpoint", "replica_open"),
                ts, ts[1:])},
            "replica_recovery": dict(replica.recovery_info),
            "failures": failures}
    if replica.generation_vector() != primary.generation_vector():
        failures.append(f"replica store opened at "
                        f"{replica.generation_vector()}, primary at "
                        f"{primary.generation_vector()}")
    fabs = {b: ReplicaSetReader(replica, n_replicas=2) for b in backends}
    svcs = {b: SearchService(fabs[b], window=3, backend=b, device=device,
                             device_decode=True) for b in backends}
    info["fabrics"], info["services"] = fabs, svcs
    runs = {b: {"batches": []} for b in backends}

    def batch(stage: str) -> None:
        for b in backends:
            res = svcs[b].search_batch(queries)
            runs[b]["batches"].append({
                "stage": stage, "results": res,
                "trace": strip_wall_clock(svcs[b].last_trace),
                "io": replica_io(fabs[b])})

    for fab in fabs.values():
        fab.replicas[0][0].fault = kill_after(REPLICA_KILL_AFTER,
                                              ReplicaDeadError)
    batch("failover")
    (toks, offs), doc0 = world.parts[1], world.doc_starts[1]
    t0 = time.perf_counter()
    primary.add_documents(toks, offs, doc0)
    t1 = time.perf_counter()
    info["polled"] = replica.poll()
    info["second_part_s"] = t1 - t0
    info["poll_s"] = time.perf_counter() - t1
    if info["polled"] <= 0:
        failures.append("the replica store polled no WAL record")
    if replica.generation_vector() != primary.generation_vector():
        failures.append(f"after the poll the replica store is at "
                        f"{replica.generation_vector()}, the primary at "
                        f"{primary.generation_vector()}")
    batch("poll")
    for b, fab in fabs.items():
        info[f"revive_modes_{b}"] = fab.replicas[0][0].revive()
        if fab.replicas[0][0].lag() != 0:
            failures.append(f"{b}: s0r0 lags {fab.replicas[0][0].lag()} "
                            f"generations after its revive")
    batch("revive")
    for b, fab in fabs.items():
        runs[b]["catch_ups"] = [[dict(rep.catch_ups) for rep in row]
                                for row in fab.replicas]
        idle = [f"s{s}r{r}" for s, row in enumerate(fab.replicas)
                for r, rep in enumerate(row) if rep.waves_served == 0]
        if idle:
            failures.append(f"{b}: replicas {idle} served no wave")
    info["store_stats"] = primary.stats()
    return runs, info


def replica_check(ref: dict, got: dict) -> List[str]:
    """Hold one fabric's run of the replica cell against another's: per
    batch equal results, traces key for key (the ``replicas`` block, whose
    staleness bound each service checked as it served, included) and
    per-replica ``IOStats``; a failover in the first batch of each; equal
    catch-up ledgers."""
    bad = []
    if len(ref["batches"]) != len(got["batches"]):
        bad.append(f"{len(ref['batches'])} vs {len(got['batches'])} batches")
    for r, g in zip(ref["batches"], got["batches"]):
        stage = r["stage"]
        bad += [f"{stage}: {m}" for m in same_results(r["results"],
                                                       g["results"])]
        if r["trace"] != g["trace"]:
            bad.append(f"{stage}: last_trace differs")
        if r["io"] != g["io"]:
            bad.append(f"{stage}: per-replica IOStats differ")
    for run in (ref, got):
        if run["batches"][0]["trace"]["replicas"]["failovers_batch"] < 1:
            bad.append("the first batch failed over no replica")
    if ref["catch_ups"] != got["catch_ups"]:
        bad.append(f"catch-up ledgers differ: {ref['catch_ups']} vs "
                   f"{got['catch_ups']}")
    return bad


def replica_phase(world, queries, device, kernels) -> dict:
    """The "search replica" cell on the card: ``replica_runs`` with the
    ``numpy`` and ``cuda`` fabrics, each held against the other
    (``replica_check``) and, after the WAL poll and the revive, against a
    ``numpy`` service over the primary; both search kernels must launch,
    ``sorted_member_mask`` once per join round the ``numpy`` run forms."""
    from repro_torch.search import ReplicaSetReader, SearchService

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="replica-store-") as tmp, \
            contextlib.ExitStack() as stack:
        for k in kernels:
            k.launches = 0
        joins = JoinRoundLog(SearchService)
        with joins:
            runs, info = replica_runs(world, queries, device, Path(tmp),
                                      stack)
            timing = {b: time_service(svc, queries, device)
                      for b, svc in info["services"].items()}
        launched = {k.symbol: k.launches for k in kernels}
        failures = replica_check(runs["numpy"], runs["cuda"])
        failures += info["failures"]
        primary, replica = info["primary"], info["replica"]
        # the acknowledged part is read back from the replica tier
        ref = SearchService(primary, window=3, backend="numpy",
                            device=device).search_batch(queries)
        for b, run in runs.items():
            for bt in run["batches"][1:]:
                failures += [f"{b} {bt['stage']} vs the primary: {m}"
                             for m in same_results(ref, bt["results"],
                                                   queries)]
        rounds = joins.rounds.get("numpy", 0)
        if joins.rounds.get("cuda", 0) != rounds:
            failures.append(f"join rounds differ: {joins.rounds}")
        if launched["varint_decode"] == 0:
            failures.append("varint_decode was never launched")
        if launched["sorted_member_mask"] != rounds:
            failures.append(f"{launched['sorted_member_mask']} "
                            f"sorted_member_mask launches for {rounds} join "
                            f"rounds with a non-empty pair")
        fabs = info["fabrics"]
        last = runs["cuda"]["batches"][-1]["trace"]["replicas"]
        report = {
            "shards": 2, "replicas": 2, "queries": len(queries),
            "launches": launched, "join_rounds": rounds,
            "join_pairs": joins.pairs.get("numpy", 0),
            "timing": timing,
            "failovers_batch": [
                run["batches"][0]["trace"]["replicas"]["failovers_batch"]
                for run in runs.values()],
            "catch_ups": runs["cuda"]["catch_ups"],
            "revive_modes": info["revive_modes_cuda"],
            "waves": last["waves"],
            "read_bytes": {b: fab.read_bytes_per_replica()
                           for b, fab in fabs.items()},
            "store": {k: info[k] for k in (
                "primary_part_s", "compact_s", "checkpoint_s",
                "replica_open_s", "second_part_s", "poll_s", "polled",
                "replica_recovery", "store_stats")},
            "match": not failures,
        }
        # after the launch counts are read: profiling does not count
        report["profile"] = profile_cell(
            lambda: ReplicaSetReader(replica, n_replicas=2), queries, device)
    report["seconds"] = time.perf_counter() - t0
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


def profiler_ms(fn: Callable[[], object], match: Optional[str] = None,
                reps: int = 20, counts: Optional[dict] = None
                ) -> Optional[float]:
    """The mean device time of the kernels named ``match`` (of all its
    kernels, without one) over ``reps`` calls of ``fn``
    (``torch.profiler``): the kernel's own time, where CUDA events over
    calls that the host cannot issue as fast as the device runs them read
    the host's time.  A session that returns no device activity is run
    again, up to three times; then None.

    With ``match``, the launches of those kernels that the session
    captured must be ``reps`` times one call's (a call profiled alone
    first, again up to three times until it holds one of them): a session
    that lost some of them would divide less than ``reps`` calls' time by
    ``reps``.  Where they differ, or no lone call held a launch, the
    reading is None; the counts are logged and, where ``counts`` is
    given, written into it (``one_call``, and ``launches`` and
    ``expected`` of the session over ``reps`` calls)."""
    fn()
    torch.cuda.synchronize()
    one = 0
    for _ in range(3):
        if match is not None and not one:
            one = device_profile(fn, match=match)[f"{match}_launches"]
            if counts is not None:
                counts.update(one_call=one)
            if not one:
                continue
        prof = device_profile(lambda: [fn() for _ in range(reps)],
                              match=match)
        if not prof["captured"]:
            continue
        if match is not None:
            got, want = prof[f"{match}_launches"], reps * one
            if counts is not None:
                counts.update(launches=got, expected=want)
            if got != want:
                log(f"profiler: {got} {match} launches captured over {reps} "
                    f"calls, {want} expected: no reading")
                return None
        key = f"{match}_ms" if match else "device_busy_ms"
        return prof[key] / reps
    if match is not None and not one:
        log(f"profiler: no {match} launch captured in one call: no reading")
    return None


# the wgmma backward's three kernels, by the names the profiler gives
# them: the row pass, dK/dV and dQ
BACKWARD_KERNEL_NAMES = ("row_pass_kernel", "dkdv_wgmma_kernel",
                         "dq_wgmma_kernel")
# the f32 route's: the row pass, each head's dK/dV, their sum over a GQA
# group and dQ (split-TF32 wgmma)
TF32_BACKWARD_KERNEL_NAMES = ("delta_kernel", "dkdv_tf32_kernel",
                              "group_sum_kernel", "dq_tf32_kernel")


def kernel_device_ms(fn: Callable[[], object], names: Sequence[str],
                     reps: int = 5) -> Optional[Dict[str, float]]:
    """The mean device time a call of ``fn`` spends in the kernels whose
    names hold each of ``names`` (``torch.profiler`` over ``reps``
    calls), by name; a profile that returns no device activity is taken
    again, up to three times; then None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [(e.key, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0]
        if kernels:
            return {name: sum(us for key, us in kernels if name in key)
                    / reps / 1e3 for name in names}
    return None


def leb128_bytes(values: np.ndarray) -> np.ndarray:
    """The LEB128 encoding of uint64 ``values``, as one uint8 stream."""
    v = np.asarray(values, dtype=np.uint64)
    widths = np.ones(v.size, dtype=np.int64)
    for k in range(1, 10):
        widths += v >= (np.uint64(1) << np.uint64(7 * k))
    vid = np.repeat(np.arange(v.size), widths)
    rank = np.arange(vid.size) - (np.cumsum(widths) - widths)[vid]
    payload = (v[vid] >> (7 * rank).astype(np.uint64)) & np.uint64(0x7F)
    more = (rank < widths[vid] - 1).astype(np.uint64) << np.uint64(7)
    return (payload | more).astype(np.uint8)


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


def values_of_widths(widths: np.ndarray, rng) -> np.ndarray:
    """uint64 values whose LEB128 encodings are ``widths`` (1..10) bytes:
    random low bits under the top bit of the last 7-bit group."""
    w = np.asarray(widths, dtype=np.uint64)
    bits = np.frombuffer(rng.bytes(8 * w.size), dtype=np.uint64)
    span = np.minimum(7 * w, 64)
    mask = np.where(span == 64, ~np.uint64(0),
                    (np.uint64(1) << (span % np.uint64(64))) - np.uint64(1))
    top = np.where(w > 1, np.uint64(1) << (7 * (w - np.uint64(1))),
                   np.uint64(0))
    return (bits & mask) | top


def decode_case(raw: np.ndarray, device, expect: Optional[np.ndarray] = None,
                offset: int = 0, host: bool = False,
                n_values: Optional[int] = None) -> dict:
    """``varint_decode`` against its plain version on the card, bit for
    bit (and against ``expect``), timed with CUDA events beside its bound,
    the plain version and ``index_add_`` over the host's prepared payloads
    (step 3 only, into an output made outside its timing); the kernel's
    own device time comes from ``torch.profiler``.  ``offset`` places the
    stream that many bytes into its allocation (an unaligned base);
    ``n_values`` (default: the stream's count of values) may exceed that
    count, leaving the ids past it 0.  ``host`` adds the host time of
    ``unpack_varints`` under the ``cuda`` backend (one raw-byte copy and
    launch) and the ``torch`` backend (the old path: host byte prep, two
    int64 copies, ``index_add_``)."""
    from repro_torch.kernels.posting_decode.kernel import (
        varint_decode, varint_decode_plain,
    )
    from repro_torch.kernels.posting_decode.ops import unpack_varints
    from repro_torch.kernels.posting_decode.ref import byte_prep

    n, count = raw.size, int(np.count_nonzero(raw < 0x80))
    n_values = count if n_values is None else n_values
    store = torch.empty(n + offset, dtype=torch.uint8, device=device)
    buf = store[offset:]
    buf.copy_(torch.from_numpy(raw.copy()))
    got = varint_decode(buf, n_values)
    plain = varint_decode_plain(buf, n_values)
    torch.cuda.synchronize()
    ok = bool(torch.equal(got, plain))
    if expect is not None:
        ok = ok and np.array_equal(got.cpu().numpy(), expect)
    contrib, vid, _ = byte_prep(raw)
    vid_t = torch.from_numpy(vid).to(device)
    contrib_t = torch.from_numpy(contrib).to(device)
    lib_out = torch.zeros(count, dtype=torch.int64, device=device)
    case = {
        "shape": [n, n_values], "base_offset": offset,
        "bit_identical": ok,
        "max_abs_err": int((got - plain).abs().max()) if n_values else 0,
        "ms": cuda_ms(lambda: varint_decode(buf, n_values)),
        "plain_ms": cuda_ms(lambda: varint_decode_plain(buf, n_values)),
        "library_ms": cuda_ms(lambda: lib_out.index_add_(0, vid_t, contrib_t)),
        "library": "index_add_ of the host-prepared payloads: step 3 only",
        "bound_ms": varint_cost(n, n_values).bound_ms(),
        "bound_by": varint_cost(n, n_values).bound_by(),
    }
    if n:
        case["profiler_kernel_ms"] = profiler_ms(
            lambda: varint_decode(buf, n_values), "varint_decode")
    if host:
        for backend in ("cuda", "torch"):
            unpack_varints(raw, backend=backend, device=device)
            times = []
            for _ in range(50):
                t0 = time.perf_counter()
                unpack_varints(raw, backend=backend, device=device)
                times.append(time.perf_counter() - t0)
            case[f"unpack_{backend}_host_ms"] = float(np.median(times)) * 1e3
    return case


def member_bound(n: int, m: int, segments: int) -> tuple:
    """The least time of a membership launch and what sets it
    (``costs.member_cost``)."""
    cost = member_cost(n, m, segments)
    return cost.bound_ms(), cost.bound_by()


def member_case(a: torch.Tensor, a_off: np.ndarray, b: torch.Tensor,
                b_off: np.ndarray, routes: bool = False) -> dict:
    """``sorted_member_mask_segments`` against its plain version and
    ``torch.isin`` (over segment tags where there is more than one
    segment) on the card, bit for bit, timed with CUDA events and
    ``torch.profiler``'s kernel time beside its bound, the plain version
    and ``torch.isin``.  Both routes are checked bit for bit; with
    ``routes``, each is timed too."""
    from repro_torch.kernels.intersect.kernel import (
        member_route, run_member_mask, segment_tags,
        sorted_member_mask_segments, sorted_member_mask_segments_plain,
    )

    n, m, S = a.numel(), b.numel(), a_off.size - 1

    def call():
        return sorted_member_mask_segments(a, a_off, b, b_off)

    got = call()
    plain = sorted_member_mask_segments_plain(a, a_off, b, b_off)
    ta, tb = segment_tags(a, a_off, b, b_off)
    lib = torch.isin(ta, tb)
    torch.cuda.synchronize()
    ok = bool(torch.equal(got, plain)) and bool(torch.equal(got, lib))
    bound_ms, bound_by = member_bound(n, m, S)
    case = {
        "shape": [n, m, S], "route": member_route(n, m, S),
        "hits": int(plain.sum()),
        "max_abs_err": int((got.int() - plain.int()).abs().max()) if n else 0,
        "ms": cuda_ms(call),
        "profiler_kernel_ms": profiler_ms(call, "member_") if n else None,
        "plain_ms": cuda_ms(
            lambda: sorted_member_mask_segments_plain(a, a_off, b, b_off)),
        "library_ms": cuda_ms(lambda: torch.isin(ta, tb)),
        "library": "torch.isin" + (" over segment tags" if S > 1 else ""),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    case["routes"] = {}
    for route in ("search", "merge"):
        def launch(route=route):
            return run_member_mask(a, a_off, b, b_off, route)

        r = {"bit_identical": bool(torch.equal(launch(), plain))}
        ok = ok and r["bit_identical"]
        if routes and n:
            r["ms"] = cuda_ms(launch)
            r["profiler_kernel_ms"] = profiler_ms(launch, "member_")
            if route == "merge":   # of which the tile-edge partition pass
                r["partition_ms"] = profiler_ms(launch, "member_partition")
        case["routes"][route] = r
    case["bit_identical"] = ok
    return case


def joined_segments(a_parts: list, b_parts: list) -> tuple:
    """Per-segment key arrays as host (a, a_off, b, b_off), int64."""
    def join(parts):
        off = np.cumsum([0] + [p.size for p in parts], dtype=np.int64)
        return np.concatenate(parts).astype(np.int64), off
    return (*join(a_parts), *join(b_parts))


def member_segments(shapes: Sequence[tuple], rng, hi_per_key: int = 4,
                    base: int = 0, repeat_mean: float = 1.0) -> tuple:
    """Sorted segments of the given (keys of a, keys of b): b distinct, a
    in runs of a repeated key of geometric length with mean
    ``repeat_mean``, keys from ``base`` over about ``hi_per_key`` ids a
    key.  Returns host (a, a_off, b, b_off)."""
    a_parts, b_parts = [], []
    for n, m in shapes:
        span = hi_per_key * max(n, m, 1)
        gap = max(2, 2 * span // max(m, 1))     # distinct b over the span
        b_parts.append(base + np.cumsum(rng.randint(1, gap, m)) - 1)
        docs = base + np.sort(rng.randint(0, span, n))
        if repeat_mean > 1.0 and n:
            docs = np.repeat(docs, rng.geometric(1.0 / repeat_mean, n))[:n]
        a_parts.append(docs)
    return joined_segments(a_parts, b_parts)


def member_edges(tile: int, n_tiles: int = 4, base: int = 0) -> tuple:
    """Segments where the kernel's edges are.  A one-key segment shifts
    the next one, whose a and b are the same keys, so the merge alternates
    a, b and every tile edge falls between a key of a and its equal in b
    (the staged b past the range decides it).  Then segments whose a keys
    all equal the first key of the next segment's b (only the clamp to a
    segment's own b keeps them out), sized round half a tile, with an
    empty a and an empty b among them, so tile edges fall on segment
    boundaries too.  Returns host (a, a_off, b, b_off)."""
    keys = base + 3 * np.arange(tile * n_tiles // 2 + 3, dtype=np.int64)
    a_parts, b_parts = [np.array([base - 5])], [np.zeros(0, np.int64)]
    a_parts.append(keys)
    b_parts.append(keys)
    k = int(keys[-1]) + 10
    for size in (tile // 2 - 1, tile // 2, tile // 2 + 1, 1, 0, 7):
        top = k + size + 1
        a_parts += [np.full(size, top), np.arange(top, top + size)]
        b_parts += [np.arange(k, k + size), np.arange(top, top + size + 1)]
        k = top + size + 10
    a_parts.append(np.arange(k, k + 3))
    b_parts.append(np.zeros(0, np.int64))
    return joined_segments(a_parts, b_parts)


def member_ratio_keys(b: np.ndarray, ratio: int, rng) -> np.ndarray:
    """Sorted keys of a, one for each ``ratio`` keys of the sorted
    distinct ``b`` (so that M = ratio N, rounded down): keys of b drawn at
    random, half of them moved up by one and so, where b has a gap there,
    not in it."""
    n = b.size // ratio
    a = b[np.sort(rng.choice(b.size, n, replace=False))]
    return a + rng.randint(0, 2, n)


def member_phase(search: dict, device) -> Dict[str, dict]:
    """``sorted_member_mask`` at the largest pair and round the search
    gave it, at 2^24 in 2^24 (distinct keys, and posting docs in runs of
    mean 4), skewed both ways, over 4,096 segments of 4,096 in 4,096, at
    the edges (ties at tile and segment edges, empty sides, keys past
    2^40, N = 0, M = 0), and over b of 2^24 with a on either side of the
    route threshold; both routes timed at 2^24 in 2^24 and there."""
    from repro_torch.kernels.intersect.kernel import MERGE_ITEMS, SEARCH_RATIO

    rng = np.random.RandomState(13)

    def on_card(a, a_off, b, b_off, routes=False):
        return member_case(torch.from_numpy(a).to(device), a_off,
                           torch.from_numpy(b).to(device), b_off, routes)

    cases: Dict[str, dict] = {}
    pair = search.get("largest_join_pair") or (4096, 4096)
    cases["search_pair"] = on_card(*member_segments([tuple(pair)], rng))
    shapes = search.get("largest_join_round") or [(64, 64)] * 19
    cases["round"] = on_card(*member_segments([tuple(x) for x in shapes], rng))
    a, a_off, b, b_off = member_segments([(DEPLOY_N, DEPLOY_N)], rng)
    cases["deploy"] = on_card(a, a_off, b, b_off, routes=True)
    b_deploy = b
    cases["posting_docs"] = on_card(*member_segments(
        [(DEPLOY_N, DEPLOY_N)], rng, repeat_mean=4.0))
    cases["skew_small_a"] = on_card(*member_segments(
        [(1 << 14, DEPLOY_N)], rng))
    cases["skew_small_b"] = on_card(*member_segments(
        [(DEPLOY_N, 1 << 14)], rng))
    cases["segments_4096"] = on_card(*member_segments(
        [(4096, 4096)] * 4096, rng))
    tile = 256 * MERGE_ITEMS
    cases["edges"] = on_card(*member_edges(tile, base=(1 << 40) + 7))
    cases["edges_small"] = on_card(*member_edges(64, base=3))
    empty = np.zeros(0, np.int64)
    cases["n_zero"] = on_card(empty, np.zeros(4, np.int64),
                              np.arange(30, dtype=np.int64),
                              np.array([0, 10, 10, 30], np.int64))
    cases["m_zero"] = on_card(np.arange(50, dtype=np.int64),
                              np.array([0, 20, 50], np.int64), empty,
                              np.zeros(3, np.int64))
    # either side of the route threshold: b of 2^24, a of one key for
    # each ratio keys of b
    for ratio in (SEARCH_RATIO // 2, SEARCH_RATIO):
        a = member_ratio_keys(b_deploy, ratio, rng)
        cases[f"ratio_{ratio}"] = on_card(
            a, np.array([0, a.size], np.int64), b_deploy,
            np.array([0, b_deploy.size], np.int64), routes=True)
    return cases


def kernel_phase(search: dict, device) -> Dict[str, dict]:
    rng = np.random.RandomState(3)
    largest = search["largest"]
    out: Dict[str, dict] = {}

    # varint_decode at the largest search shape, 2^24 postings, a stream
    # of 5- to 10-byte varints over many tiles (aligned and not, and with
    # 100 ids asked for past its last value), one byte and nothing.  A
    # kernel the search never launched has failed
    # already; it is still checked, at a small shape
    n, n_values = largest["varint_decode"] or (4096, 2048)
    values = values_of_widths(widths_for(n, n_values, rng), rng)
    raw = leb128_bytes(values)
    assert raw.size == n, (raw.size, n)
    cases = {"search": decode_case(raw, device, values.view(np.int64),
                                   host=True)}
    docs_delta = rng.geometric(0.5, DEPLOY_N) - 1
    pos = rng.randint(0, 4096, DEPLOY_N)
    vals = np.stack([docs_delta, pos], axis=1).reshape(-1)
    cases["deploy"] = decode_case(leb128_bytes(vals), device, vals)
    del docs_delta, pos, vals
    values = values_of_widths(rng.randint(5, 11, STRADDLE_VALUES), rng)
    raw = leb128_bytes(values)
    cases["straddle"] = decode_case(raw, device, values.view(np.int64))
    cases["straddle_unaligned"] = decode_case(raw, device,
                                              values.view(np.int64), offset=3)
    past = np.concatenate([values.view(np.int64), np.zeros(100, np.int64)])
    cases["past_the_stream"] = decode_case(raw, device, past,
                                           n_values=past.size)
    cases["one_byte"] = decode_case(np.array([0x55], np.uint8), device,
                                    np.array([0x55]))
    cases["empty"] = decode_case(np.zeros(0, np.uint8), device,
                                 np.zeros(0, np.int64))
    out["varint_decode"] = cases

    out["sorted_member_mask"] = member_phase(search, device)
    return out


# --------------------------------------------------------------- serve --
def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    return [tree]


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def percentiles_ms(xs: Sequence[float]) -> Dict[str, float]:
    return {"p50_ms": float(np.percentile(xs, 50)) * 1e3,
            "p99_ms": float(np.percentile(xs, 99)) * 1e3,
            "n": len(xs)}


class StepTimer:
    """Wraps the engine module's ``prefill`` and ``decode_step`` with
    synchronised host-clock timers and a finiteness check of the logits,
    for the length of a ``with`` block; for an MoE config it also keeps
    each call's picks dropped by capacity (the cache's ``moe_dropped``)."""

    def __init__(self, engine_mod):
        self.mod = engine_mod
        self.orig = (engine_mod.prefill, engine_mod.decode_step)
        self.prefill_s: List[float] = []
        self.decode_s: List[float] = []
        self.finite: List[torch.Tensor] = []
        self.dropped: Dict[str, List[float]] = {"prefill": [], "decode": []}

    def _wrap(self, fn, times, kind):
        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = fn(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            self.finite.append(torch.isfinite(logits).all())
            if "moe_dropped" in cache:
                self.dropped[kind].append(float(cache["moe_dropped"]))
            return logits, cache
        return timed

    def __enter__(self):
        self.mod.prefill = self._wrap(self.orig[0], self.prefill_s, "prefill")
        self.mod.decode_step = self._wrap(self.orig[1], self.decode_s,
                                          "decode")
        return self

    def __exit__(self, *exc):
        self.mod.prefill, self.mod.decode_step = self.orig
        return False


def serve_requests(Request, vocab: int, n: int, rng,
                   prompt: Sequence[int] = SERVE_PROMPT,
                   new: int = SERVE_NEW) -> list:
    return [Request(req_id=i,
                    prompt=rng.randint(0, vocab, rng.randint(
                        prompt[0], prompt[1] + 1)).astype(np.int32),
                    max_new_tokens=new)
            for i in range(n)]


def profile_decode_step(engine, Request, device) -> dict:
    """Device busy share over one decode step with every slot active
    (``torch.profiler``), then the top host functions of the next one
    (cProfile)."""
    for r in serve_requests(Request, engine.cfg.vocab, engine.slots,
                            np.random.RandomState(12), SERVE_PROMPT,
                            SERVE_NEW):
        engine.submit(r)
    engine.step()   # admits (prefills) every slot and decodes once
    torch.cuda.synchronize()
    active = sum(r is not None for r in engine.slot_req)
    dev = device_profile(engine.step)
    # the host's share: one more step under cProfile, its top functions
    t0 = time.perf_counter()

    def step():
        engine.step()
        torch.cuda.synchronize()

    host = host_profile(step)
    host_wall_s = time.perf_counter() - t0
    return {
        "active_slots": active,
        "cprofile_wall_ms": host_wall_s * 1e3,
        "host_tottime": host,
        **dev,
    }


def profile_prefill(engine_mod, cfg, params, device) -> dict:
    """Device busy share over one prefill of the longest serve prompt
    (``torch.profiler``), with the flash kernels' time in it."""
    prompt = torch.as_tensor(
        np.random.RandomState(14).randint(0, cfg.vocab, SERVE_PROMPT[1]),
        device=device)[None, :]
    return {"prompt_tokens": SERVE_PROMPT[1],
            **device_profile(lambda: engine_mod.prefill(cfg, params, prompt),
                             match="flash_attention")}


def serve_cell(cfg, params, device, kernels, label: str, *, slots: int,
               s_max: int, n_requests: int, prompt: Sequence[int],
               new: int, setup_s: float) -> tuple:
    """``ServeEngine`` over ``params`` (``slots`` slots of ``s_max``
    tokens in SERVE_PAGE-token pages): a warm-up on a one-slot engine of
    the same weights (cuBLAS handles, the allocator, the kernels' first
    launches; its launches do not count), then ``n_requests`` requests of
    ``prompt`` tokens (a range) and ``new`` new tokens each, every
    prefill and decode step timed.  bf16 prefill at D 64 or 128 takes the
    wgmma route only: the wgmma flash kernel must launch once per layer
    and prefill, the paged kernel once per layer and decode step, the
    f32-route flash kernel never.  Returns the report (its ``failures``
    included) and the engine."""
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.engine import Request, ServeEngine

    weights = tree_leaves(params)
    engine = ServeEngine(cfg, params, batch_slots=slots, s_max=s_max,
                         page_size=SERVE_PAGE, chain_limit=SERVE_CHAIN,
                         device=device)
    t0 = time.perf_counter()
    warm = ServeEngine(cfg, params, batch_slots=1, s_max=128,
                       page_size=SERVE_PAGE, device=device)
    warm.submit(Request(req_id=0, prompt=np.arange(64, dtype=np.int32),
                        max_new_tokens=3))
    warm.run_until_done()
    del warm
    torch.cuda.synchronize()
    setup_s += time.perf_counter() - t0
    reqs = serve_requests(Request, cfg.vocab, n_requests,
                          np.random.RandomState(11), prompt, new)
    for r in reqs:
        engine.submit(r)
    weight_bytes = sum(t.numel() * t.element_size() for t in weights)
    kv_bytes = engine.cache["k"].numel() * 2 * engine.cache["k"].element_size()
    log(f"{label}: {cfg.name}, {cfg.params_dense:,} parameters "
        f"({weight_bytes:,} B), KV cache {kv_bytes:,} B, {len(reqs)} "
        f"requests, set-up {setup_s:.1f} s")

    for k in kernels:
        k.launches = 0
        k.largest = None
    phase_peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    with StepTimer(engine_mod) as timer:
        t0 = time.perf_counter()
        done = engine.run_until_done(max_steps=100_000)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels}
    largest = {k.symbol: k.largest for k in kernels}

    failures: List[str] = []
    tokens = sum(len(r.out_tokens) for r in done)
    if len(done) != len(reqs):
        failures.append(f"{label}: {len(done)} of {len(reqs)} requests done")
    if any(len(r.out_tokens) != new for r in done):
        failures.append(f"{label}: a request stopped short of its new tokens")
    if any(not 0 <= t < cfg.vocab for r in done for t in r.out_tokens):
        failures.append(f"{label}: a token id outside the vocabulary")
    if not all(bool(f) for f in timer.finite):
        failures.append(f"{label}: non-finite logits")
    expect = {"flash_attention_wgmma": cfg.n_layers * len(timer.prefill_s),
              "paged_attention": cfg.n_layers * len(timer.decode_s)}
    for name, n in expect.items():
        if launches.get(name, 0) == 0:
            failures.append(f"{name} was never launched by {label}")
        elif launches[name] != n:
            failures.append(f"{label}: {name}: {launches[name]} launches, "
                            f"{n} expected (one per layer and call)")
    if launches.get("flash_attention", 0) != 0:
        failures.append(f"{label}: flash_attention (f32 route) launched "
                        f"{launches['flash_attention']} times in bf16 serving")
    decode_tokens = tokens - len(timer.prefill_s)
    report = {
        "arch": cfg.name, "params": cfg.params_dense,
        "params_active": cfg.params_active, "layers": cfg.n_layers,
        "weight_bytes": weight_bytes, "kv_bytes": kv_bytes,
        "requests": len(reqs), "slots": slots, "s_max": s_max,
        "page_size": SERVE_PAGE, "chain_limit": SERVE_CHAIN,
        "prompt_range": list(prompt), "new_tokens": new,
        "prompt_tokens": int(sum(r.prompt.shape[0] for r in reqs)),
        "generated_tokens": tokens, "steps": engine.steps,
        "wall_s": wall_s, "setup_s": setup_s,
        "tokens_per_s": tokens / wall_s,
        "decode_tokens_per_s": decode_tokens / sum(timer.decode_s),
        "prefill": percentiles_ms(timer.prefill_s),
        "decode_step": percentiles_ms(timer.decode_s),
        "prefill_s_total": sum(timer.prefill_s),
        "decode_s_total": sum(timer.decode_s),
        "launches": launches, "largest": largest,
        "kv": engine.stats(),
        # the phase's peak (weights drawn, warm-up) and the serving run's
        "peak_mem_bytes": max(phase_peak,
                              torch.cuda.max_memory_allocated(device)),
        "serve_peak_mem_bytes": torch.cuda.max_memory_allocated(device),
        "failures": failures,
    }
    if cfg.moe is not None:
        report["dropped"] = {
            kind: {"calls": len(xs), "total": float(sum(xs)),
                   "mean": float(np.mean(xs)) if xs else 0.0,
                   "max": float(max(xs)) if xs else 0.0,
                   "picks_per_call_mean": float(np.mean(
                       picks)) if picks else 0.0}
            for kind, xs, picks in (
                ("prefill", timer.dropped["prefill"],
                 [r.prompt.shape[0] * cfg.moe.top_k * cfg.n_layers
                  for r in reqs]),
                ("decode", timer.dropped["decode"],
                 [slots * cfg.moe.top_k * cfg.n_layers]
                 * len(timer.dropped["decode"])))}
    return report, engine


def serve_phase(device, kernels) -> dict:
    """granite-3-2b at its published widths through ``ServeEngine``."""
    from repro_torch.configs.granite_3_2b import CONFIG
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.engine import Request

    cfg = CONFIG
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    report, engine = serve_cell(
        cfg, params, device, kernels, "serve", slots=SERVE_SLOTS,
        s_max=SERVE_S_MAX, n_requests=SERVE_REQUESTS, prompt=SERVE_PROMPT,
        new=SERVE_NEW, setup_s=time.perf_counter() - t0)
    # after the launch counts are read: profiling does not count
    report["profile"] = profile_decode_step(engine, Request, device)
    report["prefill_profile"] = profile_prefill(engine_mod, cfg, params,
                                                device)
    return report


def teacher_forced(cfg, params, device, kernels, specs, kw) -> dict:
    """``cfg`` served on the card (through the kernels, ``kernels``'
    counts read over that run), then replayed on the CPU (through the
    plain versions) with the card's tokens forced: the largest logit
    difference over every selection, both engines' ``stats()`` and
    tokens and, for an MoE config, every ``moe_apply`` call's expert
    picks and dropped count on each side."""
    from repro_torch.models import transformer as tf_mod
    from repro_torch.serve.engine import Request, ServeEngine

    recorded: List[tuple] = []
    errs: List[float] = []
    routes: Dict[str, list] = {"card": [], "cpu": []}

    class Recording(ServeEngine):
        def _select(self, logits):
            picks = super()._select(logits)
            recorded.append((logits.float().cpu(), picks))
            return picks

    class Replaying(ServeEngine):
        def _select(self, logits):
            want, picks = recorded[len(errs)]
            errs.append(float((logits.float() - want).abs().max()))
            return picks

    def serve(engine, side):
        orig = tf_mod.moe_apply

        def routed(*args, **kw_):
            y, aux = orig(*args, **kw_)
            routes[side].append((aux["experts"].cpu(),
                                 float(aux["dropped_tokens"])))
            return y, aux

        tf_mod.moe_apply = routed
        try:
            for i, (prompt, n) in enumerate(specs):
                engine.submit(Request(req_id=i, prompt=prompt,
                                      max_new_tokens=n))
            return engine.run_until_done(max_steps=1000), engine.stats()
        finally:
            tf_mod.moe_apply = orig

    for k in kernels:
        k.launches = 0
    card_done, card_stats = serve(Recording(cfg, params, device=device, **kw),
                                  "card")
    launches = {k.symbol: k.launches for k in kernels}
    cpu_done, cpu_stats = serve(Replaying(cfg, tree_to(params, "cpu"),
                                          device="cpu", **kw), "cpu")
    same_routes = (len(routes["card"]) == len(routes["cpu"]) and all(
        torch.equal(a[0], b[0]) for a, b in zip(routes["card"],
                                                routes["cpu"])))
    return {"errs": errs, "selections": len(recorded),
            "card_stats": card_stats, "cpu_stats": cpu_stats,
            "same_tokens": [r.out_tokens for r in card_done]
            == [r.out_tokens for r in cpu_done],
            "launches": launches, "moe_calls": len(routes["card"]),
            "same_experts": same_routes,
            "dropped": [sum(d for _, d in routes[side])
                        for side in ("card", "cpu")]}


def parity_failures(label: str, run: dict, expect: Dict[str, int]) -> List[str]:
    """What :func:`teacher_forced` found wrong: logits past PARITY_TOL,
    differing stats, tokens, expert picks or drops, or launch counts
    other than ``expect``."""
    failures = []
    if len(run["errs"]) != run["selections"]:
        failures.append(f"{label}: {len(run['errs'])} CPU selections, "
                        f"{run['selections']} on the card")
    if max(run["errs"]) > PARITY_TOL:
        failures.append(f"{label}: logits differ by {max(run['errs'])} > "
                        f"{PARITY_TOL}")
    if run["card_stats"] != run["cpu_stats"]:
        failures.append(f"{label}: stats differ: {run['card_stats']} vs "
                        f"{run['cpu_stats']}")
    if not run["same_tokens"]:
        failures.append(f"{label}: tokens differ")
    if not run["same_experts"]:
        failures.append(f"{label}: the card and the CPU picked other experts")
    if run["dropped"][0] != run["dropped"][1]:
        failures.append(f"{label}: dropped_tokens {run['dropped'][0]} on the "
                        f"card, {run['dropped'][1]} on the CPU")
    for name, n in expect.items():
        if run["launches"].get(name) != n:
            failures.append(f"{label}: {name} launched "
                            f"{run['launches'].get(name)} times in f32 "
                            f"serving, {n} expected")
    return failures


def parity_specs(vocab: int, seed: int) -> list:
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, rng.randint(40, 200)).astype(np.int32), 12)
            for _ in range(6)]


def parity_phase(device, kernels) -> dict:
    """granite-3-2b widths at 2 layers in float32: served on the card, then
    replayed on the CPU with the card's tokens forced (teacher forcing);
    every step's logits and the engines' ``stats()`` must agree.  f32
    prefill is the f32-route flash kernel's path: ``kernels``' counts are
    read over the card's run, and the f32-route kernel must launch once per
    layer and prompt, the wgmma kernel never."""
    from repro_torch.configs.granite_3_2b import CONFIG
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(CONFIG, n_layers=2, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(1))
    kw = dict(batch_slots=4, s_max=512, page_size=SERVE_PAGE, chain_limit=3)
    specs = parity_specs(cfg.vocab, 13)
    t0 = time.perf_counter()
    run = teacher_forced(cfg, params, device, kernels, specs, kw)
    failures = parity_failures("parity", run, {
        "flash_attention": cfg.n_layers * len(specs),
        "flash_attention_wgmma": 0})
    return {"selections": run["selections"],
            "max_abs_logit_err": max(run["errs"]),
            "launches": run["launches"],
            "tolerance": PARITY_TOL, "stats": run["card_stats"],
            "steps": run["card_stats"]["steps"],
            "seconds": time.perf_counter() - t0,
            "failures": failures}


# ----------------------------------------------------- attention kernels --
def elementwise_check(got: torch.Tensor, plain: torch.Tensor,
                      f32_tol: float) -> dict:
    """Element-wise agreement of a kernel's output with its plain
    version's: the largest error, its ratio to the element's limit (at
    most 1 to pass) and the outputs' mean size beside them.  f32 within
    ``f32_tol``; bf16 within one rounding of each side plus that."""
    g, p = got.float(), plain.float()
    err = (g - p).abs()
    if got.dtype == torch.bfloat16:
        limit = BF16_REL * (g.abs() + p.abs()) + f32_tol
        tolerance = f"2^-8*(|got|+|plain|)+{f32_tol}"
    else:
        limit = torch.full_like(err, f32_tol)
        tolerance = f"{f32_tol}"
    ratio = float((err / limit).max())
    return {"max_abs_err": float(err.max()), "max_err_ratio": ratio,
            "mean_abs_out": float(p.abs().mean()), "tolerance": tolerance,
            "within_tolerance": ratio <= 1.0}


def attention_check(got: torch.Tensor, plain: torch.Tensor) -> dict:
    return elementwise_check(got, plain, F32_TOL)


def backward_check(got: Sequence[torch.Tensor],
                   plain: Sequence[torch.Tensor]) -> dict:
    """A backward kernel's (dq, dk, dv) against the plain backward's on
    the same operands, each element by element as ``attention_check``
    holds an output: f32 within F32_TOL, bf16 within one rounding of
    each side plus F32_TOL (the emulation of the kernel's arithmetic in
    ``tests/test_torch_flash_backward.py`` passes this limit; with P and
    dS rounded once it does not)."""
    checks = {name: attention_check(g, p)
              for name, g, p in zip(GRADS, got, plain)}
    return {**checks, "within_tolerance": all(
        c["within_tolerance"] for c in checks.values())}


def flash_inputs(B: int, H: int, Hkv: int, S: int, D: int, dtype,
                 gen: torch.Generator, device, views: bool = False):
    """Seeded q (B, H, S, D) and k, v (B, Hkv, S, D).  ``views``: made
    (B, S, heads, D) and transposed, as ``models.attention.attention``
    passes the projections to the kernel."""
    def draw(heads):
        if views:
            return torch.randn(B, S, heads, D, generator=gen,
                               device=device).to(dtype).transpose(1, 2)
        return torch.randn(B, heads, S, D, generator=gen,
                           device=device).to(dtype)
    return draw(H), draw(Hkv), draw(Hkv)


def lse_check(got: torch.Tensor, plain: torch.Tensor) -> dict:
    """A forward kernel's base-2 log-sum-exp against the plain version's,
    within F32_TOL * (1 + |plain|): both are f32 sums of S exponentials,
    which agree to a few f32 steps; a wrong row is off by far more."""
    err = (got - plain).abs()
    ratio = float((err / (F32_TOL * (1 + plain.abs()))).max())
    return {"max_abs_err": float(err.max()), "max_err_ratio": ratio,
            "tolerance": f"{F32_TOL}*(1+|plain|)",
            "within_tolerance": ratio <= 1.0}


def flash_case(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, kernel) -> dict:
    """``kernel`` (either flash route, through ``run_kernel``) against the
    plain version on the same operands, timed beside its bound and SDPA;
    the log-sum-exp it writes for the backward (``lse``) against the
    plain version's too.  The timed launches write none, as serving's."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import run_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    B, H, S, D = q.shape
    Hkv = k.shape[1]
    got, got_lse = run_kernel(kernel, q, k, v, causal, return_lse=True)
    plain, plain_lse = flash_attention_plain(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    check = attention_check(got, plain)
    lse = lse_check(got_lse, plain_lse)
    check["within_tolerance"] = check["within_tolerance"] and \
        lse["within_tolerance"]
    del got, plain, got_lse, plain_lse
    # the yardstick gets K/V expanded to H heads, outside its timing
    ke = k.repeat_interleave(H // Hkv, dim=1)
    ve = v.repeat_interleave(H // Hkv, dim=1)
    cost = flash_cost(B, H, Hkv, S, D, q.dtype, causal)
    flops, nbytes = cost.flops, cost.nbytes
    ms = cuda_ms(lambda: run_kernel(kernel, q, k, v, causal))
    return {
        "kernel": kernel.symbol,
        "shape": [B, H, Hkv, S, D], "dtype": str(q.dtype).split(".")[-1],
        "causal": causal, "strides": [list(t.stride()) for t in (q, k, v)],
        **check, "lse": lse,
        "ms": ms,
        "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v, causal)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=causal)),
        "bound_ms": cost.bound_ms(), "bound_by": cost.bound_by(),
        "tflops": flops / ms / 1e9,
        "flops": flops, "bytes": nbytes,
    }


def paged_case(R: int, G: int, D: int, page: int, max_pages: int,
               lengths: np.ndarray, dtype, gen: torch.Generator, device,
               shuffled: bool, cold: bool = False) -> dict:
    """The paged kernel against its plain version, timed beside its
    bound and SDPA on K/V gathered outside its timing.  ``cold`` also
    times it over copies of the pools, taken in turn, whose K/V read sets
    total more than twice the 50 MB L2, so each call finds its K/V cold
    as a decode step does (each layer reads its own cache)."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention, paged_split,
    )
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain

    n_pages = R * max_pages
    q = torch.randn(R, G, D, generator=gen, device=device).to(dtype)
    kp = torch.randn(n_pages, page, D, generator=gen, device=device).to(dtype)
    vp = torch.randn(n_pages, page, D, generator=gen, device=device).to(dtype)
    ids = (torch.randperm(n_pages, generator=gen, device=device) if shuffled
           else torch.arange(n_pages, device=device))
    table = ids.to(torch.int32).reshape(R, max_pages)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    got = paged_attention(q, kp, vp, table, lens)
    got_lse = paged_attention(q, kp, vp, table, lens, return_lse=True)
    plain = paged_attention_plain(q, kp, vp, table, lens, return_lse=True)
    torch.cuda.synchronize()
    check = attention_check(got, plain[0])
    lse = paged_lse_check(got_lse[1], plain[1], lens)
    lse["output_bit_identical"] = bool(torch.equal(got_lse[0], got))
    lse["within_tolerance"] = lse["within_tolerance"] and \
        lse["output_bit_identical"]
    check["within_tolerance"] = check["within_tolerance"] and \
        lse["within_tolerance"]
    del got, got_lse, plain
    # the yardstick reads K/V gathered through the table and a length
    # mask, both made outside its timing
    T = max_pages * page
    kg = kp[table.long()].reshape(R, 1, T, D).expand(R, G, T, D)
    vg = vp[table.long()].reshape(R, 1, T, D).expand(R, G, T, D)
    mask = (torch.arange(T, device=device)[None, :] < lens[:, None])[:, None, None]
    qs = q[:, :, None, :]
    esize = q.element_size()
    used = np.minimum(lengths, T)
    tokens = int(used.sum())
    n_used = int(np.ceil(used / page).sum())
    cost = paged_cost(R, G, D, tokens, n_used, dtype)
    flops, nbytes = cost.flops, cost.nbytes
    case = {
        "shape": [R, G, D, page, max_pages], "tokens": tokens,
        "split_pages": paged_split(R, G, max_pages, page),
        "table": "shuffled" if shuffled else "slot",
        "dtype": str(dtype).split(".")[-1],
        **check,
        "ms": cuda_ms(lambda: paged_attention(q, kp, vp, table, lens)),
        "plain_ms": cuda_ms(
            lambda: paged_attention_plain(q, kp, vp, table, lens)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask)),
        "bound_ms": cost.bound_ms(), "bound_by": cost.bound_by(),
        "flops": flops, "bytes": nbytes,
    }
    # the route that writes the log-sum-exp too (a decode cache split over
    # ranks), timed beside the same yardstick
    lse_cost = paged_cost(R, G, D, tokens, n_used, dtype, lse=True)
    lse.update({
        "ms": cuda_ms(lambda: paged_attention(q, kp, vp, table, lens,
                                              return_lse=True)),
        "plain_ms": cuda_ms(lambda: paged_attention_plain(
            q, kp, vp, table, lens, return_lse=True)),
        "library_ms": case["library_ms"],
        "bound_ms": lse_cost.bound_ms(), "bound_by": lse_cost.bound_by(),
        "bytes": lse_cost.nbytes})
    case["lse"] = lse
    case["profiler_launches"] = {}
    case["profiler_kernel_ms"] = profiler_ms(
        lambda: paged_attention(q, kp, vp, table, lens), "paged_attention",
        counts=case["profiler_launches"])
    if cold:
        n = max(2, -(-2 * HW["l2_bytes"] // (2 * tokens * D * esize)))
        pools = [(kp, vp)] + [(kp.clone(), vp.clone()) for _ in range(n - 1)]
        turn = iter(range(1 << 30))

        def next_pool():
            k, v = pools[next(turn) % n]
            return paged_attention(q, k, v, table, lens)

        case["cold_copies"] = n
        case["ms_cold"] = cuda_ms(next_pool)
        case["profiler_launches_cold"] = {}
        case["profiler_kernel_ms_cold"] = profiler_ms(
            next_pool, "paged_attention",
            counts=case["profiler_launches_cold"])
        del pools
    return case


def paged_lse_check(got: torch.Tensor, plain: torch.Tensor,
                    lens: torch.Tensor) -> dict:
    """The paged kernel's log-sum-exp against its plain version's: rows
    that hold a token within PAGED_LSE_TOL, rows of length 0 at
    ``LSE_EMPTY`` exactly on both sides."""
    from repro_torch.kernels.paged_attention.ref import LSE_EMPTY

    empty = (lens <= 0)[:, None].expand_as(got)
    err = (got - plain).abs().masked_fill(empty, 0.0)
    sentinel = bool((got[empty] == LSE_EMPTY).all()
                    and (plain[empty] == LSE_EMPTY).all())
    worst = float(err.max()) if err.numel() else 0.0
    return {"max_abs_err": worst, "tolerance": PAGED_LSE_TOL,
            "empty_rows": int((lens <= 0).sum()),
            "sentinel_exact": sentinel,
            "within_tolerance": worst <= PAGED_LSE_TOL and sentinel}


def paged_merge_case(R: int, G: int, D: int, page: int, max_pages: int,
                     lengths: np.ndarray, blocks: int, dtype,
                     gen: torch.Generator, device) -> dict:
    """A cache's sequence cut into ``blocks`` blocks: each block's table
    slice goes through the kernel with its log-sum-exp (lengths clamped
    to the block), ``tensor_parallel.merge_attention_blocks`` merges
    them, and the result is held to the kernel's launch over the whole
    table.  f32 within F32_TOL; bf16 within one bf16 rounding of each
    side plus F32_TOL, a side being the whole output or the merged
    blocks' outputs (their weighted mean size: each was rounded once)."""
    from repro_torch.distributed.tensor_parallel import (
        merge_attention_blocks,
    )
    from repro_torch.kernels.paged_attention.kernel import paged_attention

    n_pages = R * max_pages
    q = torch.randn(R, G, D, generator=gen, device=device).to(dtype)
    kp = torch.randn(n_pages, page, D, generator=gen, device=device).to(dtype)
    vp = torch.randn(n_pages, page, D, generator=gen, device=device).to(dtype)
    table = torch.randperm(n_pages, generator=gen, device=device).to(
        torch.int32).reshape(R, max_pages)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    per = max_pages // blocks
    s_loc = per * page
    parts = [(table[:, r * per:(r + 1) * per].contiguous(),
              (lens - r * s_loc).clamp(0, s_loc)) for r in range(blocks)]

    def merged():
        outs = [paged_attention(q, kp, vp, t, n, return_lse=True)
                for t, n in parts]
        o = torch.stack([o for o, _ in outs])
        lse = torch.stack([l for _, l in outs])
        return merge_attention_blocks(o, lse), o, lse

    whole = paged_attention(q, kp, vp, table, lens)
    got, o, lse = merged()
    torch.cuda.synchronize()
    err = (got - whole.float()).abs()
    if dtype == torch.bfloat16:
        sides = (merge_attention_blocks(o.float().abs(), lse)
                 + whole.float().abs())
        limit = BF16_REL * sides + F32_TOL
        tolerance = "2^-8*(merged |o_r| + |whole|)+2e-5"
    else:
        limit = torch.full_like(err, F32_TOL)
        tolerance = str(F32_TOL)
    ratio = float((err / limit).max())
    del o, lse, got
    return {"shape": [R, G, D, page, max_pages], "blocks": blocks,
            "dtype": str(dtype).split(".")[-1],
            "max_abs_err": float(err.max()), "max_err_ratio": ratio,
            "tolerance": tolerance, "within_tolerance": ratio <= 1.0,
            "ms": cuda_ms(lambda: merged()[0]),
            "whole_ms": cuda_ms(lambda: paged_attention(q, kp, vp, table,
                                                        lens))}


def attention_phase(largest: dict, device) -> Dict[str, dict]:
    """The attention kernels against their plain versions, at the serve
    phase's largest shapes and at deployment shapes: the wgmma flash
    kernel in bf16 (with the ragged, non-causal, D 128 and strided-view
    cases), the split-TF32 flash kernel in f32 (serve, deploy and the
    REDUCED configs' widths) and, for the old/new ratio, in bf16 on the
    wgmma kernel's serve and deploy operands; the paged kernel in bf16 and
    f32."""
    from repro_torch.configs.granite_3_2b import CONFIG as cfg
    from repro_torch.configs.qwen1_5_4b import CONFIG as qwen
    from repro_torch.kernels.flash_attention.kernel import (
        FLASH_ATTENTION,
        FLASH_ATTENTION_WGMMA,
    )

    gen = torch.Generator(device=device).manual_seed(7)
    rng = np.random.RandomState(9)
    G = cfg.n_heads // cfg.n_kv_heads
    out: Dict[str, dict] = {"flash_attention_wgmma": {},
                            "flash_attention": {}, "paged_attention": {}}
    # a kernel the serve phase never launched has failed already; it is
    # still checked, at the serve configuration's shapes
    B, H, Hkv, S, D = (largest["flash_attention_wgmma"]
                       or (1, cfg.n_heads, cfg.n_kv_heads, SERVE_PROMPT[1],
                           cfg.d_head))
    R, Gs, max_pages, page, Ds = (largest["paged_attention"]
                                  or (SERVE_SLOTS * cfg.n_kv_heads, G,
                                      SERVE_S_MAX // SERVE_PAGE, SERVE_PAGE,
                                      cfg.d_head))
    granite = (1, cfg.n_heads, cfg.n_kv_heads)
    flash = {  # name: ((B, H, Hkv, S, D), causal, views)
        "serve": ((B, H, Hkv, S, D), True, False),
        "deploy": ((*granite, 4096, cfg.d_head), True, False),
        "s1": ((*granite, 1, cfg.d_head), True, False),
        "s37": ((*granite, 37, cfg.d_head), True, False),
        "s129": ((*granite, 129, cfg.d_head), True, False),
        "noncausal": ((*granite, 1024, cfg.d_head), False, False),
        "d128": ((1, qwen.n_heads, qwen.n_kv_heads, 2048, qwen.d_head),
                 True, False),
        "views": ((2, *granite[1:], 1024, cfg.d_head), True, True),
    }
    for name, (shape, causal, views) in flash.items():
        q, k, v = flash_inputs(*shape, torch.bfloat16, gen, device, views)
        out["flash_attention_wgmma"][f"{name}_bf16"] = flash_case(
            q, k, v, causal, FLASH_ATTENTION_WGMMA)
        if name in ("serve", "deploy"):
            out["flash_attention"][f"{name}_bf16"] = flash_case(
                q, k, v, causal, FLASH_ATTENTION)
        del q, k, v
    # f32 at the serve and deployment shapes and at the REDUCED configs'
    # (the parity and training paths' launches)
    f32_shapes = {"serve": flash["serve"][0], "deploy": flash["deploy"][0],
                  "reduced_d8": (2, 8, 2, 517, 8),
                  "reduced_d16": (2, 4, 4, 517, 16)}
    for name, shape in f32_shapes.items():
        q, k, v = flash_inputs(*shape, torch.float32, gen, device)
        out["flash_attention"][f"{name}_f32"] = flash_case(
            q, k, v, True, FLASH_ATTENTION)
        del q, k, v
    # the serve phase's lengths: a prompt plus the tokens decoded so far
    serve_lens = rng.randint(SERVE_PROMPT[0], SERVE_PROMPT[1] + SERVE_NEW + 1,
                             R // cfg.n_kv_heads).repeat(cfg.n_kv_heads)
    deploy_pages = 256
    # the split's edges at the deployment launch's split (16 pages of 16):
    # length 1, page and split edges, rows whose later splits lie wholly
    # past the length, full and empty rows
    edge_lens = np.resize([1, 15, 16, 17, 255, 256, 257, 512, 2000, 4096, 0],
                          128)
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        out["paged_attention"][f"serve_{tag}"] = paged_case(
            R, Gs, Ds, page, max_pages, serve_lens, dtype, gen, device,
            shuffled=False, cold=True)
        out["paged_attention"][f"deploy_{tag}"] = paged_case(
            128, G, cfg.d_head, SERVE_PAGE, deploy_pages,
            np.full(128, deploy_pages * SERVE_PAGE), dtype, gen, device,
            shuffled=True)
        out["paged_attention"][f"edges_{tag}"] = paged_case(
            128, G, cfg.d_head, SERVE_PAGE, deploy_pages, edge_lens, dtype,
            gen, device, shuffled=True)
    # the deployment cache cut into blocks of its sequence and merged: at
    # granite's D 64 (4 heads a row) and Qwen3's D 128 (16), full rows and
    # rows at the blocks' edges (one holding none on later blocks)
    T = deploy_pages * SERVE_PAGE
    merge_lens = np.resize([T, T, 1, T // 4 - 1, T // 4, T // 4 + 1,
                            T // 2 - 1, T // 2, T // 2 + 1, 3 * T // 4,
                            T - 1, 0], 128)
    for D, Gm in ((cfg.d_head, G), (128, 16)):
        for blocks in MERGE_BLOCKS:
            for dtype in (torch.bfloat16, torch.float32):
                tag = "bf16" if dtype == torch.bfloat16 else "f32"
                out["paged_attention"][f"merge{blocks}_d{D}_{tag}"] = \
                    paged_merge_case(128, Gm, D, SERVE_PAGE, deploy_pages,
                                     merge_lens, blocks, dtype, gen, device)
    return out


def _ids(gen: torch.Generator, device, hi: int, *shape) -> torch.Tensor:
    return torch.randint(0, hi, shape, generator=gen, device=device,
                         dtype=torch.int32)


def recsys_batch(sv, n: int, gen: torch.Generator, device) -> dict:
    """A score batch of ``n`` rows for the arch of ``sv`` (a
    ``RecsysServing``), drawn on ``device``: ids in each table's range,
    dense features uniform in [0, 1), history masks about 70% set."""
    cfg = sv.config

    def ids(hi, *shape):
        return _ids(gen, device, hi, *shape)

    if sv.name == "dlrm-mlperf":
        return {"dense": torch.rand((n, cfg.n_dense), generator=gen,
                                    device=device),
                "sparse": torch.stack([ids(r, n) for r in cfg.table_rows], 1)}
    if sv.name == "din":
        mask = (torch.rand((n, cfg.seq_len), generator=gen, device=device)
                < 0.7).float()
        mask[:, 0] = 1.0
        return {"hist_items": ids(cfg.n_items, n, cfg.seq_len),
                "hist_cates": ids(cfg.n_cates, n, cfg.seq_len),
                "hist_mask": mask, "target_item": ids(cfg.n_items, n),
                "target_cate": ids(cfg.n_cates, n)}
    if sv.name == "sasrec":
        return {"seq": ids(cfg.n_items, n, cfg.seq_len),
                "candidates": ids(cfg.n_items, n, sv.serve_candidates)}
    return {"user_id": ids(cfg.n_users, n), "user_ctx": ids(cfg.n_context, n),
            "item_id": ids(cfg.n_items, n), "item_cat": ids(cfg.n_context, n)}


def retrieval_batch(sv, n_cand: int, gen: torch.Generator, device) -> dict:
    """One query and ``n_cand`` candidates for the arch of ``sv``."""
    cfg = sv.config
    if sv.name == "dlrm-mlperf":
        return {**recsys_batch(sv, 1, gen, device),
                "candidates": _ids(gen, device, cfg.table_rows[0], n_cand)}
    if sv.name == "din":
        hist = recsys_batch(sv, 1, gen, device)
        return {**{k: v for k, v in hist.items() if k.startswith("hist")},
                "candidates": _ids(gen, device, cfg.n_items, n_cand),
                "candidate_cates": _ids(gen, device, cfg.n_cates, n_cand)}
    if sv.name == "sasrec":
        return {"seq": _ids(gen, device, cfg.n_items, 1, cfg.seq_len),
                "candidates": _ids(gen, device, cfg.n_items, n_cand)}
    return {"user_id": _ids(gen, device, cfg.n_users, 1),
            "user_ctx": _ids(gen, device, cfg.n_context, 1),
            "candidate_embs": torch.randn((n_cand, cfg.tower_mlp[-1]),
                                          generator=gen, device=device)}


def dlrm_forward_per_table(cfg, p: dict, batch: dict) -> torch.Tensor:
    """``dlrm_forward`` as the port computed it before its bags were
    grouped: a one-table bag launch a table, cast to ``cfg.dtype``,
    stacked with the bottom MLP's output and widened to f32.  The serve
    phase holds the grouped forward's scores to it bit for bit."""
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_fixed
    from repro_torch.nn.layers import mlp_apply

    dense_x, sparse = batch["dense"], batch["sparse"]
    d = mlp_apply(p["bot"], dense_x.to(cfg.dtype), dtype=cfg.dtype,
                  final_act=True)
    cols = sparse.to(torch.int32).t().contiguous()
    ones = torch.ones((dense_x.shape[0], 1), dtype=torch.float32,
                      device=dense_x.device)
    z = torch.stack([d] + [
        embedding_bag_fixed(p["tables"][f"t{i}"]["table"], cols[i, :, None],
                            ones, id_rule="fill").to(cfg.dtype)
        for i in range(cfg.n_sparse)], dim=1)
    zf = z.float()
    inter = zf @ zf.transpose(1, 2)
    iu = torch.triu_indices(z.shape[1], z.shape[1], 1, device=z.device)
    flat = inter[:, iu[0], iu[1]].to(cfg.dtype)
    return mlp_apply(p["top"], torch.cat([d, flat], dim=-1),
                     dtype=cfg.dtype)[:, 0]


def recsys_serve_phase(device, bag) -> tuple:
    """dlrm-mlperf at its published config (26 bf16 tables of 177,944,225
    rows, seeded random weights) through ``dlrm_forward`` and
    ``dlrm_retrieval``: the ``serve_p99``, ``serve_bulk`` and
    ``retrieval_cand`` cells.  Returns the report and the parameters
    (the kernel phase reads the tables)."""
    from repro_torch.configs.registry import get_serving
    from repro_torch.models.recsys import DLRM_RETRIEVAL_CHUNK, top_ids

    sv = get_serving("dlrm-mlperf")
    cfg, sizes = sv.config, sv.batch_sizes
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(device)
    params = sv.init(cfg, torch.Generator(device=device).manual_seed(0))
    tables = [t["table"] for t in params["tables"].values()]
    rows = sum(t.shape[0] for t in tables)
    table_bytes = sum(t.numel() * t.element_size() for t in tables)
    gen = torch.Generator(device=device).manual_seed(21)
    # warm-up at both batch sizes (cuBLAS handles, the allocator, the bag
    # kernel's first launch); its launches do not count
    for n in (sizes["serve_p99"], sizes["serve_bulk"]):
        sv.score(cfg, params, recsys_batch(sv, n, gen, device))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"recsys: {cfg.name}, {len(tables)} tables, {rows:,} rows x "
        f"{cfg.embed_dim} in {cfg.dtype} ({table_bytes:,} B), set-up "
        f"{setup_s:.1f} s, device memory "
        f"{torch.cuda.memory_allocated(device):,} B")

    failures: List[str] = []
    if rows != sum(cfg.table_rows):
        failures.append(f"recsys: {rows} table rows, {sum(cfg.table_rows)} "
                        "published")
    finite: List[torch.Tensor] = []
    lat: Dict[str, List[float]] = {"serve_p99": [], "serve_bulk": [],
                                   "retrieval_cand": []}
    forwards = 0
    bag.launches = 0
    bag.largest = None
    for cell, calls in (("serve_p99", RECSYS_P99_CALLS),
                        ("serve_bulk", RECSYS_BULK_CALLS)):
        n = sizes[cell]
        for _ in range(calls):
            batch = recsys_batch(sv, n, gen, device)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            scores = sv.score(cfg, params, batch)
            torch.cuda.synchronize()
            lat[cell].append(time.perf_counter() - t1)
            forwards += 1
            finite.append(torch.isfinite(scores).all())
            if tuple(scores.shape) != (n,):
                failures.append(f"recsys {cell}: scores {tuple(scores.shape)}")
    n_cand = sv.n_candidates
    per_call = -(-n_cand // DLRM_RETRIEVAL_CHUNK)   # forwards a retrieval
    for _ in range(RECSYS_RETRIEVAL_CALLS):
        ret = retrieval_batch(sv, n_cand, gen, device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ids = sv.retrieval(cfg, params, ret)
        torch.cuda.synchronize()
        lat["retrieval_cand"].append(time.perf_counter() - t1)
        forwards += per_call
        if (tuple(ids.shape) != (100,) or ids.unique().numel() != 100
                or not bool(((ids >= 0) & (ids < n_cand)).all())):
            failures.append("recsys retrieval_cand: not 100 distinct "
                            "candidate positions")
    launches, largest = bag.launches, bag.largest
    peak = torch.cuda.max_memory_allocated(device)
    expect = forwards
    if launches != expect:
        failures.append(f"{bag.symbol}: {launches} launches, {expect} "
                        f"expected (one a forward, {forwards} forwards)")
    # after the launch count is read: checks and profiles do not count
    same = {}
    for cell in ("serve_p99", "serve_bulk"):
        batch = recsys_batch(sv, sizes[cell], gen, device)
        same[cell] = bool(torch.equal(
            sv.score(cfg, params, batch),
            dlrm_forward_per_table(cfg, params, batch)))
        if not same[cell]:
            failures.append(f"recsys {cell}: the grouped launch's scores "
                            "differ from the per-table launches'")
    scores = sv.candidate_scores(cfg, params, ret)
    finite.append(torch.isfinite(scores).all())
    if not torch.equal(top_ids(scores, 100), ids):
        failures.append("recsys retrieval_cand: ids are not the top "
                        "scores' positions")
    if not all(bool(f) for f in finite):
        failures.append("recsys: non-finite scores")
    profile = {}
    for cell in ("serve_p99", "serve_bulk"):
        batch = recsys_batch(sv, sizes[cell], gen, device)
        for _ in range(2):   # once more if the session came back empty
            profile[cell] = device_profile(
                lambda: sv.score(cfg, params, batch), match="embedding_bag")
            if profile[cell]["captured"]:
                break
    bulk = sizes["serve_bulk"]
    report = {
        "arch": cfg.name, "tables": len(tables), "rows": rows,
        "table_bytes": table_bytes, "dtype": str(cfg.dtype).split(".")[-1],
        "setup_s": setup_s,
        "serve_p99": {"batch": sizes["serve_p99"],
                      **percentiles_ms(lat["serve_p99"])},
        "serve_bulk": {"batch": bulk, **percentiles_ms(lat["serve_bulk"]),
                       "samples_per_s": bulk * len(lat["serve_bulk"])
                       / sum(lat["serve_bulk"])},
        "retrieval_cand": {"candidates": n_cand,
                           "forwards_per_call": per_call,
                           **percentiles_ms(lat["retrieval_cand"])},
        "forwards": forwards, "launches": launches,
        "expected_launches": expect, "largest": largest,
        "equal_to_per_table": same,
        "peak_mem_bytes": peak, "profile": profile, "failures": failures,
    }
    return report, params


def top_swaps(card: List[int], cpu: List[int], scores: torch.Tensor,
              tol: float) -> Optional[int]:
    """How many adjacent pairs of equal-within-``tol`` scores the card's
    top ids have in the other order than the CPU's (a pair at the cut may
    bring in the next id); None when they differ in any other way."""
    swaps, i = 0, 0
    while i < len(card):
        if card[i] == cpu[i]:
            i += 1
        elif (i + 1 < len(card) and card[i] == cpu[i + 1]
              and card[i + 1] == cpu[i]
              and abs(float(scores[card[i]] - scores[cpu[i]])) < tol):
            swaps, i = swaps + 1, i + 2
        elif (i == len(card) - 1
              and abs(float(scores[card[i]] - scores[cpu[i]])) < tol):
            swaps, i = swaps + 1, i + 1
        else:
            return None
    return swaps


def serve_call(step, params, batch: dict, device,
               reset: Callable[[], None] = lambda: None) -> dict:
    """``step(params, batch)`` twice from an emptied cache, the first a
    warm-up (its first launches set cuBLAS and NCCL up; its blocks stay
    cached for the second), then ``reset()``, then the second measured:
    its output, host time (synchronised) and the peak of allocated bytes
    during it (weights included).  The cache is emptied first because
    DIN's retrieval peaks at 68.1 GB of live bytes (dry run), which a
    call fitted into the blocks that another call's pattern left cached
    did not find room for (out of memory with 14.85 GiB reserved but
    unallocated)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    step(params, batch)
    torch.cuda.synchronize()
    reset()
    torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    out = step(params, batch)
    torch.cuda.synchronize()
    return {"out": out, "s": time.perf_counter() - t,
            "peak_bytes": torch.cuda.max_memory_allocated(device)}


def mesh_recsys_serve(arch: str, params: dict, mesh, device, bag,
                      failures: List[str]) -> dict:
    """``arch``'s ``serve_p99`` (B 512), ``serve_bulk`` (B 262,144) and
    ``retrieval_cand`` (1,000,000 candidates) at its published widths in
    its bf16 serving weights ``params``, each through
    ``RecsysBundle.serve_step`` without a mesh and then on the one-rank
    ``mesh`` (the weights placed by the rules, a view whose placing must
    allocate at most MESH_PLACE_BYTES; the batch placed by the cell's
    ``input_sharding``, so the candidates are split over ``data`` and
    their top 100 merged), on the same batch: scores bit for bit and ids
    equal; DLRM's bag kernel once a forward (once a 262,144-candidate
    chunk in retrieval); the lookups' (``ROW_COLLECTIVES``) and
    ``model``'s collectives above 0 for DLRM and two-tower and none for
    DIN and SASRec (tables gathered whole, no MLP split), one merge in
    retrieval; the mesh call's peak at most MESH_SERVE_PEAK_RATIO of the
    unsharded call's.  Each call is run once before it is measured
    (:func:`serve_call`); the counts are the measured mesh call's."""
    from repro_torch.configs.registry import get_bundle
    from repro_torch.distributed.row_parallel import (
        MERGE_COLLECTIVES,
        ROW_COLLECTIVES,
    )
    from repro_torch.distributed.sharding import place, sanitize_shardings
    from repro_torch.distributed.tensor_parallel import MODEL_COLLECTIVES
    from repro_torch.models.recsys import DLRM_RETRIEVAL_CHUNK
    from repro_torch.tree import tree_map

    bundle = get_bundle(arch)
    sv = bundle.serving
    label = f"mesh recsys serve {arch}"
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    placed = tree_map(place, params, bundle.param_shardings(mesh))
    place_bytes = torch.cuda.max_memory_allocated(device) - before
    if place_bytes > MESH_PLACE_BYTES:
        failures.append(f"{label}: placing the weights allocated "
                        f"{place_bytes:,} B (a view expected)")
    gen = torch.Generator(device=device).manual_seed(31)
    counters = (ROW_COLLECTIVES, MODEL_COLLECTIVES, MERGE_COLLECTIVES)
    routed = arch in ("dlrm-mlperf", "two-tower-retrieval")
    out = {"arch": arch, "place_bytes": place_bytes, "cells": {}}
    for cell in ("serve_p99", "serve_bulk", "retrieval_cand"):
        retrieval = cell == "retrieval_cand"
        batch = (retrieval_batch(sv, sv.n_candidates, gen, device)
                 if retrieval else
                 recsys_batch(sv, sv.batch_sizes[cell], gen, device))
        layout = sanitize_shardings(bundle.input_sharding(cell, mesh)["batch"],
                                    batch, mesh)
        on_mesh = {k: place(v, layout[k]) for k, v in batch.items()}
        step = bundle.serve_step(cell)
        plain = serve_call(step, params, batch, device)

        def reset():
            bag.launches = 0
            for c in counters:
                c.reset()

        sharded = serve_call(step, placed, on_mesh, device, reset)
        counts = {"bag_launches": bag.launches,
                  "row_collectives": ROW_COLLECTIVES.count,
                  "model_collectives": MODEL_COLLECTIVES.count,
                  "merge_collectives": MERGE_COLLECTIVES.count}
        a, b = sharded.pop("out"), plain.pop("out")
        same = bool(torch.equal(a, b))
        ratio = sharded["peak_bytes"] / plain["peak_bytes"]
        forwards = (-(-sv.n_candidates // DLRM_RETRIEVAL_CHUNK)
                    if retrieval else 1)
        want = {"bag_launches": forwards if arch == "dlrm-mlperf" else 0,
                "merge_collectives": int(retrieval)}
        rep = {"shape": list(a.shape), "bit_identical": same,
               "unsharded_ms": plain["s"] * 1e3, "mesh_ms": sharded["s"] * 1e3,
               "unsharded_peak_bytes": plain["peak_bytes"],
               "mesh_peak_bytes": sharded["peak_bytes"], "peak_ratio": ratio,
               **counts}
        if not retrieval:
            rep["finite"] = bool(torch.isfinite(b.float()).all())
        out["cells"][cell] = rep
        log(f"{label} {cell}: {json.dumps(rep)}")
        where = f"{label} {cell}"
        if not same:
            failures.append(f"{where}: the one-rank mesh call differs from "
                            "the unsharded one")
        if not rep.get("finite", True):
            failures.append(f"{where}: non-finite scores")
        if ratio > MESH_SERVE_PEAK_RATIO:
            failures.append(f"{where}: the mesh call's peak is {ratio:.4f} "
                            f"of the unsharded call's (at most "
                            f"{MESH_SERVE_PEAK_RATIO})")
        for key, n in want.items():
            if counts[key] != n:
                failures.append(f"{where}: {key} {counts[key]}, {n} expected")
        if (counts["row_collectives"] > 0, counts["model_collectives"] > 0) \
                != (routed, routed):
            failures.append(f"{where}: {counts['row_collectives']} lookup "
                            f"and {counts['model_collectives']} model "
                            f"collectives ({'both' if routed else 'none'} "
                            "expected)")
        del a, b, batch, on_mesh
    del placed
    return out


def mesh_recsys_serve_phase(device, bag, drawn: Dict[str, dict]) -> dict:
    """The recsys family's serve cells on a one-rank NCCL mesh
    (:func:`one_rank_mesh`), each arch of MESH_SERVE_ARCHS at its
    published widths against its unsharded calls
    (:func:`mesh_recsys_serve`): DLRM on its 26 bf16 tables that the
    recsys serve phase drew (``drawn``: params by arch, each popped and
    freed once its arch is done), the others drawn here from seed 0."""
    from repro_torch.configs.registry import get_serving

    t0 = time.perf_counter()
    failures: List[str] = []
    out: dict = {"archs": {}}
    with one_rank_mesh() as mesh:
        out["mesh"] = {"shape": list(mesh.shape),
                       "axes": list(mesh.mesh_dim_names)}
        for arch in MESH_SERVE_ARCHS:
            params = drawn.pop(arch, None)
            if params is None:
                sv = get_serving(arch)
                params = sv.init(sv.config,
                                 torch.Generator(device=device).manual_seed(0))
            out["archs"][arch] = mesh_recsys_serve(arch, params, mesh, device,
                                                   bag, failures)
            del params
            gc.collect()
            torch.cuda.empty_cache()
    out["launches"] = sum(c["bag_launches"] for a in out["archs"].values()
                          for c in a["cells"].values())
    out["failures"] = failures
    out["seconds"] = time.perf_counter() - t0
    return out


def recsys_parity_phase(device) -> dict:
    """The four recsys archs in float32 (TF32 off), on the card (DLRM's
    lookups through the bag kernel) and on the CPU (through its plain
    version), with the same weights and batches: dlrm-mlperf at its
    published widths with each table cut to RECSYS_PARITY_ROWS rows, the
    others at REDUCED.  Scores of a 512-row batch and of the retrieval
    candidates within RECSYS_PARITY_TOL; top-100 ids equal but for
    adjacent pairs whose scores differ by less than that."""
    from repro_torch.configs.registry import RECSYS_ARCH_IDS, get_serving

    t0 = time.perf_counter()
    failures: List[str] = []
    archs = {}
    for arch in RECSYS_ARCH_IDS:
        full = arch == "dlrm-mlperf"
        sv = get_serving(arch, reduced=not full)
        cfg = dataclasses.replace(sv.config, dtype=torch.float32)
        if full:
            cfg = dataclasses.replace(cfg, table_rows=tuple(
                min(r, RECSYS_PARITY_ROWS) for r in cfg.table_rows))
        sv = dataclasses.replace(sv, config=cfg)
        gen = torch.Generator(device=device).manual_seed(2)
        params = sv.init(cfg, gen)
        host = tree_to(params, "cpu")
        batch = recsys_batch(sv, RECSYS_PARITY_BATCH, gen, device)
        card = sv.score(cfg, params, batch).cpu()
        cpu = sv.score(cfg, host, tree_to(batch, "cpu"))
        n_cand = RECSYS_PARITY_CANDIDATES if full else sv.n_candidates
        ret = retrieval_batch(sv, n_cand, gen, device)
        ret_cpu = tree_to(ret, "cpu")
        card_ids = sv.retrieval(cfg, params, ret).tolist()
        cpu_ids = sv.retrieval(cfg, host, ret_cpu).tolist()
        card_scores = sv.candidate_scores(cfg, params, ret).cpu()
        cpu_scores = sv.candidate_scores(cfg, host, ret_cpu)
        swaps = top_swaps(card_ids, cpu_ids, cpu_scores, RECSYS_PARITY_TOL)
        res = {"batch": RECSYS_PARITY_BATCH, "candidates": n_cand,
               "max_abs_score_err": float((card - cpu).abs().max()),
               "max_abs_candidate_score_err":
                   float((card_scores - cpu_scores).abs().max()),
               "mean_abs_score": float(cpu.abs().mean()),
               "top100_equal": card_ids == cpu_ids, "swapped_pairs": swaps}
        archs[arch] = res
        for key in ("max_abs_score_err", "max_abs_candidate_score_err"):
            if not res[key] <= RECSYS_PARITY_TOL:
                failures.append(f"recsys parity {arch}: {key} {res[key]}")
        if swaps is None:
            failures.append(f"recsys parity {arch}: top-100 ids differ")
    return {"archs": archs, "tolerance": RECSYS_PARITY_TOL,
            "reduced": f"dlrm-mlperf: each table cut to "
                       f"{RECSYS_PARITY_ROWS:,} rows, {RECSYS_PARITY_CANDIDATES:,} "
                       "candidates; din, sasrec, two-tower-retrieval at "
                       "REDUCED with its candidate counts",
            "tf32": torch.backends.cuda.matmul.allow_tf32,
            "seconds": time.perf_counter() - t0, "failures": failures}


def bag_check(got: torch.Tensor, plain: torch.Tensor) -> dict:
    return elementwise_check(got, plain, BAG_F32_TOL)


def bag_ids(V: int, B: int, K: int, gen: torch.Generator,
            device) -> torch.Tensor:
    """(B, K) int32 ids in [0, V), the table's last 1,000 rows among
    them: in a 128-wide table every row past 16,777,216 starts past
    element 2^31."""
    ids = _ids(gen, device, V, B, K)
    tail = min(1000, V, B * K)
    ids.view(-1)[:tail] = torch.arange(V - tail, V, device=device,
                                       dtype=torch.int32)
    return ids


def bound_of(nbytes: int, flops: int) -> dict:
    """The least time on the card for ``nbytes`` and ``flops`` (f32
    scalar operations), and which of the two bounds it."""
    cost = Cost(flops, nbytes, "peak_f32_flops")
    return {"bound_ms": cost.bound_ms(), "bound_by": cost.bound_by(),
            "bytes": nbytes}


def bag_case(table: torch.Tensor, ids: torch.Tensor,
             w: torch.Tensor) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_fixed
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_fixed_plain

    got = embedding_bag_fixed(table, ids, w)
    plain = embedding_bag_fixed_plain(table, ids, w)
    torch.cuda.synchronize()
    check = bag_check(got, plain)
    identical = bool(torch.equal(got, plain))
    del got, plain
    (V, D), (B, K) = table.shape, ids.shape
    esize = table.element_size()
    lib_w = w.to(table.dtype)
    return {
        "shape": [V, D, B, K], "dtype": str(table.dtype).split(".")[-1],
        **check, "bit_identical": identical,
        "ms": cuda_ms(lambda: embedding_bag_fixed(table, ids, w)),
        "fill_ms": cuda_ms(lambda: embedding_bag_fixed(table, ids, w,
                                                       id_rule="fill")),
        "plain_ms": cuda_ms(lambda: embedding_bag_fixed_plain(table, ids, w)),
        "library_ms": cuda_ms(lambda: F.embedding_bag(
            ids, table, mode="sum", per_sample_weights=lib_w)),
        **bound_of(bag_bytes([table], ids[None], "clip", B * K * 4,
                             B * D * esize), 2 * B * K * D),
    }


def bag_group_case(tables: Sequence[torch.Tensor], B: int,
                   gen: torch.Generator, device) -> dict:
    """The tables in one launch of ``embedding_bags`` as DLRM's forward
    makes it: ``B`` bags of one id a table, ids a transposed (B, T)
    matrix, weight 1 shared, the ``fill`` rule, into a (B, T, D) block in
    the tables' dtype.  Bit for bit against the per-table plain versions,
    also with :func:`bad_ids` mixed into every table's ids under both
    rules (NaN in the same places); timed beside the T one-table
    launches it replaces (``per_table_ms``) and its bytes bound; and the
    interaction's input written as f32 directly against bf16 widened
    after (``interaction_input``).  No PyTorch call computes T tables
    into strided slots, so ``library_ms`` is None."""
    from repro_torch.kernels.embedding_bag.kernel import (
        embedding_bag_fixed,
        embedding_bags,
    )
    from repro_torch.kernels.embedding_bag.ref import embedding_bags_plain

    n, D, dtype = len(tables), tables[0].shape[1], tables[0].dtype
    sparse = torch.stack([bag_ids(t.shape[0], B, 1, gen, device)[:, 0]
                          for t in tables], 1)                  # (B, T)
    ids = sparse.t()[..., None]                                 # (T, B, 1)
    w = torch.ones((1, 1, 1), device=device).expand(n, B, 1)
    got = embedding_bags(tables, ids, w, "fill")
    plain = embedding_bags_plain(tables, ids, w, "fill")
    torch.cuda.synchronize()
    out = {"tables": n, "shape": [sum(t.shape[0] for t in tables), D, B, 1],
           "dtype": str(dtype).split(".")[-1],
           **bag_check(got, plain),
           "bit_identical": bool(torch.equal(got, plain))}
    del got, plain
    bad = torch.stack([bad_ids(sparse[:, i].contiguous(), t.shape[0])
                       for i, t in enumerate(tables)], 1).t()[..., None]
    out["bad_ids"] = int(sparse[:, 0][::BAG_BAD_EVERY].numel()) * n
    for rule in ("clip", "fill"):
        got = embedding_bags(tables, bad, w, rule)
        plain = embedding_bags_plain(tables, bad, w, rule)
        nan_g, nan_p = torch.isnan(got), torch.isnan(plain)
        out[f"rules_{rule}"] = {
            "bit_identical": bool(torch.equal(nan_g, nan_p)) and bool(
                torch.equal(torch.where(nan_g, 0, got),
                            torch.where(nan_p, 0, plain))),
            "nan_bags": int(nan_g.any(2).sum())}
        del got, plain, nan_g, nan_p
    out["within_tolerance"] = (
        out["within_tolerance"] and out["bit_identical"]
        and out["rules_clip"]["bit_identical"]
        and out["rules_fill"]["bit_identical"]
        and out["rules_clip"]["nan_bags"] == 0
        and out["rules_fill"]["nan_bags"] > 0)
    cols = sparse.t().contiguous()
    ones = torch.ones((B, 1), device=device)
    head = torch.zeros((B, D), dtype=dtype, device=device)

    def per_table():
        return [embedding_bag_fixed(t, cols[i, :, None], ones, id_rule="fill")
                for i, t in enumerate(tables)]

    out.update({
        "ms": cuda_ms(lambda: embedding_bags(tables, ids, w, "fill")),
        "clip_ms": cuda_ms(lambda: embedding_bags(tables, ids, w, "clip")),
        "per_table_ms": cuda_ms(per_table),
        "plain_ms": cuda_ms(lambda: embedding_bags_plain(tables, ids, w,
                                                         "fill"), reps=3),
        "library_ms": None,
        "library_note": "no PyTorch call computes several tables' bags "
                        "into strided slots of one buffer",
        "interaction_input": {
            "f32_ms": cuda_ms(lambda: embedding_bags(
                tables, ids, w, "fill", dtype=torch.float32, head=head)),
            "bf16_then_float_ms": cuda_ms(lambda: embedding_bags(
                tables, ids, w, "fill", head=head).float())},
        **bound_of(bag_bytes(tables, ids, "fill", 4,
                             B * n * D * tables[0].element_size()),
                   2 * n * B * D),
    })
    return out


def bag_window_case(tables: Sequence[torch.Tensor], B: int,
                    gen: torch.Generator, device) -> dict:
    """The grouped launch with row windows, as a mesh step looks tables
    up where their rows lie: each table cut mid-table at ``V // 2`` into
    two blocks, rows [0, V // 2) and [V // 2, V), each block a view
    launched with its window, on ``B`` bags of one id a table whose ids
    hold each cut's neighbours (V // 2 - 1 and V // 2) and the table's
    first and last rows, clean and with :func:`bad_ids` mixed in, under
    both id rules.  Each block's launch is held to its plain version bit
    for bit (NaN in the same places), and the two blocks' bags summed to
    the unwindowed launch bit for bit (one block adds each id, the other
    0; an id outside the table is NaN on both).  Timed: the upper
    blocks' launch (``ms``, its bound counting the rows in the windows)
    beside the unwindowed launch of the same ids (``unwindowed_ms``), by
    CUDA events and by the profiler's kernel time (``kernel_ms``,
    ``unwindowed_kernel_ms``)."""
    from repro_torch.kernels.embedding_bag.kernel import embedding_bags
    from repro_torch.kernels.embedding_bag.ref import embedding_bags_plain

    n, D, dtype = len(tables), tables[0].shape[1], tables[0].dtype
    cuts = [t.shape[0] // 2 for t in tables]
    sparse = torch.stack([bag_ids(t.shape[0], B, 1, gen, device)[:, 0]
                          for t in tables], 1)                  # (B, T)
    for i, (t, c) in enumerate(zip(tables, cuts)):
        sparse[:4, i] = torch.tensor([c - 1, c, 0, t.shape[0] - 1],
                                     dtype=torch.int32, device=device)
    bad = torch.stack([bad_ids(sparse[:, i].contiguous(), t.shape[0])
                       for i, t in enumerate(tables)], 1)
    w = torch.ones((1, 1, 1), device=device).expand(n, B, 1)
    halves = {"lower": [(0, c) for c in cuts],
              "upper": [(c, t.shape[0] - c) for t, c in zip(tables, cuts)]}

    def launch(half, ids, rule, plain=False):
        blocks = [t[f:f + m] for t, (f, m) in zip(tables, halves[half])]
        windows = [(f, t.shape[0]) for t, (f, _) in zip(tables, halves[half])]
        fn = embedding_bags_plain if plain else embedding_bags
        return fn(blocks, ids, w, rule, windows=windows)

    def same(a, b):
        na, nb = torch.isnan(a), torch.isnan(b)
        return bool(torch.equal(na, nb)) and bool(torch.equal(
            torch.where(na, 0, a), torch.where(nb, 0, b)))

    out = {"tables": n, "shape": [sum(t.shape[0] for t in tables), D, B, 1],
           "dtype": str(dtype).split(".")[-1], "cuts": cuts}
    worst, identical = 0.0, True
    for tag, cols in (("clean", sparse), ("bad_ids", bad)):
        ids = cols.t()[..., None]
        for rule in ("clip", "fill"):
            parts = []
            for half in halves:
                got = launch(half, ids, rule)
                plain = launch(half, ids, rule, plain=True)
                torch.cuda.synchronize()
                check = bag_check(torch.nan_to_num(got),
                                  torch.nan_to_num(plain))
                worst = max(worst, check["max_err_ratio"])
                out[f"{tag}_{rule}_{half}"] = same(got, plain)
                identical &= out[f"{tag}_{rule}_{half}"]
                parts.append(got)
                del plain
            whole = embedding_bags(tables, ids, w, rule)
            summed = (parts[0].float() + parts[1].float()).to(dtype)
            out[f"{tag}_{rule}_sum"] = same(summed, whole)
            out[f"{tag}_{rule}_nan_bags"] = int(torch.isnan(whole).any(2)
                                               .sum())
            identical &= out[f"{tag}_{rule}_sum"]
            del parts, whole, summed
    ids = sparse.t()[..., None]
    upper = [(f, t.shape[0]) for t, (f, _) in zip(tables, halves["upper"])]
    blocks = [t[f:] for t, (f, _) in zip(tables, upper)]

    # the timed calls drop their 1.7 GB results: a profiler session of 20
    # calls that kept them would hold 34 GB beside the 45.6 GB of tables
    def windowed() -> None:
        embedding_bags(blocks, ids, w, "fill", windows=upper)

    def unwindowed() -> None:
        embedding_bags(tables, ids, w, "fill")

    out.update({
        "max_err_ratio": worst, "bit_identical": identical,
        "within_tolerance": identical
        and out["bad_ids_fill_sum"] and out["bad_ids_fill_nan_bags"] > 0
        and out["clean_fill_nan_bags"] == 0,
        "ms": cuda_ms(windowed),
        "unwindowed_ms": cuda_ms(unwindowed),
        # the kernel's own device time (torch.profiler), both launches
        "kernel_ms": profiler_ms(windowed, "embedding_bags"),
        "unwindowed_kernel_ms": profiler_ms(unwindowed, "embedding_bags"),
        "plain_ms": cuda_ms(lambda: launch("upper", ids, "fill", plain=True),
                            reps=3),
        "library_ms": None,
        "library_note": "no PyTorch call looks up a window of several "
                        "tables into strided slots of one buffer",
        **bound_of(bag_bytes(blocks, ids, "fill", 4,
                             B * n * D * tables[0].element_size(),
                             windows=upper), 2 * n * B * D),
    })
    return out


def bad_ids(ids: torch.Tensor, V: int) -> torch.Tensor:
    """``ids`` with every BAG_BAD_EVERY-th id replaced, in turn, by V, -1,
    -V, -V-1 and 2^31-1: out of range, wrapped, wrapped to row 0, out of
    range after the wrap, and the largest int32."""
    bad = torch.tensor([V, -1, -V, -V - 1, 2**31 - 1], dtype=torch.int32,
                       device=ids.device)
    out = ids.clone()
    flat = out.view(-1)
    pos = torch.arange(0, flat.numel(), BAG_BAD_EVERY, device=ids.device)
    flat[pos] = bad[torch.arange(pos.numel(), device=ids.device) % 5]
    return out


def bag_rule_case(table: torch.Tensor, ids: torch.Tensor,
                  w: torch.Tensor) -> dict:
    """The kernel under each id rule against its plain version on ids
    with :func:`bad_ids` mixed in: bit for bit, NaN in the same places
    (the NaN's own bits aside), and the fill rule's NaN bags counted."""
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_fixed
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_fixed_plain

    ids = bad_ids(ids, table.shape[0])
    out = {"shape": list(table.shape) + list(ids.shape),
           "dtype": str(table.dtype).split(".")[-1],
           "bad_ids": int((ids.view(-1)[::BAG_BAD_EVERY]).numel())}
    for rule in ("clip", "fill"):
        got = embedding_bag_fixed(table, ids, w, id_rule=rule)
        plain = embedding_bag_fixed_plain(table, ids, w, id_rule=rule)
        torch.cuda.synchronize()
        nan_g, nan_p = torch.isnan(got), torch.isnan(plain)
        same = bool(torch.equal(nan_g, nan_p)) and bool(torch.equal(
            torch.where(nan_g, 0, got), torch.where(nan_p, 0, plain)))
        out[rule] = {"bit_identical": same,
                     "nan_bags": int(nan_g.any(1).sum()),
                     "ms": cuda_ms(lambda: embedding_bag_fixed(
                         table, ids, w, id_rule=rule)),
                     "plain_ms": cuda_ms(lambda: embedding_bag_fixed_plain(
                         table, ids, w, id_rule=rule)),
                     # F.embedding_bag raises on an out-of-range id: no
                     # library call computes either rule
                     "library_ms": None}
        del got, plain
    # V, -V-1 and 2^31-1 read a NaN row under fill; -1 and -V wrap
    want = sum(1 for i in range(out["bad_ids"]) if i % 5 in (0, 3, 4))
    out["fill"]["expected_nan_bags"] = want if ids.shape[1] == 1 else None
    out["within_tolerance"] = (
        out["clip"]["bit_identical"] and out["fill"]["bit_identical"]
        and out["clip"]["nan_bags"] == 0
        and (ids.shape[1] != 1 or out["fill"]["nan_bags"] == want))
    return out


def bag_phase(params: dict, device) -> Dict[str, dict]:
    """The bag kernel against its plain version in bf16 and f32: at
    DLRM's one-table serve launch (BAG_SERVE_B bags, K = 1, w = 1; bit
    identical, and with out-of-range ids under both id rules,
    :func:`bag_rule_case`), at a multi-hot deployment shape over t19's
    48,937,457 rows (and a 20M-row f32 table; both past 2^31 elements),
    at DIN's widths (D = 18, K = 100), and grouped: the 26 DLRM tables
    in one launch at ``serve_bulk``'s batch (:func:`bag_group_case`),
    whole and cut mid-table by row windows (:func:`bag_window_case`)."""
    gen = torch.Generator(device=device).manual_seed(31)
    tables = [t["table"] for t in params["tables"].values()]
    t0, t19 = tables[0], tables[19]
    B, K, D = BAG_SERVE_B, 1, t0.shape[1]
    f32 = torch.empty((BAG_F32_ROWS, D), device=device).normal_(
        0.0, 0.02, generator=gen)
    ones = torch.ones((B, K), device=device)
    out = {}
    for tag, table in (("bf16", t0), ("f32", f32)):
        ids = bag_ids(table.shape[0], B, K, gen, device)
        out[f"serve_{tag}"] = bag_case(table, ids, ones)
        out[f"rules_{tag}"] = bag_rule_case(table, ids, ones)
    w = torch.rand((BAG_DEPLOY_B, BAG_DEPLOY_K), generator=gen, device=device)
    for tag, table in (("bf16", t19), ("f32", f32)):
        out[f"deploy_{tag}"] = bag_case(
            table, bag_ids(table.shape[0], BAG_DEPLOY_B, BAG_DEPLOY_K, gen,
                           device), w)
    del f32
    w = torch.rand((BAG_DIN_B, BAG_DIN_K), generator=gen, device=device)
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        table = torch.empty((BAG_DIN_ROWS, BAG_DIN_D), dtype=dtype,
                            device=device).normal_(0.0, 0.02, generator=gen)
        out[f"din_{tag}"] = bag_case(
            table, bag_ids(BAG_DIN_ROWS, BAG_DIN_B, BAG_DIN_K, gen, device), w)
    del table
    out["grouped_bf16"] = bag_group_case(tables, BAG_SERVE_B, gen, device)
    out["grouped_windowed_bf16"] = bag_window_case(tables, BAG_SERVE_B, gen,
                                                   device)
    return out


def bag_failures(bags: Dict[str, dict]) -> List[str]:
    """What :func:`bag_phase`'s cases say failed."""
    failures = []
    for where, case in bags.items():
        if where.startswith("rules") and not case["within_tolerance"]:
            failures.append(f"embedding_bag's id rules differ from its plain "
                            f"version's at {where}: {json.dumps(case)}")
        elif not case["within_tolerance"]:
            failures.append(f"embedding_bag disagrees with its plain version "
                            f"at {where} shape {case['shape']}: error "
                            f"{case['max_err_ratio']:.3g} times its limit")
        if (where.startswith(("serve", "grouped"))
                and not case["bit_identical"]):
            failures.append(f"embedding_bag at {where} (K = 1, w = 1) is not "
                            "bit identical to its plain version")
    return failures


# -------------------------------------------------------- recsys train --
def capped_rows(rows: Sequence[int], cap: int) -> tuple:
    """Each table's rows capped at ``cap``, and the cuts it made, as
    ``t<i>: <published> -> <cap>``."""
    return (tuple(min(r, cap) for r in rows),
            [f"t{i}: {r:,} -> {cap:,}" for i, r in enumerate(rows) if r > cap])


def train_batch(cfg, n: int, seed: int, device) -> dict:
    """A ``train_batch`` of ``n`` rows drawn on ``device`` from ``seed``:
    ids in each table's range, dense features uniform in [0, 1), labels
    Bernoulli(TRAIN_CTR)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {"dense": torch.rand((n, cfg.n_dense), generator=gen,
                                device=device),
            "sparse": torch.stack([_ids(gen, device, r, n)
                                   for r in cfg.table_rows], 1),
            "label": (torch.rand(n, generator=gen, device=device)
                      < TRAIN_CTR).float()}


def numpy_train_batch(cfg, n: int, seed: int) -> dict:
    """The same kind of batch drawn on the host with numpy."""
    rng = np.random.RandomState(seed)
    return {"dense": rng.rand(n, cfg.n_dense).astype(np.float32),
            "sparse": np.stack([rng.randint(0, r, n) for r in cfg.table_rows],
                               1).astype(np.int32),
            "label": (rng.rand(n) < TRAIN_CTR).astype(np.float32)}


def route_grads(cfg, params: dict, batch: dict, bags: Callable) -> dict:
    """One forward and backward of ``dlrm_loss`` with its table lookups
    through ``bags`` (the kernel's ``embedding_bags``, or its plain
    version ``embedding_bags_plain`` under autograd): the loss, each
    table's gradient, and each table's ids and the cotangent of its slot
    of the interaction's input (the K = 1, w = 1 bags of DLRM's path)."""
    from repro_torch.models import recsys as RS

    names = [f"t{i}" for i in range(cfg.n_sparse)]
    tables = {n: params["tables"][n]["table"].detach().requires_grad_(True)
              for n in names}
    calls = []

    def recording(tabs, ids, w, id_rule="clip", **kw):
        out = bags(tabs, ids, w, id_rule=id_rule, **kw)
        calls.append((ids, out))
        return out

    p = {**params, "tables": {n: {"table": t} for n, t in tables.items()}}
    orig, RS.embedding_bags = RS.embedding_bags, recording
    try:
        loss = RS.dlrm_loss(cfg, p, batch)
    finally:
        RS.embedding_bags = orig
    (ids, z), = calls
    n = len(names)
    grads = torch.autograd.grad(loss, [tables[name] for name in names] + [z])
    lead = z.shape[1] - n
    return {"loss": loss.detach(),
            "grads": dict(zip(names, grads[:n])),
            "ids": {name: ids[i].reshape(-1) for i, name in enumerate(names)},
            "cots": {name: grads[n][:, lead + i]
                     for i, name in enumerate(names)}}


def table_grad_check(grad: torch.Tensor, ids: torch.Tensor,
                     cot: torch.Tensor) -> dict:
    """One table's f32 gradient against the sum of its rows'
    contributions (``cot[b]`` to row ``ids[b]``) taken in float64.  Any
    order of n f32 additions lies within gamma(n - 1) * sum|x| of the
    exact sum (gamma(m) = m u / (1 - m u), u = 2^-24), so each touched
    row is held to that bound (a row touched once must be exact) and
    every untouched row to 0."""
    rows, inv = torch.unique(ids.long(), return_inverse=True)
    D = grad.shape[1]
    exact = torch.zeros((rows.numel(), D), dtype=torch.float64,
                        device=grad.device).index_add_(0, inv, cot.double())
    absum = torch.zeros_like(exact).index_add_(0, inv, cot.double().abs())
    m = (torch.bincount(inv, minlength=rows.numel()) - 1).double()[:, None]
    bound = m * 2.0 ** -24 / (1 - m * 2.0 ** -24) * absum
    err = (grad[rows].double() - exact).abs()
    stray = grad.any(dim=1)
    stray[rows] = False          # rows the batch did not touch, not zero
    positive = bound > 0
    return {"touched_rows": rows.numel(),
            "max_abs_err": float(err.max()),
            "max_err_ratio": float((err[positive] / bound[positive]).max())
            if bool(positive.any()) else 0.0,
            "within_tolerance": not bool((err > bound).any())
            and not bool(stray.any()),
            "nonzero": bool(grad[rows].any())}


def grad_failures(kernel: dict, plain: dict) -> tuple:
    """The kernel route's and the plain route's results of
    :func:`route_grads` on one batch: the losses must be equal (the K = 1
    forward is bit identical), and every table's gradient on each route
    within :func:`table_grad_check`'s bound and non-zero."""
    failures: List[str] = []
    if not torch.equal(kernel["loss"], plain["loss"]):
        failures.append(f"recsys train: kernel route loss "
                        f"{float(kernel['loss'])!r}, plain route "
                        f"{float(plain['loss'])!r}")
    tables = {}
    for name in kernel["grads"]:
        per = {}
        for route, res in (("kernel", kernel), ("plain", plain)):
            grad = res["grads"][name]
            if grad is None:
                failures.append(f"recsys train: {route} route left {name} "
                                "without a gradient")
                continue
            c = table_grad_check(grad, res["ids"][name], res["cots"][name])
            per[route] = c
            if not c["within_tolerance"]:
                failures.append(f"recsys train: {route} route gradient of "
                                f"{name} off by {c['max_abs_err']:.3g} "
                                f"({c['max_err_ratio']:.3g} times its bound)")
            if not c["nonzero"]:
                failures.append(f"recsys train: {route} route gradient of "
                                f"{name} is zero on the rows the batch touched")
        if len(per) == 2:
            per["max_abs_diff"] = float(
                (kernel["grads"][name] - plain["grads"][name]).abs().max())
        tables[name] = per
    return tables, failures


def bag_backward_case(V: int, D: int, B: int, gen: torch.Generator,
                      device) -> dict:
    """The bag's plain backward at DLRM's training launch (a table of
    ``V`` rows, K = 1, w = 1), against ``F.embedding``'s autograd
    backward on the same ids and gradient, beside its bytes bound: the
    (V, D) f32 gradient written once (its zero fill) and the (B, D)
    gradient, ids and weights read once."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag.kernel import (
        embedding_bag_fixed_backward,
    )

    ids = _ids(gen, device, V, B, 1)
    w = torch.ones((B, 1), device=device)
    grad_out = torch.randn((B, D), generator=gen, device=device)
    got, _ = embedding_bag_fixed_backward(grad_out, ids, w, (V, D),
                                          torch.float32)
    table = torch.zeros((V, D), device=device, requires_grad=True)
    out = F.embedding(ids.reshape(-1).long(), table)
    (lib,) = torch.autograd.grad(out, table, grad_out, retain_graph=True)
    err = float((got - lib).abs().max())
    del got, lib
    return {
        "shape": [V, D, B, 1], "dtype": "float32", "max_abs_err": err,
        "ms": cuda_ms(lambda: embedding_bag_fixed_backward(
            grad_out, ids, w, (V, D), torch.float32), reps=10),
        "library_ms": cuda_ms(lambda: torch.autograd.grad(
            out, table, grad_out, retain_graph=True), reps=10),
        **bound_of(V * D * 4 + B * (D * 4 + 8), 2 * B * D),
    }


def profile_train_step(trainer, batches: Callable[[int], dict],
                       ranges: Optional[Dict[str, tuple]] = None,
                       forward: tuple = ("bag_forward", "embedding_bag"),
                       named: Optional[Dict[str, Sequence[str]]] = None
                       ) -> dict:
    """One training step under ``torch.profiler``: the device's busy
    share, the top ops by the device time of the kernels they launched,
    the top kernels, the device time of the kernels whose name holds
    ``forward[1]`` (reported as ``forward[0]``; the bag kernel by
    default), of the kernels whose names hold each of ``named``'s
    substrings (label: substrings; a hand kernel's launch through ctypes
    is not linked to the range around its call, so its time is read by
    name), and of each of ``ranges`` (label: (module, function), AdamW and
    the bag's backward by default), read from a ``record_function`` range
    around its calls."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    from repro_torch.kernels.embedding_bag import kernel as bag_mod
    from repro_torch.train import trainer as trainer_mod

    def ranged(mod, attr, label):
        fn = getattr(mod, attr)

        def wrapped(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return fn, wrapped

    if ranges is None:
        ranges = {"bag_backward": (bag_mod, "embedding_bag_fixed_backward"),
                  "adamw_update": (trainer_mod, "adamw_update")}
    saved = {}
    for label, (mod, attr) in ranges.items():
        saved[label], wrapped = ranged(mod, attr, label)
        setattr(mod, attr, wrapped)
    range_ms = {}
    try:
        from torch.profiler import ProfilerActivity, profile
        for _ in range(2):   # once more if the session came back empty
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                trainer.fit(batches, trainer.step_num + 1)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            events = prof.key_averages()
            post_s = time.perf_counter() - t0 - wall_us / 1e6
            # a range also shows on the device's timeline: not a kernel
            kernels = sorted(
                ((e.key, e.count, e.self_device_time_total) for e in events
                 if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0 and e.key not in ranges),
                key=lambda k: -k[2])
            if kernels:
                break
        host_ops = [e for e in events if e.device_type == DeviceType.CPU]
        for label in ranges:
            range_ms[f"{label}_ms"] = sum(
                e.device_time_total for e in host_ops if e.key == label) / 1e3
        ops = sorted(((e.key, e.count, e.self_device_time_total)
                      for e in host_ops if e.self_device_time_total > 0),
                     key=lambda k: -k[2])
    finally:
        for label, (mod, attr) in ranges.items():
            setattr(mod, attr, saved[label])
    busy_us = sum(k[2] for k in kernels)
    hit = [k for k in kernels if forward[1] in k[0]]
    for label, parts in (named or {}).items():
        by = {part: [k for k in kernels if part in k[0]] for part in parts}
        range_ms[f"{label}_ms"] = sum(
            k[2] for ks in by.values() for k in ks) / 1e3
        range_ms[f"{label}_by_kernel"] = {
            part: {"launches": sum(k[1] for k in ks),
                   "ms": sum(k[2] for k in ks) / 1e3}
            for part, ks in by.items()}
    return {
        "captured": bool(kernels),
        "wall_ms": wall_us / 1e3,
        "trace_processing_s": post_s,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "device_ops": [{"op": n[:60], "count": c, "ms": us / 1e3}
                       for n, c, us in ops[:12]],
        "device_kernels": [{"name": n[:100], "count": c, "ms": us / 1e3}
                           for n, c, us in kernels[:8]],
        f"{forward[0]}_launches": sum(k[1] for k in hit),
        f"{forward[0]}_ms": sum(k[2] for k in hit) / 1e3,
        **range_ms,
    }


def attention_grad_guard(device) -> List[str]:
    """The bare attention wrappers have no backward: a CUDA call whose
    ``q`` requires grad, under grad mode, must raise (it returned an
    output with no ``grad_fn`` before the guard).  The flash kernel's
    ``autograd.Function`` must give autograd's gradient of the plain
    version on the same operands, within F32_TOL in f32."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention,
        flash_attention_differentiable,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.paged_attention.kernel import paged_attention

    gen = torch.Generator(device=device).manual_seed(41)

    def q_of(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16).requires_grad_(True)

    kv = torch.randn((1, 2, 16, 64), generator=gen, device=device,
                     dtype=torch.bfloat16)
    pool = torch.randn((2, 16, 64), generator=gen, device=device,
                       dtype=torch.bfloat16)
    calls = {
        "flash_attention": lambda: flash_attention(q_of(1, 2, 16, 64), kv, kv),
        "paged_attention": lambda: paged_attention(
            q_of(1, 2, 64), pool, pool,
            torch.arange(2, dtype=torch.int32, device=device)[None],
            torch.full((1,), 20, dtype=torch.int32, device=device)),
    }
    failures = []
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                failures.append(f"{name} with a q that requires grad: {e}")
        else:
            failures.append(f"{name} on CUDA with a q that requires grad "
                            "did not raise")
    ops = [torch.randn(shape, generator=gen, device=device)
           for shape in ((2, 8, 77, 32), (2, 2, 77, 32), (2, 2, 77, 32))]
    do = torch.randn((2, 8, 77, 32), generator=gen, device=device)
    grads = []
    for fn in (flash_attention_differentiable, flash_attention_plain):
        live = [t.clone().requires_grad_(True) for t in ops]
        grads.append(torch.autograd.grad(fn(*live, True), live, do))
    for name, g, want in zip("qkv", *grads):
        err = float((g - want).abs().max())
        if not err <= F32_TOL * max(1.0, float(want.abs().max())):
            failures.append(f"flash_attention_differentiable: d{name} differs "
                            f"from the plain version's by {err:.3g}")
    return failures


def reduced_train_checks(device) -> dict:
    """REDUCED dlrm-mlperf in f32 from the same seeded parameters and
    numpy batches: TRAIN_PARITY_STEPS steps on the card against the CPU;
    then, on the card, TRAIN_RESUME_STEPS steps straight against a run
    checkpointed (async, through ``CheckpointManager``) at
    TRAIN_RESUME_SPLIT and resumed by a fresh ``Trainer.try_resume``.
    Per-step losses within TRAIN_LOSS_RTOL, parameters and optimizer
    state within TRAIN_PARAM_TOL."""
    from repro_torch.configs.registry import get_training
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    tr = get_training("dlrm-mlperf", reduced=True)
    cfg = dataclasses.replace(tr.config, dtype=torch.float32)
    params = tr.init(cfg, torch.Generator().manual_seed(43), masters=True)

    def loss_fn(p, b):
        return tr.loss(cfg, p, b)

    def batches(cursor):
        return numpy_train_batch(cfg, tr.batch_size, TRAIN_SEED + cursor)

    def trainer(where, ckpt_dir=None):
        return Trainer(loss_fn, params, TrainerConfig(
            opt=tr.opt, ckpt_dir=ckpt_dir, ckpt_every=TRAIN_RESUME_SPLIT,
            log_every=1), device=where)

    def compare(what, a, b, failures):
        la = {h["step"]: h["loss"] for h in a.history}
        lb = {h["step"]: h["loss"] for h in b.history}
        steps = sorted(la.keys() & lb.keys())
        loss_err = max(abs(la[s] - lb[s]) / abs(lb[s]) for s in steps)
        state_err = max(
            float((x.cpu() - y.cpu()).abs().max()) for x, y in
            zip(leaves(a.params) + leaves(a.opt_state["mu"])
                + leaves(a.opt_state["nu"]),
                leaves(b.params) + leaves(b.opt_state["mu"])
                + leaves(b.opt_state["nu"])))
        if not loss_err <= TRAIN_LOSS_RTOL:
            failures.append(f"recsys train {what}: losses differ by "
                            f"{loss_err:.3g} relative")
        if not state_err <= TRAIN_PARAM_TOL:
            failures.append(f"recsys train {what}: parameters or optimizer "
                            f"state differ by {state_err:.3g}")
        if a.step_num != b.step_num or a.data_cursor != b.data_cursor:
            failures.append(f"recsys train {what}: at step {a.step_num} and "
                            f"{b.step_num}")
        return {"steps": steps, "max_loss_rel_err": loss_err,
                "max_state_abs_err": state_err,
                "losses": [la[s] for s in steps]}

    failures: List[str] = []
    card, host = trainer(device), trainer("cpu")
    card.fit(batches, TRAIN_PARITY_STEPS)
    host.fit(batches, TRAIN_PARITY_STEPS)
    out = {"arch": f"{cfg.name} REDUCED (f32)", "batch": tr.batch_size,
           "card_vs_cpu": compare("card against CPU", card, host, failures)}
    with tempfile.TemporaryDirectory() as tmp:
        straight = trainer(device, str(Path(tmp) / "straight"))
        straight.fit(batches, TRAIN_RESUME_STEPS)
        first = trainer(device, str(Path(tmp) / "split"))
        first.fit(batches, TRAIN_RESUME_SPLIT)
        resumed = trainer(device, str(Path(tmp) / "split"))
        if not resumed.try_resume() or resumed.step_num != TRAIN_RESUME_SPLIT:
            failures.append("recsys train: no checkpoint to resume from at "
                            f"step {TRAIN_RESUME_SPLIT}")
        resumed.fit(batches, TRAIN_RESUME_STEPS)
        out["resume"] = compare("resumed against straight", resumed,
                                straight, failures)
    out["failures"] = failures
    return out


def recsys_train_phase(device, bag, adamw) -> dict:
    """dlrm-mlperf at its published widths with each table capped at
    TRAIN_ROW_CAP rows, f32 masters drawn on the card, trained through
    ``Trainer`` with the recsys bundle's optimizer on batches of
    ``train_batch`` rows: the kernel route's table gradients against the
    plain route's on one batch, TRAIN_WARMUP_STEPS warm-up steps and
    TRAIN_TIMED_STEPS timed ones (the bag kernel ``bag`` must launch once
    a step, the fused AdamW ``adamw`` once a leaf a step), one profiled
    step, AdamW and the bag's backward timed alone, then the REDUCED
    checks."""
    from repro_torch.configs.registry import get_training
    from repro_torch.kernels.embedding_bag.kernel import embedding_bags
    from repro_torch.kernels.embedding_bag.ref import embedding_bags_plain
    from repro_torch.train.optim import adamw_update
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves, tree_map

    t0 = time.perf_counter()
    failures: List[str] = []
    held = torch.cuda.memory_allocated(device)
    if held > TRAIN_FREE_BYTES:
        failures.append(f"recsys train: {held:,} B still allocated before "
                        "the phase")
    torch.cuda.reset_peak_memory_stats(device)
    tr = get_training("dlrm-mlperf")
    rows, cuts = capped_rows(tr.config.table_rows, TRAIN_ROW_CAP)
    cfg = dataclasses.replace(tr.config, table_rows=rows)
    B = tr.batch_size
    params = tr.init(cfg, torch.Generator(device=device).manual_seed(0),
                     masters=True)
    n_params = sum(t.numel() for t in leaves(params))
    if not all(t.dtype == torch.float32 for t in leaves(params)):
        failures.append("recsys train: masters are not all f32")

    def loss_fn(p, b):
        return tr.loss(cfg, p, b)

    # the gradient is real: kernel route against plain route, one batch
    gbatch = train_batch(cfg, B, TRAIN_SEED - 1, device)
    kern = route_grads(cfg, params, gbatch, embedding_bags)
    plain = route_grads(cfg, params, gbatch, embedding_bags_plain)
    tables, fails = grad_failures(kern, plain)
    failures += fails
    grad_loss = float(kern["loss"])
    del kern, plain, gbatch
    log(f"recsys train: gradient check done, device memory "
        f"{torch.cuda.memory_allocated(device):,} B")

    trainer = Trainer(loss_fn, params, TrainerConfig(opt=tr.opt, log_every=1),
                      device=device)
    del params
    n_steps = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS
    batches = {c: train_batch(cfg, B, TRAIN_SEED + c, device)
               for c in range(n_steps + 1)}    # one more for the profile
    get = batches.__getitem__
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"recsys train: {cfg.name}, {sum(rows):,} rows ({', '.join(cuts)}), "
        f"{n_params:,} f32 parameters, set-up {setup_s:.1f} s, device memory "
        f"{torch.cuda.memory_allocated(device):,} B")

    bag.launches = 0
    adamw.launches = 0
    for _ in range(TRAIN_WARMUP_STEPS):
        trainer.fit(get, trainer.step_num + 1)
        log(f"recsys train: step {trainer.step_num}, device memory "
            f"{torch.cuda.memory_allocated(device):,} B, peak "
            f"{torch.cuda.max_memory_allocated(device):,} B")
    step_s = []
    for _ in range(TRAIN_TIMED_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.fit(get, trainer.step_num + 1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
    launches = bag.launches
    expect = n_steps
    if launches != expect:
        failures.append(f"{bag.symbol}: {launches} launches in training, "
                        f"{expect} expected (one a step, {n_steps} steps)")
    n_leaves = len(leaves(trainer.params))
    adamw_launches, adamw_expect = adamw.launches, n_leaves * n_steps
    if adamw_launches != adamw_expect:
        failures.append(f"{adamw.symbol}: {adamw_launches} launches in "
                        f"training, {adamw_expect} expected (one a leaf a "
                        f"step, {n_leaves} leaves x {n_steps} steps)")
    losses = [h["loss"] for h in trainer.history]
    if not all(np.isfinite(losses)) or len(losses) != n_steps:
        failures.append(f"recsys train: losses {losses}")
    peak = torch.cuda.max_memory_allocated(device)
    profile = profile_train_step(trainer, get)
    grads = tree_map(torch.zeros_like, trainer.params)
    adamw_ms = cuda_ms(lambda: adamw_update(tr.opt, grads, trainer.opt_state,
                                            trainer.params, donate=True),
                       reps=3)
    del grads, trainer, batches
    torch.cuda.empty_cache()
    backward = bag_backward_case(TRAIN_ROW_CAP, cfg.embed_dim, B,
                                 torch.Generator(device=device).manual_seed(47),
                                 device)
    if not backward["max_abs_err"] <= BAG_F32_TOL:
        failures.append(f"embedding_bag backward differs from F.embedding's "
                        f"by {backward['max_abs_err']:.3g}")
    checks = reduced_train_checks(device)
    failures += checks.pop("failures")
    return {
        "arch": cfg.name, "published_rows": sum(tr.config.table_rows),
        "rows": sum(rows), "reduced": f"each table capped at "
        f"{TRAIN_ROW_CAP:,} rows: " + "; ".join(cuts),
        "parameters": n_params, "state_bytes": 16 * n_params, "batch": B,
        "opt": dataclasses.asdict(tr.opt), "setup_s": setup_s,
        "step": percentiles_ms(step_s),
        "samples_per_s": B * len(step_s) / sum(step_s),
        "losses": losses, "launches": launches, "expected_launches": expect,
        "adamw_launches": adamw_launches,
        "expected_adamw_launches": adamw_expect,
        "peak_mem_bytes": peak, "profile": profile, "adamw_ms": adamw_ms,
        "backward": backward,
        "grad_check": {"loss": grad_loss, "tables": tables},
        "reduced_checks": checks, "seconds": time.perf_counter() - t0,
        "failures": failures,
    }


# ------------------------------------------------------ the fused AdamW --
# the leaves the kernel is timed at: DLRM-MLPerf's capped t0 table and
# granite-3-2b's largest stacked leaf (its 40 layers' gate projection; the
# up and down projections are as large), f32 p and g as the trainer holds
# them
ADAMW_CASES = {"dlrm_t0": (TRAIN_ROW_CAP, 128),
               "granite_stacked": (40, 2048, 8192)}
ADAMW_REPS = 10
ADAMW_STEP = 1000    # the step of the bit-for-bit check (moments of a run)


def adamw_phase(device, kernel) -> dict:
    """The fused AdamW kernel (``kernel``, its ``CudaKernel``) at each of
    ADAMW_CASES, f32 p and g: one update from moments of a long run at
    step ADAMW_STEP with the clip active, out of place, against the plain
    version bit for bit in p, mu and nu; then, updating in place,
    ADAMW_REPS updates each of the kernel, the plain version and
    ``torch.optim.AdamW(fused=True)``'s step (the library's yardstick,
    which the port never calls) timed by CUDA events, beside the bound
    (``costs.adamw_cost``).  The kernel must launch once an update."""
    from repro_torch.kernels.adamw import adamw_leaf, adamw_leaf_plain
    from repro_torch.train.optim import OptConfig, schedule_lr

    t0 = time.perf_counter()
    failures = free_check("adamw", device)
    opt = OptConfig()
    hyper = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps,
                 weight_decay=opt.weight_decay)
    step = torch.tensor(ADAMW_STEP, dtype=torch.int32, device=device)
    s = step.to(torch.float32)
    scalars = (torch.tensor(0.25, device=device), schedule_lr(opt, step),
               1 - opt.b1 ** s, 1 - opt.b2 ** s)
    gen = torch.Generator(device=device).manual_seed(53)
    cases = {}
    for name, shape in ADAMW_CASES.items():
        p = torch.randn(shape, generator=gen, device=device)
        g = torch.randn(shape, generator=gen, device=device)
        mu = torch.randn(shape, generator=gen, device=device).mul_(0.1)
        nu = torch.rand(shape, generator=gen, device=device).mul_(0.01)
        want = adamw_leaf_plain(p, g, mu, nu, *scalars, donate=False,
                                **hyper)
        before = kernel.launches
        got = adamw_leaf(p, g, mu, nu, *scalars, donate=False, **hyper)
        torch.cuda.synchronize()
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(want, got))
        diff = max(float((a - b).abs().max()) for a, b in zip(want, got))
        del want, got
        launched = kernel.launches - before
        ms = cuda_ms(lambda: adamw_leaf(p, g, mu, nu, *scalars, donate=True,
                                        **hyper), reps=ADAMW_REPS)
        plain_ms = cuda_ms(lambda: adamw_leaf_plain(
            p, g, mu, nu, *scalars, donate=True, **hyper), reps=ADAMW_REPS)
        del mu, nu
        param = torch.nn.Parameter(p)
        param.grad = g
        lib = torch.optim.AdamW([param], lr=opt.lr, betas=(opt.b1, opt.b2),
                                eps=opt.eps, weight_decay=opt.weight_decay,
                                fused=True)
        library_ms = cuda_ms(lib.step, reps=ADAMW_REPS)
        del lib, param, p, g
        torch.cuda.empty_cache()
        n = int(np.prod(shape))
        cost = adamw_cost(n, torch.float32, torch.float32)
        cases[name] = {"shape": list(shape), "n": n,
                       "bit_identical": same, "max_abs_diff": diff,
                       "launches": launched, "ms": ms,
                       "bound_ms": cost.bound_ms(),
                       "bound_by": cost.bound_by(),
                       "roofline_share": cost.bound_ms() / ms,
                       "plain_ms": plain_ms, "library_ms": library_ms}
        if not same:
            failures.append(f"adamw {name}: the kernel's p, mu or nu differ "
                            f"from the plain version's (max {diff:.3g})")
        if launched != 1:
            failures.append(f"adamw {name}: {launched} launches for one "
                            "update")
    return {"cases": cases, "seconds": time.perf_counter() - t0,
            "failures": failures}


# ----------------------------------------------------------- MoE serving --
def free_check(label: str, device) -> List[str]:
    """Earlier phases' memory must be gone before a large phase: at most
    SERVE_FREE_BYTES still allocated.  Resets the peak."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    if held > SERVE_FREE_BYTES:
        return [f"{label}: {held:,} B still allocated before the phase"]
    return []


def moe_serve_phase(device, kernels) -> dict:
    """Moonlight-16B-A3B at the repo's full config (seeded random bf16
    weights, the router in f32) through ``ServeEngine``: MOE_SLOTS slots
    of MOE_S_MAX tokens, MOE_REQUESTS requests of MOE_PROMPT tokens and
    MOE_NEW new tokens each, then one profiled decode step.  Every row of
    a decode step takes part, so with 16 slots each expert has a
    capacity of one pick a step, for which the empty slots compete too
    (the reference's semantics)."""
    from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Request

    failures = free_check("moe serve", device)
    cfg = CONFIG
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    report, engine = serve_cell(
        cfg, params, device, kernels, "moe serve", slots=MOE_SLOTS,
        s_max=MOE_S_MAX, n_requests=MOE_REQUESTS, prompt=MOE_PROMPT,
        new=MOE_NEW, setup_s=time.perf_counter() - t0)
    report["failures"] = failures + report["failures"]
    if params["block"]["moe"]["router"]["w"].dtype != torch.float32:
        report["failures"].append("moe serve: the router is not f32")
    report["reduced"] = (f"S_max {MOE_S_MAX} (the granite cell's "
                         f"{SERVE_S_MAX} does not fit beside the weights)")
    # after the launch counts are read: profiling does not count
    report["profile"] = profile_decode_step(engine, Request, device)
    return report


def moe_qwen3_phase(device, kernels) -> dict:
    """Qwen3-235B-A22B at its published widths cut to QWEN3_LAYERS
    layers, through ``ServeEngine``: the wgmma flash kernel at GQA 16:1
    (64 heads over 4) and the paged kernel with 16 query heads a row."""
    from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Request

    failures = free_check("moe serve qwen3", device)
    cfg = dataclasses.replace(CONFIG, n_layers=QWEN3_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    report, engine = serve_cell(
        cfg, params, device, kernels, "moe serve qwen3", slots=QWEN3_SLOTS,
        s_max=QWEN3_S_MAX, n_requests=QWEN3_REQUESTS, prompt=MOE_PROMPT,
        new=QWEN3_NEW, setup_s=time.perf_counter() - t0)
    report["failures"] = failures + report["failures"]
    report["published_layers"] = CONFIG.n_layers
    report["reduced"] = (f"layers {CONFIG.n_layers} -> {QWEN3_LAYERS} "
                         f"({CONFIG.params_dense:,} parameters do not fit "
                         "one card)")
    report["profile"] = profile_decode_step(engine, Request, device)
    return report


def moe_parity_phase(device, kernels) -> dict:
    """Both MoE configs at REDUCED in float32, served on the card and
    replayed on the CPU with the card's tokens forced: logits within
    PARITY_TOL, equal ``stats()`` and tokens, the same expert picks in
    every ``moe_apply`` call and the same dropped count.  Their head dims
    (16 and 8) take the f32-route flash kernel: once per layer and prompt."""
    from repro_torch.configs import moonshot_v1_16b_a3b, qwen3_moe_235b_a22b
    from repro_torch.models.transformer import init_params

    out: Dict[str, dict] = {}
    failures: List[str] = []
    kw = dict(batch_slots=4, s_max=512, page_size=SERVE_PAGE, chain_limit=3)
    for mod in (moonshot_v1_16b_a3b, qwen3_moe_235b_a22b):
        cfg = dataclasses.replace(mod.REDUCED, dtype=torch.float32)
        params = init_params(cfg, torch.Generator(device=device).manual_seed(2))
        specs = parity_specs(cfg.vocab, 15)
        t0 = time.perf_counter()
        run = teacher_forced(cfg, params, device, kernels, specs, kw)
        failures += parity_failures(f"moe parity {cfg.name}", run, {
            "flash_attention": cfg.n_layers * len(specs),
            "flash_attention_wgmma": 0,
            "paged_attention": cfg.n_layers * run["card_stats"]["steps"]})
        if run["moe_calls"] == 0:
            failures.append(f"moe parity {cfg.name}: no moe_apply call")
        out[cfg.name] = {
            "selections": run["selections"],
            "max_abs_logit_err": max(run["errs"]),
            "tolerance": PARITY_TOL, "launches": run["launches"],
            "moe_calls": run["moe_calls"],
            "same_experts": run["same_experts"], "dropped": run["dropped"],
            "steps": run["card_stats"]["steps"],
            "seconds": time.perf_counter() - t0}
    launches: Dict[str, int] = {}
    for r in out.values():
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return {"configs": out, "launches": launches, "failures": failures}


# ------------------------------------------------------------ LM training --
def lm_route_grads(cfg, params: dict, batch: dict, attention: Callable) -> dict:
    """One forward and backward of ``lm_loss`` with the model's attention
    through ``attention`` (the kernel's ``autograd.Function``, or the
    plain version under autograd): the loss and every leaf's gradient."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.transformer import lm_loss
    from repro_torch.tree import leaves, tree_map

    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    orig, attn_mod.flash_attention_differentiable = (
        attn_mod.flash_attention_differentiable, attention)
    try:
        loss, _ = lm_loss(cfg, live, batch["tokens"], batch["labels"])
        grads = torch.autograd.grad(loss, leaves(live))
    finally:
        attn_mod.flash_attention_differentiable = orig
    return {"loss": loss.detach(), "grads": grads}


def lm_grad_failures(kernel: dict, plain: dict, names: List[str]) -> tuple:
    """The kernel route's gradients against the plain route's on one
    microbatch: the loss within LM_GRAD_LOSS_RTOL, each leaf within
    LM_GRAD_REL_L2 in relative L2 norm and non-zero."""
    failures: List[str] = []
    loss_rel = abs(float(kernel["loss"]) / float(plain["loss"]) - 1)
    if not loss_rel <= LM_GRAD_LOSS_RTOL:
        failures.append(f"lm train: kernel route loss {float(kernel['loss'])!r}"
                        f", plain route {float(plain['loss'])!r}")
    rel = {}
    for name, g, p in zip(names, kernel["grads"], plain["grads"]):
        norm = float(p.double().norm())
        rel[name] = float((g.double() - p.double()).norm()) / max(norm, 1e-30)
        if not rel[name] <= LM_GRAD_REL_L2:
            failures.append(f"lm train: gradient of {name} differs from the "
                            f"plain route's by {rel[name]:.3g} (relative L2)")
        if not bool(g.any()):
            failures.append(f"lm train: kernel route gradient of {name} is 0")
    return {"loss_rel_err": loss_rel, "max_rel_l2": max(rel.values()),
            "rel_l2": rel}, failures


def flash_backward_case(B: int, H: int, Hkv: int, S: int, D: int, dtype,
                        causal: bool, gen: torch.Generator, device,
                        views: bool = False, repeat: bool = False) -> dict:
    """The backward kernel on the route ``flash_backward_route`` picks,
    from the forward kernel's output and log-sum-exp, against the plain
    backward (delta from the same saved output) by ``backward_check``;
    timed beside the plain backward, the backward of
    ``scaled_dot_product_attention`` (K/V expanded outside its timing) and
    its bound.  ``views``: operands and dO made (B, S, heads, D) and
    transposed, as the model passes them.  ``repeat``: a second call on
    the same inputs must give the same bits (no float atomics)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        flash_backward_route,
        flash_route,
        run_backward,
        run_kernel,
    )
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_backward_plain,
    )

    q, k, v = flash_inputs(B, H, Hkv, S, D, dtype, gen, device, views=views)
    do = flash_inputs(B, H, H, S, D, dtype, gen, device, views=views)[0]
    out, lse = run_kernel(flash_route(dtype, D), q, k, v, causal,
                          return_lse=True)
    kernel = flash_backward_route(dtype, D)
    got = run_backward(kernel, q, k, v, out, lse, do, causal)
    plain = flash_attention_backward_plain(q, k, v, do, causal, out=out)
    torch.cuda.synchronize()
    check = backward_check(got, plain)
    del plain
    case = {"kernel": kernel.symbol, "shape": [B, H, Hkv, S, D],
            "dtype": str(dtype).split(".")[-1], "causal": causal,
            "views": views, **check,
            "max_abs_err": max(check[g]["max_abs_err"] for g in GRADS),
            "max_err_ratio": max(check[g]["max_err_ratio"] for g in GRADS)}
    if repeat:
        again = run_backward(kernel, q, k, v, out, lse, do, causal)
        case["bit_identical_rerun"] = all(
            torch.equal(a, b) for a, b in zip(got, again))
        del again
        case["kernels_ms"] = kernel_device_ms(
            lambda: run_backward(kernel, q, k, v, out, lse, do, causal),
            BACKWARD_KERNEL_NAMES if dtype == torch.bfloat16
            else TF32_BACKWARD_KERNEL_NAMES)
    del got
    ke = k.repeat_interleave(H // Hkv, dim=1).detach().requires_grad_(True)
    ve = v.repeat_interleave(H // Hkv, dim=1).detach().requires_grad_(True)
    qs = q.detach().requires_grad_(True)
    sdpa = F.scaled_dot_product_attention(qs, ke, ve, is_causal=causal)
    cost = flash_backward_cost(B, H, Hkv, S, D, dtype, causal)
    flops, nbytes = cost.flops, cost.nbytes
    reps = 5 if S * S * B * H > 1 << 28 else 20
    case.update({
        "ms": cuda_ms(lambda: run_backward(kernel, q, k, v, out, lse, do,
                                           causal)),
        "plain_ms": cuda_ms(lambda: flash_attention_backward_plain(
            q, k, v, do, causal, out=out), reps=reps),
        "library_ms": cuda_ms(lambda: torch.autograd.grad(
            sdpa, (qs, ke, ve), do, retain_graph=True), reps=reps),
        "bound_ms": cost.bound_ms(), "bound_by": cost.bound_by(),
        "flops": flops, "bytes": nbytes,
    })
    case["tflops"] = flops / case["ms"] / 1e9
    return case


def flash_backward_cases(lm_shape: tuple, device) -> Dict[str, dict]:
    """The backward kernel on both routes against the plain backward: the
    wgmma route at the lm train microbatch ``lm_shape`` (granite: B 2, 32
    heads over 8, S 4,096, D 64) on (B, S, H, D) views, also run twice for
    bit identity and profiled for its three kernels' device times; at D
    128 (16 heads over 16, S 1,023), at qwen3's GQA at D 128 (64 heads
    over 4, S 980, the forward's row), ragged causal at D 64 (32 over 8, S
    1,000) and at ragged S 1, 37 and 129 non-causal; the split-TF32 route in
    f32 at D 8 and 16 (the REDUCED configs' widths) and 64 (granite's
    heads, S 1,024; run twice for bit identity and profiled for its
    kernels), and in bf16 at D 16."""
    gen = torch.Generator(device=device).manual_seed(48)
    bf, f32 = torch.bfloat16, torch.float32
    _, H, Hkv, _, D = lm_shape
    cases = {  # name: (B, H, Hkv, S, D), dtype, causal, views, repeat
        "lm_train_bf16": (lm_shape, bf, True, True, True),
        "d128_bf16": ((1, 16, 16, 1023, 128), bf, True, False, False),
        "qwen3_d128_bf16": ((1, 64, 4, 980, 128), bf, True, False, False),
        "s1000_bf16": ((1, H, Hkv, 1000, D), bf, True, False, False),
        "s1_bf16": ((1, H, Hkv, 1, D), bf, False, False, False),
        "s37_bf16": ((1, H, Hkv, 37, D), bf, False, False, False),
        "s129_bf16": ((1, H, Hkv, 129, D), bf, False, False, False),
        "d8_f32": ((2, 8, 2, 517, 8), f32, True, False, False),
        "d16_f32": ((2, 4, 4, 517, 16), f32, True, False, False),
        "d64_f32": ((1, H, Hkv, 1024, D), f32, True, False, True),
        "d16_bf16": ((2, 4, 4, 517, 16), bf, True, False, False),
    }
    out = {}
    for name, (shape, dtype, causal, views, repeat) in cases.items():
        out[name] = flash_backward_case(*shape, dtype, causal, gen, device,
                                        views=views, repeat=repeat)
        torch.cuda.empty_cache()
    return out


def lm_reduced_checks(device, kernels=()) -> dict:
    """REDUCED granite-3-2b and Moonshot in f32 from the same seeded
    masters and the launcher's batches: LM_TRAIN_PARITY_STEPS steps of
    ``Trainer`` (the launcher's optimizer, 2 microbatches) on the card
    against the CPU; per-step losses within TRAIN_LOSS_RTOL, parameters
    and optimizer state within TRAIN_PARAM_TOL.  f32 at D 8 and 16 is the
    f32 routes' path: ``kernels``' launches on the card are counted,
    the f32-route backward must launch once a layer and microbatch, and
    the fused AdamW once a leaf a step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import synth_lm_batches
    from repro_torch.models.transformer import init_params, lm_loss
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    out: Dict[str, dict] = {}
    failures: List[str] = []
    opt = OptConfig(lr=3e-3, schedule="wsd", warmup_steps=20,
                    total_steps=LM_TRAIN_PARITY_STEPS)
    microbatches = 2
    backward_expect = adamw_expect = 0
    for k in kernels:
        k.launches = 0
    for arch in ("granite-3-2b", "moonshot-v1-16b-a3b"):
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  dtype=torch.float32)
        params = init_params(cfg, torch.Generator().manual_seed(44),
                             masters=True)
        batches = synth_lm_batches(cfg.vocab, 4, 64)
        runs = []
        for where in (device, "cpu"):
            tr = Trainer(lambda p, b: lm_loss(cfg, p, b["tokens"],
                                              b["labels"])[0],
                         params, TrainerConfig(opt=opt,
                                               microbatches=microbatches,
                                               log_every=1), device=where)
            tr.fit(batches, LM_TRAIN_PARITY_STEPS)
            runs.append(tr)
        backward_expect += cfg.n_layers * microbatches * LM_TRAIN_PARITY_STEPS
        adamw_expect += len(leaves(params)) * LM_TRAIN_PARITY_STEPS
        a, b = runs
        loss_err = max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
                       for x, y in zip(a.history, b.history))
        state_err = max(
            float((x.cpu() - y).abs().max()) for x, y in
            zip(leaves(a.params) + leaves(a.opt_state["mu"])
                + leaves(a.opt_state["nu"]),
                leaves(b.params) + leaves(b.opt_state["mu"])
                + leaves(b.opt_state["nu"])))
        if not loss_err <= TRAIN_LOSS_RTOL:
            failures.append(f"lm train {arch} REDUCED: losses differ by "
                            f"{loss_err:.3g} relative")
        if not state_err <= TRAIN_PARAM_TOL:
            failures.append(f"lm train {arch} REDUCED: parameters or "
                            f"optimizer state differ by {state_err:.3g}")
        out[arch] = {"steps": LM_TRAIN_PARITY_STEPS,
                     "max_loss_rel_err": loss_err,
                     "max_state_abs_err": state_err,
                     "losses": [h["loss"] for h in a.history]}
    out["launches"] = {k.symbol: k.launches for k in kernels}
    if kernels and out["launches"].get("flash_attention_backward") != \
            backward_expect:
        failures.append(
            f"lm train REDUCED: flash_attention_backward launched "
            f"{out['launches'].get('flash_attention_backward')} times on the "
            f"card, {backward_expect} expected (one a layer and microbatch: "
            f"the layers of both configs x {microbatches} microbatches x "
            f"{LM_TRAIN_PARITY_STEPS} steps)")
    if kernels and out["launches"].get("adamw") != adamw_expect:
        failures.append(
            f"lm train REDUCED: adamw launched "
            f"{out['launches'].get('adamw')} times on the card, "
            f"{adamw_expect} expected (one a leaf a step of both configs)")
    out["failures"] = failures
    return out


def lm_train_phase(device, kernels) -> dict:
    """granite-3-2b at its published widths and depth, f32 masters drawn
    on the card, trained through ``Trainer`` with the bundle's
    ``train_4k`` optimizer and microbatches on LM_TRAIN_BATCH x
    LM_TRAIN_SEQ batches of the launcher's ``synth_lm_batches``: first
    one microbatch's gradients through the kernel's ``Function`` and
    through the plain version under autograd, then LM_TRAIN_WARMUP
    warm-up and LM_TRAIN_TIMED timed steps (the wgmma flash kernel must
    launch twice per layer and microbatch, the forward and the remat
    recompute, the tensor-core backward kernel once, and the fused AdamW
    once a leaf a step), one profiled step, AdamW alone, the backward kernel against the plain backward
    (``flash_backward_cases``), and the REDUCED checks."""
    from repro_torch.configs.registry import get_bundle
    from repro_torch.kernels.flash_attention import kernel as flash_mod
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.launch.train import synth_lm_batches
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.optim import adamw_update
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import flatten_with_path, leaves, path_name, tree_map

    t0 = time.perf_counter()
    failures = free_check("lm train", device)
    bundle = get_bundle("granite-3-2b")
    cfg, mb = bundle.config, bundle.microbatches
    params = bundle.init(torch.Generator(device=device).manual_seed(0))
    names = [path_name(p) for p, _ in flatten_with_path(params)]
    n_params = sum(t.numel() for t in leaves(params))
    if not all(t.dtype == torch.float32 for t in leaves(params)):
        failures.append("lm train: masters are not all f32")
    data = synth_lm_batches(cfg.vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ)

    def batch_of(cursor):
        return {k: torch.as_tensor(v, device=device)
                for k, v in data(cursor).items()}

    # the gradient is real: kernel route against plain route, one microbatch
    split_s = {}
    t1 = time.perf_counter()
    first = batch_of(10_000)
    micro = {k: v[: LM_TRAIN_BATCH // mb] for k, v in first.items()}
    kern = lm_route_grads(cfg, params, micro, flash_mod.flash_attention_differentiable)
    plain = lm_route_grads(cfg, params, micro, lambda q, k, v, causal:
                           flash_attention_plain(q, k, v, causal))
    grad_check, fails = lm_grad_failures(kern, plain, names)
    failures += fails
    grad_check["loss"] = [float(kern["loss"]), float(plain["loss"])]
    del kern, plain, first, micro
    split_s["grad_check"] = time.perf_counter() - t1
    log(f"lm train: gradient check done, device memory "
        f"{torch.cuda.memory_allocated(device):,} B")

    trainer = Trainer(bundle.loss_fn(), params, TrainerConfig(
        opt=bundle.opt, microbatches=mb, log_every=1), device=device)
    del params
    n_steps = LM_TRAIN_WARMUP + LM_TRAIN_TIMED
    batches = {c: batch_of(c) for c in range(n_steps + 1)}
    get = batches.__getitem__
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"lm train: {cfg.name}, {n_params:,} f32 parameters, batch "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} in {mb} microbatches, set-up "
        f"{setup_s:.1f} s, device memory "
        f"{torch.cuda.memory_allocated(device):,} B")
    for k in kernels:
        k.launches = 0
        k.largest = None
    for _ in range(LM_TRAIN_WARMUP):
        trainer.fit(get, trainer.step_num + 1)
        log(f"lm train: step {trainer.step_num}, loss "
            f"{trainer.history[-1]['loss']:.4f}, peak "
            f"{torch.cuda.max_memory_allocated(device):,} B")
    step_s = []
    for _ in range(LM_TRAIN_TIMED):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.fit(get, trainer.step_num + 1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
    launches = {k.symbol: k.launches for k in kernels}
    largest = {k.symbol: k.largest for k in kernels}
    t1 = time.perf_counter()
    per_step = f"{cfg.n_layers} layers x {mb} microbatches x {n_steps} steps"
    n_leaves = len(leaves(trainer.params))
    expect = {  # name: (count, how it is derived)
        "flash_attention_wgmma": (2 * cfg.n_layers * mb * n_steps,
                                  f"forward and remat recompute: 2 x "
                                  f"{per_step}"),
        "flash_attention_backward_wgmma": (cfg.n_layers * mb * n_steps,
                                           f"one backward a layer and "
                                           f"microbatch: {per_step}"),
        "flash_attention": (0, "bf16 at D 64 takes the wgmma route"),
        "flash_attention_backward": (0, "bf16 at D 64 takes the wgmma "
                                     "route"),
        "paged_attention": (0, "no decode in training"),
        "adamw": (n_leaves * n_steps, f"one a leaf a step: {n_leaves} "
                  f"leaves x {n_steps} steps"),
    }
    for name, (n, why) in expect.items():
        if launches.get(name) != n:
            failures.append(f"lm train: {name} launched {launches.get(name)} "
                            f"times, {n} expected ({why})")
    losses = [h["loss"] for h in trainer.history]
    if not all(np.isfinite(losses)) or len(losses) != n_steps:
        failures.append(f"lm train: losses {losses}")
    peak = torch.cuda.max_memory_allocated(device)
    profile = profile_train_step(
        trainer, get,
        ranges={"adamw_update": (trainer_mod, "adamw_update")},
        forward=("flash_forward", "flash_attention"),
        named={"flash_backward": BACKWARD_KERNEL_NAMES})
    split_s["profile"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    grads = tree_map(torch.zeros_like, trainer.params)
    adamw_ms = cuda_ms(lambda: adamw_update(bundle.opt, grads,
                                            trainer.opt_state, trainer.params,
                                            donate=True), reps=3)
    del grads, trainer, batches
    torch.cuda.empty_cache()
    backward = flash_backward_cases(
        (LM_TRAIN_BATCH // mb, cfg.n_heads, cfg.n_kv_heads, LM_TRAIN_SEQ,
         cfg.d_head), device)
    for name, case in backward.items():
        if not case["within_tolerance"]:
            failures.append(
                f"{case['kernel']} differs from the plain backward at {name} "
                f"{case['shape']}: error " + ", ".join(
                    f"{g} {case[g]['max_err_ratio']:.3g}" for g in GRADS)
                + " times its limit")
        if case.get("bit_identical_rerun") is False:
            failures.append(f"{case['kernel']} at {name}: two calls on the "
                            "same inputs gave different bits")
    split_s["adamw_and_backward_alone"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    checks = lm_reduced_checks(device, kernels)
    failures += checks.pop("failures")
    failures += attention_grad_guard(device)
    split_s["reduced_and_guard"] = time.perf_counter() - t1
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    return {
        "arch": cfg.name, "parameters": n_params,
        "state_bytes": 16 * n_params, "layers": cfg.n_layers,
        "batch": [LM_TRAIN_BATCH, LM_TRAIN_SEQ], "microbatches": mb,
        "reduced": f"batch {bundle.shapes['train_4k'][0]} -> "
        f"{LM_TRAIN_BATCH} sequences of {LM_TRAIN_SEQ}",
        "opt": dataclasses.asdict(bundle.opt), "setup_s": setup_s,
        "step": percentiles_ms(step_s),
        "tokens_per_s": tokens * len(step_s) / sum(step_s),
        "losses": losses, "launches": launches, "largest": largest,
        "expected_launches": {k: n for k, (n, _) in expect.items()},
        "peak_mem_bytes": peak,
        "profile": profile, "adamw_ms": adamw_ms, "backward": backward,
        "grad_check": grad_check, "reduced_checks": checks,
        "split_s": split_s,
        "seconds": time.perf_counter() - t0, "failures": failures,
    }


def one_step(trainer, batch: dict, device) -> dict:
    """One ``Trainer`` step on ``batch``: its host time (synchronised),
    its loss, and the peak allocation above what was held before it."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    trainer.fit(lambda _: batch, trainer.step_num + 1)
    torch.cuda.synchronize()
    return {"s": time.perf_counter() - t,
            "loss": trainer.history[-1]["loss"],
            "held_bytes": held,
            "peak_bytes": torch.cuda.max_memory_allocated(device),
            "step_peak_bytes": torch.cuda.max_memory_allocated(device) - held}


def mesh_moe_step(mesh, device, kernels, failures: List[str]) -> dict:
    """moonshot-v1-16b-a3b at its published widths, MESH_MOE_LAYERS
    layers, f32 masters: one step of one MESH_MOE_BATCH microbatch
    without a mesh, then on ``mesh`` through the tensor- and
    expert-parallel route, from the same params and batch."""
    from repro_torch.configs.families import lm_bundle
    from repro_torch.configs.registry import get_bundle
    from repro_torch.distributed.hooks import use_mesh
    from repro_torch.distributed.sharding import place
    from repro_torch.distributed.tensor_parallel import MODEL_COLLECTIVES
    from repro_torch.launch.train import synth_lm_batches
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import flatten_with_path, leaves, path_name, tree_map

    full = get_bundle("moonshot-v1-16b-a3b")
    cfg = dataclasses.replace(full.config, n_layers=MESH_MOE_LAYERS)
    bundle = lm_bundle(full.name, cfg, opt=full.opt, microbatches=1)
    params = bundle.init(torch.Generator(device=device).manual_seed(0))
    n_params = sum(t.numel() for t in leaves(params))
    batch = {k: torch.as_tensor(v, device=device) for k, v in
             synth_lm_batches(cfg.vocab, *MESH_MOE_BATCH)(0).items()}
    tc = TrainerConfig(opt=bundle.opt, microbatches=1, log_every=1)
    plain_tr = Trainer(bundle.loss_fn(), params, tc, device=device)
    plain = one_step(plain_tr, batch, device)
    plain["dropped_tokens"] = plain_tr.loss_fn.take_dropped()
    plain_params = plain_tr.params
    del plain_tr
    torch.cuda.empty_cache()
    placed = tree_map(place, params, bundle.param_shardings(mesh))
    mesh_tr = Trainer(bundle.loss_fn(), placed, tc, device=device)
    del placed, params
    for k in kernels:
        k.launches = 0
    MODEL_COLLECTIVES.reset()
    with use_mesh(mesh):
        sharded = one_step(mesh_tr, batch, device)
    launches = {k.symbol: k.launches for k in kernels}
    sharded["dropped_tokens"] = mesh_tr.loss_fn.take_dropped()
    collectives = MODEL_COLLECTIVES.count
    worst, same = 0.0, 0
    for (p, a), b in zip(flatten_with_path(mesh_tr.params),
                         leaves(plain_params)):
        a = a.to_local()
        same += bool(torch.equal(a, b))
        scale = max(float(b.abs().max()), 1e-30)
        worst = max(worst, float((a.double() - b.double()).abs().max())
                    / scale)
    loss_rel = abs(sharded["loss"] / plain["loss"] - 1)
    expect = 2 * cfg.n_layers
    n_leaves = len(leaves(plain_params))
    out = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "batch": list(MESH_MOE_BATCH), "unsharded": plain,
           "sharded": sharded, "model_collectives": collectives,
           "loss_rel_err": loss_rel,
           "loss_bit_identical": sharded["loss"] == plain["loss"],
           "params_bit_identical": same,
           "n_params_leaves": n_leaves,
           "param_max_rel_err": worst, "launches": launches,
           "expected_flash_wgmma_launches": expect,
           "expected_flash_backward_wgmma_launches": cfg.n_layers,
           "expected_adamw_launches": n_leaves}
    log(f"mesh moe: {n_params:,} params, unsharded step {plain['s']:.2f} s, "
        f"mesh step {sharded['s']:.2f} s, loss {sharded['loss']:.6f} vs "
        f"{plain['loss']:.6f}, params within {worst:.3g} ({same} of "
        f"{out['n_params_leaves']} bit for bit), drops "
        f"{sharded['dropped_tokens']:.0f} vs {plain['dropped_tokens']:.0f}, "
        f"{collectives} model collectives")
    if loss_rel > MESH_MOE_RTOL or worst > MESH_MOE_RTOL:
        failures.append(f"mesh moe: the mesh step differs from the "
                        f"unsharded one: loss {loss_rel:.3g}, params "
                        f"{worst:.3g} relative (at most {MESH_MOE_RTOL})")
    if sharded["dropped_tokens"] != plain["dropped_tokens"]:
        failures.append(f"mesh moe: {sharded['dropped_tokens']} drops on the "
                        f"mesh, {plain['dropped_tokens']} unsharded")
    if collectives == 0:
        failures.append("mesh moe: the mesh step issued no model collective")
    if launches.get("flash_attention_wgmma") != expect or launches.get(
            "flash_attention_backward_wgmma") != cfg.n_layers:
        failures.append(f"mesh moe: flash kernels launched {launches}, "
                        f"{expect} forward and {cfg.n_layers} backward "
                        f"expected")
    if launches.get("adamw") != n_leaves:
        failures.append(f"mesh moe: adamw launched {launches.get('adamw')} "
                        f"times, {n_leaves} expected (one a leaf)")
    del mesh_tr, plain_params, batch
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def lse_route_calls():
    """Counts the paged-kernel calls that ``models.attention`` makes with
    ``return_lse`` (the route of a decode cache split over ``model``)
    inside the block: yields a one-entry list."""
    import repro_torch.models.attention as attention_mod

    calls = [0]
    inner = attention_mod.paged_attention

    def spy(*args, **kwargs):
        calls[0] += bool(kwargs.get("return_lse"))
        return inner(*args, **kwargs)

    attention_mod.paged_attention = spy
    try:
        yield calls
    finally:
        attention_mod.paged_attention = inner


def serve_steps(bundle, params, tokens: torch.Tensor, lens: torch.Tensor,
                steps: torch.Tensor, device) -> dict:
    """``bundle``'s prefill step on ``tokens`` (B, S), then one decode
    step a row of ``steps`` on a cache of the prompt's K/V (S_max = S)
    whose rows are cut back to ``lens``; ``params`` plain (no mesh) or
    placed on a mesh.  Host times are synchronised."""
    prefill = bundle.serve_step("prefill_32k")
    decode = bundle.serve_step("decode_32k")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    logits, kv = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    out = {"prefill_s": time.perf_counter() - t, "prefill": logits,
           "prefill_dropped": float(kv.get("moe_dropped", 0.0))}
    cache = {"k": kv["k"], "v": kv["v"], "len": lens.clone()}
    del kv
    logits, dropped, times = [], [], []
    for tok in steps:
        t = time.perf_counter()
        got, c = decode(params, {"token": tok, "cache": cache})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        cache["len"] = c["len"]
        logits.append(got)
        dropped.append(float(c.get("moe_dropped", 0.0)))
    out.update({"decode": torch.stack(logits), "dropped": dropped,
                "decode_s": times, "cache": cache,
                "peak_bytes": torch.cuda.max_memory_allocated(device)})
    return out


def mesh_serve_step(arch: str, mesh, device, kernels, failures: List[str],
                    batch: tuple = MESH_SERVE_BATCH,
                    layers: Optional[int] = None,
                    rtol: Optional[float] = None) -> dict:
    """``arch``'s serve cells at its published widths (``layers`` cut, or
    its own depth) in bf16 serving weights: the bundle's prefill step on
    ``batch`` rows x tokens, then MESH_SERVE_STEPS decode steps of those
    rows on the prompt's K/V (S_max = its length, each row cut back to a
    length of its own), without a mesh and then on ``mesh`` through
    ``LMBundle.serve_step`` (the weights' ``model`` shards, the cache's
    sequence over ``model``), from the same params and inputs.  The
    logits of every step and the whole cache are held bit for bit
    (``rtol`` None) or within ``rtol`` of the largest value (identity
    reported); MoE drops equal; the mesh run's ``model`` collectives
    above 0; the wgmma flash kernel once a layer (the prefill) and the
    paged kernel once a layer and step, every call of it through the
    log-sum-exp route."""
    from repro_torch.configs.families import lm_bundle
    from repro_torch.configs.registry import get_bundle
    from repro_torch.distributed.sharding import place
    from repro_torch.distributed.tensor_parallel import MODEL_COLLECTIVES
    from repro_torch.tree import tree_map

    full = get_bundle(arch)
    cfg = full.config if layers is None else dataclasses.replace(
        full.config, n_layers=layers)
    bundle = lm_bundle(full.name, cfg, opt=full.opt)
    params = bundle.init(torch.Generator(device=device).manual_seed(0),
                         masters=False)
    B, S = batch
    gen = torch.Generator(device=device).manual_seed(11)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device=device, dtype=torch.int32)
    steps = torch.randint(0, cfg.vocab, (MESH_SERVE_STEPS, B), generator=gen,
                          device=device, dtype=torch.int32)
    # rows cut back to lengths of their own, one of them full (it stays
    # unwritten), the first reaching S_max at the last step
    lens = (S - MESH_SERVE_STEPS - 61 * torch.arange(B, device=device)).clamp(
        min=1).to(torch.int32)
    lens[-1] = S
    plain = serve_steps(bundle, params, tokens, lens, steps, device)
    placed = tree_map(place, params, bundle.param_shardings(mesh))
    for k in kernels:
        k.launches = 0
    MODEL_COLLECTIVES.reset()
    with lse_route_calls() as lse_calls:
        sharded = serve_steps(bundle, placed, tokens, lens, steps, device)
    launches = {k.symbol: k.launches for k in kernels}
    collectives = MODEL_COLLECTIVES.count
    del placed, params
    errs, same = {}, {}
    for key, a, b in (("prefill", sharded["prefill"], plain["prefill"]),
                      ("decode", sharded["decode"], plain["decode"]),
                      ("cache_k", sharded["cache"]["k"], plain["cache"]["k"]),
                      ("cache_v", sharded["cache"]["v"],
                       plain["cache"]["v"])):
        same[key] = bool(torch.equal(a, b))
        errs[key] = float((a.double() - b.double()).abs().max()) / max(
            float(b.double().abs().max()), 1e-30)
    n_steps = MESH_SERVE_STEPS
    expect = {"flash_attention_wgmma": cfg.n_layers,
              "paged_attention": cfg.n_layers * n_steps,
              "lse_route": cfg.n_layers * n_steps}
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": [B, S],
           "decode_steps": n_steps, "bit_identical": same,
           "max_rel_err": errs, "launches": launches,
           "lse_route_calls": lse_calls[0], "expected": expect,
           "model_collectives": collectives,
           "dropped": {"unsharded": [plain["prefill_dropped"]]
                       + plain["dropped"],
                       "mesh": [sharded["prefill_dropped"]]
                       + sharded["dropped"]}}
    for name, run in (("unsharded", plain), ("mesh", sharded)):
        out[name] = {"prefill_ms": run["prefill_s"] * 1e3,
                     "decode_ms": [t * 1e3 for t in run["decode_s"]],
                     "decode_p50_ms": float(np.median(run["decode_s"]))
                     * 1e3, "peak_bytes": run["peak_bytes"]}
    label = f"mesh serve {cfg.name}"
    log(f"{label}: {cfg.n_layers} layers, prefill {B}x{S} "
        f"{out['unsharded']['prefill_ms']:.1f} ms unsharded / "
        f"{out['mesh']['prefill_ms']:.1f} ms on the mesh, decode p50 "
        f"{out['unsharded']['decode_p50_ms']:.2f} / "
        f"{out['mesh']['decode_p50_ms']:.2f} ms, bit for bit {same}, "
        f"relative {errs}, {collectives} model collectives, launches "
        f"{launches}, lse route {lse_calls[0]}")
    if rtol is None and not all(same.values()):
        failures.append(f"{label}: the one-rank mesh run differs from the "
                        f"unsharded one bit for bit: {same}, {errs}")
    if rtol is not None and max(errs.values()) > rtol:
        failures.append(f"{label}: the mesh run differs from the unsharded "
                        f"one by {errs} of the largest value (at most "
                        f"{rtol})")
    if out["dropped"]["unsharded"] != out["dropped"]["mesh"]:
        failures.append(f"{label}: MoE drops {out['dropped']}")
    if collectives == 0:
        failures.append(f"{label}: the mesh run issued no model collective")
    got = {"flash_attention_wgmma": launches.get("flash_attention_wgmma"),
           "paged_attention": launches.get("paged_attention"),
           "lse_route": lse_calls[0]}
    if got != expect:
        failures.append(f"{label}: launches {launches} and {lse_calls[0]} "
                        f"log-sum-exp calls, {expect} expected")
    del plain, sharded
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def one_rank_mesh():
    """A one-rank NCCL process group, set up from a FileStore in a
    temporary directory (no network), and its ``make_host_mesh()`` (1, 1)
    ``("data", "model")`` mesh; the group is destroyed after the block.
    The allocator's cache is emptied first: NCCL allocates its own device
    buffers, and after the bag phase's cases the cache held so much of
    the card beside DLRM's tables that its setup failed (``unhandled
    cuda error``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, device_id=torch.device(
                "cuda", torch.cuda.current_device()))
        try:
            yield make_host_mesh()
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's deterministic algorithms inside the block (warnings, not
    errors, for an op that has none), as they were after it."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def mesh_recsys_step(arch: str, mesh, device, bag, failures: List[str],
                     batch_size: Optional[int] = None,
                     users: Optional[int] = None) -> dict:
    """One ``train_batch`` step of ``arch`` in f32 masters through
    ``Trainer`` with the recsys bundle's optimizer, without a mesh and
    then on ``mesh`` from the same params and batch, one trainer on the
    card at a time (the initial params and the unsharded step's result
    are kept on the host, and the mesh step is held to them there):
    dlrm-mlperf at its published widths with each table capped at
    TRAIN_ROW_CAP rows, as ``recsys_train_phase`` takes it, on a batch
    of its ``train_batch`` rows; two-tower-retrieval at its published
    widths with MESH_TWO_TOWER_USERS user rows on MESH_TWO_TOWER_BATCH
    rows (``batch_size`` and ``users`` override both;
    ``scripts/mesh_fit.py`` finds what fits).  The mesh step
    looks the tables up where their rows lie (``row_parallel``; on a
    one-rank mesh every table is one block of ``("data", "model")``, and
    every collective of the route runs over the one rank) and computes
    the MLPs' columns.  Loss and every param bit for bit, the step's peak
    at most MESH_PEAK_RATIO of the unsharded step's, the lookups' and
    ``model``'s collectives above 0, and DLRM's bag kernel launched once
    in each step.  The caller runs it under
    :func:`deterministic_algorithms`: the tables' gradients are
    ``index_add_`` sums, whose CUDA atomics add a small table's many
    duplicate rows in an order that changes from run to run (DLRM's
    35-row ``t25`` differed in its last bits between the two steps
    without it); its deterministic route sorts them."""
    from repro_torch.configs.registry import get_training
    from repro_torch.distributed.hooks import use_mesh
    from repro_torch.distributed.row_parallel import ROW_COLLECTIVES
    from repro_torch.distributed.sharding import (
        RECSYS_RULES,
        is_sharded,
        place,
        shard_by_rules,
    )
    from repro_torch.distributed.tensor_parallel import MODEL_COLLECTIVES
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import flatten_with_path, leaves, path_name, tree_map

    tr = get_training(arch)
    gen = torch.Generator(device=device).manual_seed(TRAIN_SEED)
    if arch == "dlrm-mlperf":
        rows, cuts = capped_rows(tr.config.table_rows, TRAIN_ROW_CAP)
        cfg = dataclasses.replace(tr.config, table_rows=rows)
        B = batch_size or tr.batch_size
        batch = train_batch(cfg, B, TRAIN_SEED, device)
    else:
        cfg = dataclasses.replace(
            tr.config, n_users=min(tr.config.n_users,
                                   users or MESH_TWO_TOWER_USERS))
        cuts = ([] if cfg.n_users == tr.config.n_users else
                [f"user: {tr.config.n_users:,} -> {cfg.n_users:,}"])
        B = batch_size or MESH_TWO_TOWER_BATCH
        if B != tr.batch_size:
            cuts.append(f"batch: {tr.batch_size:,} -> {B:,}")
        batch = {"user_id": _ids(gen, device, cfg.n_users, B),
                 "user_ctx": _ids(gen, device, cfg.n_context, B),
                 "item_id": _ids(gen, device, cfg.n_items, B),
                 "item_cat": _ids(gen, device, cfg.n_context, B)}
    tr = dataclasses.replace(tr, config=cfg)
    params = tree_map(lambda t: t.cpu(), tr.init(
        cfg, torch.Generator(device=device).manual_seed(0), masters=True))
    n_params = sum(t.numel() for t in leaves(params))
    tc = TrainerConfig(opt=tr.opt, log_every=1)
    plain_tr = Trainer(tr.loss_fn(), params, tc, device=device)
    bag.launches = 0
    plain = one_step(plain_tr, batch, device)
    plain["bag_launches"] = bag.launches
    plain_params = [t.cpu() for t in leaves(plain_tr.params)]
    del plain_tr
    torch.cuda.empty_cache()
    on_card = tree_map(lambda t: t.to(device), params)
    placed = tree_map(place, on_card, shard_by_rules(on_card, mesh,
                                                     RECSYS_RULES))
    mesh_tr = Trainer(tr.loss_fn(), placed, tc, device=device)
    del placed, on_card, params
    torch.cuda.empty_cache()
    bag.launches = 0
    ROW_COLLECTIVES.reset()
    MODEL_COLLECTIVES.reset()
    with use_mesh(mesh):
        sharded = one_step(mesh_tr, batch, device)
    sharded["bag_launches"] = bag.launches
    rows_n, model_n = ROW_COLLECTIVES.count, MODEL_COLLECTIVES.count
    differ = [path_name(p) for (p, a), b in zip(
        flatten_with_path(mesh_tr.params), plain_params)
        if not (is_sharded(a) and torch.equal(a.to_local().cpu(), b))]
    same_loss = sharded["loss"] == plain["loss"]
    ratio = sharded["step_peak_bytes"] / plain["step_peak_bytes"]
    out = {"arch": arch, "batch": B, "params": n_params, "cuts": cuts,
           "unsharded": plain, "sharded": sharded,
           "loss_bit_identical": same_loss, "params_differing": differ[:10],
           "n_params_differing": len(differ), "step_peak_ratio": ratio,
           "row_collectives": rows_n, "model_collectives": model_n,
           "deterministic_algorithms": True}
    log(f"mesh {arch}: {n_params:,} params, unsharded step "
        f"{plain['s']:.2f} s, mesh step {sharded['s']:.2f} s, loss "
        f"{sharded['loss']:.6f} vs {plain['loss']:.6f}, {len(differ)} params "
        f"differ, step peak ratio {ratio:.4f}, {rows_n} lookup and "
        f"{model_n} model collectives, bag launches "
        f"{plain['bag_launches']} / {sharded['bag_launches']}")
    if not same_loss or differ:
        failures.append(
            f"mesh {arch}: the one-rank mesh step differs from the "
            f"unsharded one: loss {sharded['loss']!r} vs {plain['loss']!r}, "
            f"{len(differ)} params differ ({differ[:3]})")
    if ratio > MESH_PEAK_RATIO:
        failures.append(f"mesh {arch}: the mesh step's peak is {ratio:.4f} "
                        f"of the unsharded step's (at most "
                        f"{MESH_PEAK_RATIO})")
    if rows_n == 0 or model_n == 0:
        failures.append(f"mesh {arch}: {rows_n} lookup and {model_n} model "
                        "collectives (the route issues both)")
    if arch == "dlrm-mlperf" and (plain["bag_launches"], sharded[
            "bag_launches"]) != (1, 1):
        failures.append(f"mesh {arch}: the bag kernel launched "
                        f"{plain['bag_launches']} / {sharded['bag_launches']} "
                        "times in the unsharded / mesh step, once expected")
    del mesh_tr, plain_params, batch
    torch.cuda.empty_cache()
    return out


def mesh_phase(device, kernels, bag) -> dict:
    """The sharding slice on a one-rank NCCL group, set up from a
    FileStore in a temporary directory (no network): ``compressed_psum``
    against ``dequantize_int8(*quantize_int8(x))`` bit for bit, a bf16
    checkpoint of CUDA tensors saved and restored bit for bit, and one
    granite-3-2b training step at its published widths (the bundle's
    ``train_4k`` optimizer and microbatches, LM_TRAIN_BATCH x
    LM_TRAIN_SEQ) on ``make_host_mesh()`` against the same step without
    a mesh, from the same params and batch: the loss and every updated
    param bit for bit, the step's peak at most MESH_PEAK_RATIO of the
    unsharded step's, and the wgmma flash kernel and the backward kernel
    launched by it (the backward has no float atomics, so both steps'
    gradients are the same bits), and the fused AdamW once a leaf.  The mesh step computes on the
    weights' ``model`` shards (``distributed.tensor_parallel``: on a
    one-rank axis each shard is the whole weight, and every collective of
    the route runs over the one rank); the count of ``model`` collectives
    it issued must be above 0.  Then moonshot-v1-16b-a3b at its published
    widths cut to MESH_MOE_LAYERS layers (about 1.5 B params, f32
    masters): one step of one microbatch of MESH_MOE_BATCH, unsharded and
    then on the mesh (the first trainer freed before the second), held
    to each other within MESH_MOE_RTOL (loss and each param, over its
    largest value; bit-identity reported) with equal MoE drops, the
    ``model`` collectives above 0 and the flash kernels and AdamW
    launched as expected.  Then the LM serve cells on the mesh
    (:func:`mesh_serve_step`): granite-3-2b at its published widths, a
    prefill of MESH_SERVE_BATCH and MESH_SERVE_STEPS decode steps, bit
    for bit against the same steps without a mesh, and moonshot cut to
    MESH_SERVE_MOE_LAYERS layers on MESH_SERVE_MOE_BATCH within
    MESH_SERVE_MOE_RTOL.  Last, DLRM's and two-tower's steps through the
    row-sharded route, each against its unsharded step
    (:func:`mesh_recsys_step`; ``bag`` is the bag kernel, launched by
    DLRM's)."""
    import os

    import torch.distributed as dist

    from repro_torch.ckpt.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs.registry import get_bundle
    from repro_torch.distributed.compression import (
        compressed_psum,
        dequantize_int8,
        quantize_int8,
    )
    from repro_torch.distributed.hooks import use_mesh
    from repro_torch.distributed.sharding import is_sharded, place
    from repro_torch.distributed.tensor_parallel import MODEL_COLLECTIVES
    from repro_torch.launch.train import synth_lm_batches
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import flatten_with_path, leaves, path_name, tree_map

    t0 = time.perf_counter()
    failures = free_check("mesh", device)
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp, one_rank_mesh() as mesh:
        out["mesh"] = {"shape": list(mesh.shape),
                       "axes": list(mesh.mesh_dim_names),
                       "backend": dist.get_backend()}
        gen = torch.Generator(device=device).manual_seed(61)
        x = torch.randn(MESH_PSUM_SHAPE, generator=gen, device=device)
        psum = compressed_psum(x)
        out["psum_bit_identical"] = bool(torch.equal(
            psum, dequantize_int8(*quantize_int8(x))))
        del x, psum
        if not out["psum_bit_identical"]:
            failures.append("mesh: compressed_psum on one rank differs "
                            "from dequantize(quantize(x))")

        tree = {"w": torch.randn((4096, 2048), generator=gen,
                                 device=device).to(torch.bfloat16),
                "b": torch.randn((2048,), generator=gen,
                                 device=device).to(torch.bfloat16),
                "s": torch.randn((7,), generator=gen, device=device)}
        ck = os.path.join(tmp, "ckpt")
        save_checkpoint(ck, 1, tree)
        back, _, _, _ = load_checkpoint(ck, tree, device=device)
        out["bf16_checkpoint_bit_identical"] = all(
            a.dtype == b.dtype and a.device == b.device and torch.equal(
                a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
            for a, b in zip(leaves(back), leaves(tree)))
        del tree, back
        if not out["bf16_checkpoint_bit_identical"]:
            failures.append("mesh: a bf16 checkpoint of CUDA tensors "
                            "did not restore bit for bit")

        bundle = get_bundle("granite-3-2b")
        cfg, mb = bundle.config, bundle.microbatches
        params = bundle.init(torch.Generator(device=device).manual_seed(0))
        batch = {k: torch.as_tensor(v, device=device) for k, v in
                 synth_lm_batches(cfg.vocab, LM_TRAIN_BATCH,
                                  LM_TRAIN_SEQ)(0).items()}
        tc = TrainerConfig(opt=bundle.opt, microbatches=mb, log_every=1)
        plain_tr = Trainer(bundle.loss_fn(), params, tc, device=device)
        plain = one_step(plain_tr, batch, device)
        plain_params = plain_tr.params
        del plain_tr
        log(f"mesh: unsharded step {plain['s']:.2f} s, loss "
            f"{plain['loss']:.6f}, step peak "
            f"{plain['step_peak_bytes']:,} B")

        placed = tree_map(place, params, bundle.param_shardings(mesh))
        mesh_tr = Trainer(bundle.loss_fn(), placed, tc, device=device)
        del placed, params
        for k in kernels:
            k.launches = 0
        MODEL_COLLECTIVES.reset()
        with use_mesh(mesh):
            sharded = one_step(mesh_tr, batch, device)
        launches = {k.symbol: k.launches for k in kernels}
        collectives = MODEL_COLLECTIVES.count
        log(f"mesh: one-rank mesh step {sharded['s']:.2f} s, loss "
            f"{sharded['loss']:.6f}, step peak "
            f"{sharded['step_peak_bytes']:,} B, {collectives} model "
            f"collectives")
        differ = [path_name(p) for (p, a), b in zip(
            flatten_with_path(mesh_tr.params), leaves(plain_params))
            if not (is_sharded(a) and torch.equal(a.to_local(), b))]
        same_loss = sharded["loss"] == plain["loss"]
        ratio = sharded["step_peak_bytes"] / plain["step_peak_bytes"]
        expect = 2 * cfg.n_layers * mb
        expect_bwd = cfg.n_layers * mb
        expect_adamw = len(leaves(plain_params))
        out.update({
            "arch": cfg.name, "batch": [LM_TRAIN_BATCH, LM_TRAIN_SEQ],
            "microbatches": mb, "unsharded": plain, "sharded": sharded,
            "loss_bit_identical": same_loss,
            "params_differing": differ[:10],
            "n_params_differing": len(differ),
            "step_peak_ratio": ratio, "launches": launches,
            "model_collectives": collectives,
            "expected_flash_wgmma_launches": expect,
            "expected_flash_backward_wgmma_launches": expect_bwd,
            "expected_adamw_launches": expect_adamw})
        if collectives == 0:
            failures.append("mesh: the mesh step issued no model "
                            "collective (not the tensor-parallel route)")
        if not same_loss or differ:
            failures.append(
                f"mesh: the one-rank mesh step differs from the unsharded "
                f"one: loss {sharded['loss']!r} vs {plain['loss']!r}, "
                f"{len(differ)} params differ ({differ[:3]})")
        if ratio > MESH_PEAK_RATIO:
            failures.append(f"mesh: the mesh step's peak is {ratio:.4f} "
                            f"of the unsharded step's (at most "
                            f"{MESH_PEAK_RATIO})")
        if launches.get("flash_attention_wgmma") != expect:
            failures.append(
                f"mesh: flash_attention_wgmma launched "
                f"{launches.get('flash_attention_wgmma')} times in the "
                f"mesh step, {expect} expected")
        if launches.get("flash_attention_backward_wgmma") != expect_bwd:
            failures.append(
                f"mesh: flash_attention_backward_wgmma launched "
                f"{launches.get('flash_attention_backward_wgmma')} times "
                f"in the mesh step, {expect_bwd} expected (one a layer "
                f"and microbatch: {cfg.n_layers} x {mb})")
        if launches.get("adamw") != expect_adamw:
            failures.append(
                f"mesh: adamw launched {launches.get('adamw')} times in the "
                f"mesh step, {expect_adamw} expected (one a leaf)")
        del mesh_tr, plain_params, batch
        out["moe"] = mesh_moe_step(mesh, device, kernels, failures)
        out["serve"] = mesh_serve_step("granite-3-2b", mesh, device,
                                       kernels, failures)
        out["serve_moe"] = mesh_serve_step(
            "moonshot-v1-16b-a3b", mesh, device, kernels, failures,
            batch=MESH_SERVE_MOE_BATCH, layers=MESH_SERVE_MOE_LAYERS,
            rtol=MESH_SERVE_MOE_RTOL)
        with deterministic_algorithms():
            out["recsys"] = {arch: mesh_recsys_step(arch, mesh, device,
                                                    bag, failures)
                             for arch in MESH_RECSYS}
    torch.cuda.empty_cache()
    out["failures"] = failures
    out["seconds"] = time.perf_counter() - t0
    return out


def start_dryrun_cells(runs: Sequence[Sequence[str]]
                       ) -> List[subprocess.Popen]:
    """The dry run of cells (``launch.dryrun``) as the processes of
    ``runs`` (each a sequence of ``launch.dryrun`` argument strings run
    in turn): it traces on the CPU with no data and no card, in processes
    of its own (a fake process group must not meet an NCCL group), each
    on one thread; they are stopped when this process exits.
    :func:`dryrun_phase` starts and reads them."""
    import atexit

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for run in runs:
        log_file = tempfile.TemporaryFile("w+")   # a pipe could fill
        procs.append(subprocess.Popen(
            ["bash", "-c", " && ".join(
                f"{sys.executable} -m repro_torch.launch.dryrun {args}"
                for args in run)],
            cwd=str(ROOT), env=env, stdout=log_file,
            stderr=subprocess.STDOUT, text=True))
        procs[-1].log_file = log_file

    def stop():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(stop)
    return procs


def dryrun_failures(dry: dict, real: dict) -> List[str]:
    """Where the dry run of a step (``launch.dryrun.run``'s dict) and the
    real step on the card (``launches`` by kernel, ``model_collectives``,
    ``flop_counter_total``) disagree: each hand kernel's charges against
    its launches (a kernel on either side only counts too), the ``model``
    collectives the dry run saw and ``MODEL_COLLECTIVES`` counted, and the
    dry run's aten dot FLOPs against ``FlopCounterMode``'s total."""
    failures = []
    charged = {k: int(v["launches"]) for k, v in dry["kernels"].items()}
    launched = {k: n for k, n in real["launches"].items() if n}
    if charged != launched:
        failures.append(f"dryrun: charges {charged} but the step launched "
                        f"{launched}")
    for key in ("model_collectives", "model_collectives_counted"):
        if dry[key] != real["model_collectives"]:
            failures.append(f"dryrun: {key} {dry[key]} but the step issued "
                            f"{real['model_collectives']}")
    if dry["aten_dot_flops"] != real["flop_counter_total"]:
        failures.append(f"dryrun: {dry['aten_dot_flops']:.6g} aten dot FLOPs "
                        f"but FlopCounterMode counted "
                        f"{real['flop_counter_total']:.6g} over the step")
    return failures


def decode_count(mesh, device, kernels) -> dict:
    """granite-3-2b's ``decode_32k`` serve step at DRYRUN_DECODE (slots x
    S_max; bf16 serving weights, a zero cache at random lengths) on
    ``mesh``, as its dry run traces it: the kernels' launches and the
    ``model`` collectives of one step, the peak allocated in it
    (``max_memory_allocated``, with what was held before), and
    ``FlopCounterMode``'s total over a second step."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import get_bundle
    from repro_torch.distributed.sharding import place
    from repro_torch.distributed.tensor_parallel import MODEL_COLLECTIVES
    from repro_torch.tree import tree_map

    bundle = get_bundle("granite-3-2b")
    cfg = bundle.config
    B, S = DRYRUN_DECODE
    gen = torch.Generator(device=device).manual_seed(13)
    params = tree_map(place, bundle.init(gen, masters=False),
                      bundle.param_shardings(mesh))
    shard = bundle.input_sharding("decode_32k", mesh)["batch"]
    kv = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.d_head)
    batch = {
        "token": place(torch.randint(0, cfg.vocab, (B,), generator=gen,
                                     device=device, dtype=torch.int32),
                       shard["token"]),
        "cache": {
            "k": place(torch.zeros(kv, dtype=cfg.dtype, device=device),
                       shard["cache"]["k"]),
            "v": place(torch.zeros(kv, dtype=cfg.dtype, device=device),
                       shard["cache"]["v"]),
            "len": place(torch.randint(1, S, (B,), generator=gen,
                                       device=device, dtype=torch.int32),
                         shard["cache"]["len"])}}
    step = bundle.serve_step("decode_32k")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    for k in kernels:
        k.launches = 0
    MODEL_COLLECTIVES.reset()
    step(params, batch)
    torch.cuda.synchronize()
    out = {"launches": {k.symbol: k.launches for k in kernels},
           "model_collectives": MODEL_COLLECTIVES.count,
           "max_memory_allocated": torch.cuda.max_memory_allocated(device),
           "held_bytes": held}
    fc = FlopCounterMode(display=False)
    with fc:
        step(params, batch)
    out["flop_counter_total"] = float(fc.get_total_flops())
    del params, batch
    torch.cuda.empty_cache()
    return out


def dryrun_phase(device, kernels, smi: str,
                 runs: Sequence[Sequence[str]] = DRYRUN_CELLS) -> dict:
    """(b) granite-3-2b at its published widths, f32 masters,
    LM_TRAIN_BATCH x LM_TRAIN_SEQ in the bundle's 4 microbatches, on a
    one-rank NCCL mesh (``make_host_mesh``): its dry run at that exact
    shape (``--mesh host --lm-train``) is held to the real step by
    :func:`dryrun_failures`, on one step with the launch counters, one
    under ``FlopCounterMode``; the dry run's peak of live bytes is
    reported over ``torch.cuda.max_memory_allocated()`` of the counted
    step, and its roofline ``bound_s`` over the p50 of DRYRUN_TIMED steps
    (the step's share of its roofline), beside the card's name and power
    limit.  Then granite's ``decode_32k`` serve step at DRYRUN_DECODE on
    the same mesh (:func:`decode_count`) is held to its dry run at that
    shape (``--lm-serve``) the same way: the paged kernel once a layer,
    the flash kernels never, the ``model`` collectives, the aten dot
    FLOPs, and the dry run's peak over the step's
    ``max_memory_allocated``.  (a) The cells of ``runs``.  Both dry runs
    (:func:`start_dryrun_cells`) start once the timed steps are done, so
    that no timed work of the run shares the host with them; every cell
    must be ``ok``, and its line (ms of each roofline term, the dominant
    one, peak GB against 80) is logged."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import get_bundle
    from repro_torch.distributed.hooks import use_mesh
    from repro_torch.distributed.sharding import place
    from repro_torch.distributed.tensor_parallel import MODEL_COLLECTIVES
    from repro_torch.launch.train import synth_lm_batches
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    failures = free_check("dryrun", device)
    out: dict = {"smi": smi}
    bundle = get_bundle("granite-3-2b")
    cfg, mb = bundle.config, bundle.microbatches
    with tempfile.TemporaryDirectory() as tmp:
        dry_json = os.path.join(tmp, "granite.json")
        decode_json = os.path.join(tmp, "granite_decode.json")
        with one_rank_mesh() as mesh:
            params = bundle.init(torch.Generator(device=device).manual_seed(0))
            batch = {k: torch.as_tensor(v, device=device) for k, v in
                     synth_lm_batches(cfg.vocab, LM_TRAIN_BATCH,
                                      LM_TRAIN_SEQ)(0).items()}
            tc = TrainerConfig(opt=bundle.opt, microbatches=mb, log_every=1)
            placed = tree_map(place, params, bundle.param_shardings(mesh))
            del params
            trainer = Trainer(bundle.loss_fn(), placed, tc, device=device)
            del placed
            with use_mesh(mesh):
                one_step(trainer, batch, device)      # warm-up
                times = [one_step(trainer, batch, device)["s"]
                         for _ in range(DRYRUN_TIMED)]
                # the dry runs (this step's first) share the host with no
                # timed step
                procs = start_dryrun_cells([(
                    f"--arch granite-3-2b --shape train_4k --mesh host "
                    f"--lm-train {LM_TRAIN_BATCH},{LM_TRAIN_SEQ},{mb} "
                    f"--flop-counter --out {dry_json}",
                    f"--arch granite-3-2b --shape decode_32k --mesh host "
                    f"--lm-serve {DRYRUN_DECODE[0]},{DRYRUN_DECODE[1]} "
                    f"--flop-counter --out {decode_json}")] + list(runs))
                cells_t0 = time.perf_counter()
                for k in kernels:
                    k.launches = 0
                MODEL_COLLECTIVES.reset()
                counted = one_step(trainer, batch, device)
                launches = {k.symbol: k.launches for k in kernels}
                collectives = MODEL_COLLECTIVES.count
                fc = FlopCounterMode(display=False)
                with fc:
                    one_step(trainer, batch, device)
            del trainer, batch
            torch.cuda.empty_cache()
            with use_mesh(mesh):
                decode = decode_count(mesh, device, kernels)
        torch.cuda.empty_cache()
        texts = []
        for proc in procs:
            try:
                proc.wait(timeout=max(1.0, DRYRUN_CELLS_TIMEOUT
                                      - (time.perf_counter() - cells_t0)))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                failures.append(f"dryrun: a dry run had not ended in "
                                f"{DRYRUN_CELLS_TIMEOUT} s")
            proc.log_file.seek(0)
            texts.append(proc.log_file.read())
            proc.log_file.close()
        out["cells_s"] = time.perf_counter() - cells_t0
        dry = dry_decode = None
        if procs[0].returncode != 0:
            failures.append(f"dryrun: the granite dry runs exited "
                            f"{procs[0].returncode}: {texts[0][-2000:]}")
        else:
            with open(dry_json) as f:
                dry = json.load(f)
            with open(decode_json) as f:
                dry_decode = json.load(f)
    p50 = float(np.median(times))
    real = {"launches": launches, "model_collectives": collectives,
            "flop_counter_total": float(fc.get_total_flops()),
            "step_ms": [t * 1e3 for t in times], "p50_ms": p50 * 1e3,
            "max_memory_allocated": counted["peak_bytes"],
            "held_bytes": counted["held_bytes"]}
    out["real"] = real
    if dry is not None:
        failures += dryrun_failures(dry, real)
        terms = dry["roofline"]
        out["dry"] = {k: dry[k] for k in (
            "kernels", "model_collectives", "model_collectives_counted",
            "aten_dot_flops", "flops", "flops_by_dtype", "bytes_accessed",
            "memory", "roofline", "trace_s", "ops")}
        out["peak_ratio"] = dry["memory"]["peak_size"] / real[
            "max_memory_allocated"]
        out["roofline_share"] = terms["bound_s"] / p50
        log(f"dryrun granite {LM_TRAIN_BATCH}x{LM_TRAIN_SEQ}/{mb} on (1, 1): "
            f"charges {dry['kernels']} vs launches {launches}; model "
            f"collectives {dry['model_collectives']} vs {collectives}; aten "
            f"dot FLOPs {dry['aten_dot_flops']:.6g} vs FlopCounterMode "
            f"{real['flop_counter_total']:.6g}; peak "
            f"{dry['memory']['peak_size']:,} B vs max_memory_allocated "
            f"{real['max_memory_allocated']:,} B (ratio "
            f"{out['peak_ratio']:.4f}); roofline {terms['bound_s'] * 1e3:.1f}"
            f" ms ({terms['dominant']}) over the step's p50 "
            f"{p50 * 1e3:.1f} ms: share {out['roofline_share']:.4f} ({smi})")

    out["decode"] = {"real": decode}
    if dry_decode is not None:
        L = cfg.n_layers
        expect = {"paged_attention": L}
        launched = {k: n for k, n in decode["launches"].items() if n}
        failures += [f.replace("dryrun:", "dryrun decode:")
                     for f in dryrun_failures(dry_decode, decode)]
        if launched != expect:
            failures.append(f"dryrun decode: the step launched {launched}, "
                            f"{expect} expected")
        ratio = dry_decode["memory"]["peak_size"] / decode[
            "max_memory_allocated"]
        out["decode"].update({
            "shape": list(DRYRUN_DECODE), "peak_ratio": ratio,
            "dry": {k: dry_decode[k] for k in (
                "kernels", "model_collectives", "model_collectives_counted",
                "aten_dot_flops", "collectives", "memory", "roofline")}})
        log(f"dryrun granite decode {DRYRUN_DECODE[0]}x{DRYRUN_DECODE[1]} "
            f"on (1, 1): charges {dry_decode['kernels']} vs launches "
            f"{launched}; model collectives "
            f"{dry_decode['model_collectives']} vs "
            f"{decode['model_collectives']}; aten dot FLOPs "
            f"{dry_decode['aten_dot_flops']:.6g} vs FlopCounterMode "
            f"{decode['flop_counter_total']:.6g}; peak "
            f"{dry_decode['memory']['peak_size']:,} B vs "
            f"max_memory_allocated {decode['max_memory_allocated']:,} B "
            f"(ratio {ratio:.4f}) ({smi})")

    # (a) the cells
    out["cells"] = []
    for proc, text in zip(procs[1:], texts[1:]):
        lines = [ln for ln in text.splitlines() if ln.startswith("[ok]")
                 or ln.startswith("FAIL") or " ok, " in ln]
        for ln in lines:
            log(f"dryrun cell {ln}")
        out["cells"] += lines
        if proc.returncode != 0 or any(ln.startswith("FAIL")
                                       for ln in lines):
            failures.append(f"dryrun: the cells' dry run exited "
                            f"{proc.returncode}: {text[-2000:]}")
    out["failures"] = failures
    out["seconds"] = time.perf_counter() - t0
    return out


def path_attention_phase(paths: Dict[str, dict], device) -> Dict[str, dict]:
    """The attention kernels against their plain versions at the largest
    shapes the MoE serving and LM training paths gave them (bf16): the
    wgmma flash kernel on Moonshot's and Qwen3's prefill and on the
    training microbatch's (B, S, H, D) views, the paged kernel on both
    MoE decode steps."""
    from repro_torch.kernels.flash_attention.kernel import FLASH_ATTENTION_WGMMA

    gen = torch.Generator(device=device).manual_seed(8)
    rng = np.random.RandomState(10)
    out: Dict[str, dict] = {"flash_attention_wgmma": {}, "paged_attention": {}}
    for path, rep in paths.items():
        shape = rep["largest"].get("flash_attention_wgmma")
        if shape:
            q, k, v = flash_inputs(*shape, torch.bfloat16, gen, device,
                                   views=path == "lm_train")
            out["flash_attention_wgmma"][f"{path}_bf16"] = flash_case(
                q, k, v, True, FLASH_ATTENTION_WGMMA)
            del q, k, v
        shape = rep["largest"].get("paged_attention")
        if shape:
            R, G, max_pages, page, D = shape
            n_kv = R // rep["slots"]
            lens = rng.randint(MOE_PROMPT[0], MOE_PROMPT[1] + rep["new_tokens"]
                               + 1, rep["slots"]).repeat(n_kv)
            out["paged_attention"][f"{path}_bf16"] = paged_case(
                R, G, D, page, max_pages, lens, torch.bfloat16, gen, device,
                shuffled=False)
    return out


# ------------------------------------------------------------ gnn train --
def gnn_edges(n: int, e: int, seed: int) -> tuple:
    """``e`` edges (src, dst; int32) over ``n`` nodes: a
    ``synthetic_graph`` at a mean degree just past e / n, cut to its
    first ``e`` edges (node u's in-edges are its CSR row)."""
    from repro_torch.models.gnn_common import synthetic_graph

    g = synthetic_graph(n, -(-e // n) + 1, seed)
    if g.n_edges < e:
        raise RuntimeError(f"synthetic graph of {g.n_edges} edges, {e} asked")
    dst = np.repeat(np.arange(n, dtype=np.int32), np.diff(g.indptr))[:e]
    return g.indices[:e].astype(np.int32), dst


def gnn_node_batch(cfg, n: int, e: int, seed: int, device) -> dict:
    """A node-classification batch of the cell's shapes: ``gnn_edges``,
    features and positions N(0, 1) and labels uniform in ``cfg.n_out``,
    drawn on ``device`` from ``seed``."""
    src, dst = gnn_edges(n, e, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    return {
        "feat": torch.randn((n, cfg.d_feat), generator=gen, device=device),
        "pos": torch.randn((n, 3), generator=gen, device=device),
        "edges_src": torch.from_numpy(src).to(device),
        "edges_dst": torch.from_numpy(dst).to(device),
        "labels": torch.randint(0, cfg.n_out, (n,), generator=gen,
                                device=device, dtype=torch.int32),
    }


def gnn_mol_batch(cfg, sizes: tuple, seed: int, device) -> dict:
    """The molecule cell's batch: ``batch_small_graphs`` of (graphs,
    nodes, edges a graph), species and energies from ``RandomState(seed)``,
    positions N(0, 1) drawn on ``device``."""
    from repro_torch.models.gnn_common import batch_small_graphs

    n_g, n_n, n_e = sizes
    b = batch_small_graphs(n_g, n_n, n_e, seed)
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    return {
        "species": torch.from_numpy(rng.randint(
            0, cfg.n_species, n_g * n_n).astype(np.int32)).to(device),
        "pos": torch.randn((n_g * n_n, 3), generator=gen, device=device),
        "edges_src": torch.from_numpy(b["edges_src"]).to(device),
        "edges_dst": torch.from_numpy(b["edges_dst"]).to(device),
        "graph_of": torch.from_numpy(b["graph_of"]).to(device),
        "energy": torch.from_numpy(
            rng.randn(n_g).astype(np.float32)).to(device),
    }


class GNNSampled:
    """The sampled cell's data: a ``synthetic_graph`` of ``n`` nodes at
    mean degree ``degree`` on the host, a ``NeighborSampler`` over it,
    and feature, position and label tables drawn on ``device``.  A data
    cursor's batch samples ``n_seeds`` fresh seeds with
    ``RandomState(seed + cursor)`` (host seconds kept in ``host_s``) and
    gathers the subgraph's rows on the device; the labels count on the
    seeds only (``label_mask``), padded edges are masked."""

    def __init__(self, cfg, n: int, degree: int, n_seeds: int, fanout,
                 seed: int, device):
        from repro_torch.models.gnn_common import (
            NeighborSampler,
            synthetic_graph,
        )

        graph = synthetic_graph(n, degree, seed)
        self.n_edges = graph.n_edges
        self.sampler = NeighborSampler(graph, fanout)
        self.n, self.n_seeds, self.seed, self.device = n, n_seeds, seed, device
        gen = torch.Generator(device=device).manual_seed(seed)
        self.feat = torch.randn((n, cfg.d_feat), generator=gen, device=device)
        self.pos = torch.randn((n, 3), generator=gen, device=device)
        self.labels = torch.randint(0, cfg.n_out, (n,), generator=gen,
                                    device=device, dtype=torch.int32)
        self.host_s: List[float] = []

    def __call__(self, cursor: int) -> dict:
        t0 = time.perf_counter()
        rng = np.random.RandomState(self.seed + cursor)
        seeds = rng.choice(self.n, self.n_seeds, replace=False)
        sub = self.sampler.sample(seeds, rng)
        self.host_s.append(time.perf_counter() - t0)
        dev = self.device
        nodes = torch.from_numpy(sub["nodes"]).to(dev)
        label_mask = torch.zeros(nodes.shape[0], device=dev)
        label_mask[: sub["n_seeds"]] = 1.0
        return {
            "feat": self.feat.index_select(0, nodes),
            "pos": self.pos.index_select(0, nodes),
            "edges_src": torch.from_numpy(sub["edges_src"]).to(dev),
            "edges_dst": torch.from_numpy(sub["edges_dst"]).to(dev),
            "labels": self.labels.index_select(0, nodes),
            "edge_mask": torch.from_numpy(sub["edge_mask"]).to(dev),
            "label_mask": label_mask,
        }


def gnn_invariance(spec, batch: dict, seed: int, device) -> float:
    """The largest change of the outputs under a rotation and translation
    of the positions, relative to their largest magnitude (the rotation
    of ``tests/test_models.py``'s MACE check)."""
    from repro_torch.models.mace import mace_forward

    th = 0.9
    c, s = np.cos(th), np.sin(th)
    R = torch.tensor(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
                     @ np.array([[1, 0, 0], [0, 0.6, -0.8], [0, 0.8, 0.6]]),
                     dtype=torch.float32, device=device)
    params = spec.init(torch.Generator(device=device).manual_seed(seed))
    feat = batch["feat"] if spec.config.d_feat else batch["species"]
    pos, src, dst = batch["pos"], batch["edges_src"], batch["edges_dst"]
    mask = batch.get("edge_mask")
    with torch.no_grad():
        o1 = mace_forward(spec.config, params, feat, pos, src, dst, mask)
        o2 = mace_forward(spec.config, params, feat, pos @ R.T + 2.5, src,
                          dst, mask)
    return float((o1 - o2).abs().max() / o1.abs().max())


def gnn_grad_parity(spec, batch_cpu: dict, seed: int, device) -> dict:
    """One loss and gradient, the same CPU-drawn parameters and batch on
    the card and on the CPU: the loss's relative difference and each
    leaf's relative L2 difference."""
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.tree import flatten_with_path, path_name

    params = spec.init(torch.Generator().manual_seed(seed))
    loss_fn = spec.loss_fn()
    cl, cg = value_and_grad(loss_fn, params, batch_cpu)
    gl, gg = value_and_grad(loss_fn, tree_to(params, device),
                            tree_to(batch_cpu, device))
    rel = {path_name(p): float((g.cpu() - c).norm() / c.norm())
           for (p, g), (_, c) in zip(flatten_with_path(gg),
                                     flatten_with_path(cg))}
    return {"loss": [float(gl), float(cl)],
            "loss_rel_err": abs(float(gl) - float(cl)) / abs(float(cl)),
            "max_grad_rel_l2": max(rel.values()),
            "worst_leaf": max(rel, key=rel.get), "grad_rel_l2": rel}


def gnn_reduced_checks(seed: int, device) -> dict:
    """The four cells at REDUCED from the same CPU-drawn parameters and
    batches: GNN_PARITY_STEPS ``Trainer`` steps with the bundle's AdamW on
    the card and on the CPU; losses within TRAIN_LOSS_RTOL relative,
    parameters and optimizer state within TRAIN_PARAM_TOL."""
    from repro_torch.configs.registry import get_bundle
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    b = get_bundle("mace", reduced=True)
    out: Dict[str, dict] = {}
    failures: List[str] = []
    for cell, spec in b.cell_specs.items():
        cfg = spec.config
        if cell == "molecule":
            data = [gnn_mol_batch(cfg, b.sizes["mol"], seed + c, "cpu")
                    for c in range(GNN_PARITY_STEPS)]
        elif cell == "minibatch_lg":
            n_seeds, fanout = b.sizes["mb_seeds"]
            src = GNNSampled(cfg, 500, 8, n_seeds, fanout, seed, "cpu")
            data = [src(c) for c in range(GNN_PARITY_STEPS)]
        else:
            n, e = b.sizes["cora" if cell == "full_graph_sm" else "products"]
            data = [gnn_node_batch(cfg, n, e, seed + c, "cpu")
                    for c in range(GNN_PARITY_STEPS)]
        params = spec.init(torch.Generator().manual_seed(seed))
        runs = []
        for where in (device, "cpu"):
            tr = Trainer(spec.loss_fn(), params, TrainerConfig(
                opt=spec.opt, log_every=1), device=where)
            tr.fit(data.__getitem__, GNN_PARITY_STEPS)
            runs.append(tr)
        a, c = runs
        loss_err = max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
                       for x, y in zip(a.history, c.history))
        state_err = max(
            float((x.cpu() - y).abs().max()) for x, y in
            zip(leaves(a.params) + leaves(a.opt_state["mu"])
                + leaves(a.opt_state["nu"]),
                leaves(c.params) + leaves(c.opt_state["mu"])
                + leaves(c.opt_state["nu"])))
        if not loss_err <= TRAIN_LOSS_RTOL:
            failures.append(f"gnn train {cell} REDUCED: losses differ by "
                            f"{loss_err:.3g} relative")
        if not state_err <= TRAIN_PARAM_TOL:
            failures.append(f"gnn train {cell} REDUCED: parameters or "
                            f"optimizer state differ by {state_err:.3g}")
        out[cell] = {"steps": GNN_PARITY_STEPS, "max_loss_rel_err": loss_err,
                     "max_state_abs_err": state_err,
                     "losses": [h["loss"] for h in a.history]}
    out["failures"] = failures
    return out


def gnn_cell(name: str, spec, batches: Callable[[int], dict], seed: int,
             device) -> dict:
    """Train one cell through ``Trainer`` with the bundle's AdamW from
    parameters drawn on the card: GNN_WARMUP warm-up and GNN_TIMED timed
    steps (every loss finite, every parameter leaf moved), peak memory,
    one profiled step."""
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import flatten_with_path, path_name

    torch.cuda.reset_peak_memory_stats(device)
    params = spec.init(torch.Generator(device=device).manual_seed(seed))
    start = {path_name(p): t.clone() for p, t in flatten_with_path(params)}
    trainer = Trainer(spec.loss_fn(), params, TrainerConfig(
        opt=spec.opt, log_every=1), device=device)
    del params
    for _ in range(GNN_WARMUP):
        trainer.fit(batches, trainer.step_num + 1)
    step_s = []
    for _ in range(GNN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(batches, trainer.step_num + 1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device)
    losses = [h["loss"] for h in trainer.history]
    still = [path_name(p) for p, t in flatten_with_path(trainer.params)
             if torch.equal(t, start[path_name(p)])]
    failures = []
    if not all(np.isfinite(losses)) or len(losses) != GNN_WARMUP + GNN_TIMED:
        failures.append(f"gnn train {name}: losses {losses}")
    if still:
        failures.append(f"gnn train {name}: parameters did not move: {still}")
    profile = profile_train_step(
        trainer, batches,
        ranges={"adamw_update": (trainer_mod, "adamw_update")},
        forward=("index_add", "indexFunc"))
    log(f"gnn train {name}: step p50 {np.percentile(step_s, 50) * 1e3:.1f} "
        f"ms, peak {peak:,} B, losses {[round(x, 4) for x in losses]}")
    return {"step": percentiles_ms(step_s), "losses": losses,
            "peak_mem_bytes": peak, "profile": profile, "failures": failures}


def gnn_train_phase(device, hand_kernels, seed: int = 0) -> dict:
    """MACE at ``CONFIG``'s widths through ``get_bundle("mace")``'s four
    cells on the card (``Trainer``, the bundle's AdamW): Cora's published
    size, the sampled cell on the Reddit graph (1,024 fresh seeds a step,
    fanout [15, 10], features on the card), ogbn-products at its published
    size, the batched molecules; then E(3) invariance and card against
    CPU at full width on Cora and molecule, and the REDUCED cells card
    against CPU.  The GNN path reaches no hand kernel but the optimizer's
    fused AdamW (:func:`gnn_hand_kernel_failures`), and TF32 must be
    off."""
    from repro_torch.configs.registry import get_bundle

    t0 = time.perf_counter()
    failures = free_check("gnn train", device)
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}
    log(f"gnn train: TF32 {tf32}")
    if (tf32["matmul"] or tf32["cudnn"]
            or tf32["float32_matmul_precision"] != "highest"):
        failures.append(f"gnn train: TF32 is on ({tf32})")
    before = {k.symbol: k.launches for k in hand_kernels}
    bundle = get_bundle("mace")
    specs, sizes = bundle.cell_specs, bundle.sizes
    cells: Dict[str, dict] = {}

    spec = specs["full_graph_sm"]
    n, e = sizes["cora"]
    cora = gnn_node_batch(spec.config, n, e, seed, device)
    cells["full_graph_sm"] = {"nodes": n, "edges": e, **gnn_cell(
        "full_graph_sm", spec, lambda c: cora, seed, device)}
    del cora

    spec = specs["minibatch_lg"]
    n_seeds, fanout = sizes["mb_seeds"]
    t1 = time.perf_counter()
    sampled = GNNSampled(spec.config, REDDIT_NODES, REDDIT_DEGREE, n_seeds,
                         fanout, seed, device)
    setup_s = time.perf_counter() - t1
    n_max, e_max = spec.inputs["labels"][0][0], spec.inputs["edge_mask"][0][0]
    rep = gnn_cell("minibatch_lg", spec, sampled, seed, device)
    cells["minibatch_lg"] = {
        "graph_nodes": REDDIT_NODES, "graph_edges": sampled.n_edges,
        "feature_table_bytes": sampled.feat.numel() * 4, "seeds": n_seeds,
        "fanout": list(fanout), "nodes": n_max, "edges": e_max,
        "graph_setup_s": setup_s,
        "sampler": percentiles_ms(sampled.host_s), **rep}
    del sampled

    spec = specs["ogb_products"]
    n, e = sizes["products"]
    t1 = time.perf_counter()
    products = gnn_node_batch(spec.config, n, e, seed, device)
    setup_s = time.perf_counter() - t1
    cells["ogb_products"] = {"nodes": n, "edges": e, "mean_degree": e / n,
                             "edge_chunks": -(-e // spec.config.edge_chunk),
                             "graph_setup_s": setup_s, **gnn_cell(
                                 "ogb_products", spec, lambda c: products,
                                 seed, device)}
    del products

    spec = specs["molecule"]
    mol = gnn_mol_batch(spec.config, sizes["mol"], seed, device)
    cells["molecule"] = {"graphs": sizes["mol"][0],
                         "nodes": sizes["mol"][0] * sizes["mol"][1],
                         "edges": sizes["mol"][0] * sizes["mol"][2],
                         **gnn_cell("molecule", spec, lambda c: mol, seed,
                                    device)}
    del mol
    for name, rep in cells.items():
        failures += rep.pop("failures")
        per_step = rep["step"]["p50_ms"] / 1e3
        if name == "molecule":
            rep["graphs_per_s"] = rep["graphs"] / per_step
        rep["nodes_per_s"] = rep["nodes"] / per_step

    # checks at full width: invariance, and card against CPU
    checks: Dict[str, dict] = {}
    for name in ("full_graph_sm", "molecule"):
        spec = specs[name]
        if name == "molecule":
            batch = gnn_mol_batch(spec.config, sizes["mol"], seed, "cpu")
        else:
            batch = gnn_node_batch(spec.config, *sizes["cora"], seed, "cpu")
        inv = gnn_invariance(spec, tree_to(batch, device), seed, device)
        par = gnn_grad_parity(spec, batch, seed, device)
        checks[name] = {"invariance_rel_err": inv, **par}
        if not inv <= GNN_INVARIANCE_TOL:
            failures.append(f"gnn train {name}: outputs move by {inv:.3g} "
                            "of their size under a rotation")
        if not par["loss_rel_err"] <= GNN_LOSS_RTOL:
            failures.append(f"gnn train {name}: card and CPU losses differ by "
                            f"{par['loss_rel_err']:.3g} relative")
        if not par["max_grad_rel_l2"] <= GNN_GRAD_REL_L2:
            failures.append(f"gnn train {name}: gradient {par['worst_leaf']} "
                            f"differs by {par['max_grad_rel_l2']:.3g} "
                            "relative L2, card against CPU")
    reduced = gnn_reduced_checks(seed, device)
    failures += reduced.pop("failures")
    launched = {k.symbol: k.launches - before[k.symbol]
                for k in hand_kernels}
    failures += gnn_hand_kernel_failures("gnn train", launched)
    return {"config": dataclasses.asdict(bundle.config) | {"dtype": "float32"},
            "seed": seed, "tf32": tf32, "cells": cells, "checks": checks,
            "reduced_checks": reduced, "hand_kernel_launches": launched,
            "seconds": time.perf_counter() - t0, "failures": failures}


def gnn_hand_kernel_failures(label: str, launched: Dict[str, int]
                             ) -> List[str]:
    """The GNN path's hand-kernel launches (``launched``, by kernel, over
    a phase): the optimizer's fused AdamW launches on every step on the
    card, and no other hand kernel does."""
    others = {k: n for k, n in launched.items() if k != "adamw" and n}
    if others or not launched.get("adamw"):
        return [f"{label}: hand kernels launched on the GNN path {launched}, "
                "only adamw expected"]
    return []


def graph_route_count(n_layers: int, node_axes: int, edge_axes: int,
                      energies: bool) -> int:
    """The collectives ``graph_parallel``'s route issues in one MACE train
    step whose nodes are split over ``node_axes`` mesh axes and edges
    over ``edge_axes``: the positions gathered once (one a node axis);
    in each layer's forward and again in its recompute, the states
    gathered (one a node axis) and the messages summed into their
    owners (one an edge axis), and in its backward both transposed; a
    molecule's energies summed over the node axes and back."""
    count = node_axes + 3 * n_layers * (node_axes + edge_axes)
    return count + (2 * node_axes if energies else 0)


def split_axes(mesh, rows: int) -> int:
    """The batch axes ``shard_batch`` splits ``rows`` rows over: all of
    them where their product divides the rows, else none."""
    from repro_torch.distributed.sharding import BATCH, axis_sizes

    sizes = axis_sizes(mesh)
    axes = [n for n in BATCH if n in sizes]
    return len(axes) if rows % int(np.prod([sizes[n] for n in axes])) == 0 \
        else 0


def mesh_gnn_step(name: str, spec, batch: dict, mesh, device,
                  failures: List[str]) -> dict:
    """One ``Trainer`` step of the cell ``spec`` with the bundle's AdamW,
    without a mesh and then on ``mesh`` from the same params and batch
    (the trainer places the batch over the batch axes; each rank
    computes its node rows and edge block): the loss and every param bit
    for bit, ``GRAPH_COLLECTIVES`` equal to :func:`graph_route_count`,
    the step's peak at most MESH_PEAK_RATIO of the unsharded step's.  A
    step of each route from the same params is taken first and thrown
    away, so both timed steps run warm."""
    from repro_torch.distributed.graph_parallel import GRAPH_COLLECTIVES
    from repro_torch.distributed.sharding import (
        GNN_RULES,
        is_sharded,
        place,
        shard_by_rules,
    )
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import flatten_with_path, leaves, path_name, tree_map

    cfg = spec.config
    expect = graph_route_count(
        cfg.n_layers, split_axes(mesh, batch["pos"].shape[0]),
        split_axes(mesh, batch["edges_src"].shape[0]), "energy" in batch)
    log(f"mesh gnn {name}: {expect} graph collectives expected a step")
    params = spec.init(torch.Generator(device=device).manual_seed(0))
    placed = tree_map(place, params, shard_by_rules(params, mesh, GNN_RULES))
    tc = TrainerConfig(opt=spec.opt, log_every=1)
    for warm in (params, placed):     # each trainer copies its params
        one_step(Trainer(spec.loss_fn(), warm, tc, device=device), batch,
                 device)
    plain_tr = Trainer(spec.loss_fn(), params, tc, device=device)
    plain = one_step(plain_tr, batch, device)
    plain_params = leaves(plain_tr.params)
    del plain_tr
    mesh_tr = Trainer(spec.loss_fn(), placed, tc, device=device)
    del placed, params
    GRAPH_COLLECTIVES.reset()
    sharded = one_step(mesh_tr, batch, device)
    count = GRAPH_COLLECTIVES.count
    differ = [path_name(p) for (p, a), b in zip(
        flatten_with_path(mesh_tr.params), plain_params)
        if not (is_sharded(a) and torch.equal(a.to_local(), b))]
    same_loss = sharded["loss"] == plain["loss"]
    ratio = sharded["step_peak_bytes"] / plain["step_peak_bytes"]
    log(f"mesh gnn {name}: unsharded step {plain['s'] * 1e3:.1f} ms, mesh "
        f"step {sharded['s'] * 1e3:.1f} ms, loss {sharded['loss']:.6f} vs "
        f"{plain['loss']:.6f}, {len(differ)} params differ, step peak "
        f"ratio {ratio:.4f}, {count} graph collectives ({expect} expected)")
    if not same_loss or differ:
        failures.append(
            f"mesh gnn {name}: the one-rank mesh step differs from the "
            f"unsharded one: loss {sharded['loss']!r} vs {plain['loss']!r}, "
            f"{len(differ)} params differ ({differ[:3]})")
    if count != expect:
        failures.append(f"mesh gnn {name}: {count} graph collectives, "
                        f"{expect} expected")
    if ratio > MESH_PEAK_RATIO:
        failures.append(f"mesh gnn {name}: the mesh step's peak is "
                        f"{ratio:.4f} of the unsharded step's (at most "
                        f"{MESH_PEAK_RATIO})")
    del mesh_tr, plain_params
    return {"nodes": int(batch["pos"].shape[0]),
            "edges": int(batch["edges_src"].shape[0]),
            "unsharded": plain, "sharded": sharded,
            "loss_bit_identical": same_loss, "params_differing": differ[:10],
            "n_params_differing": len(differ), "step_peak_ratio": ratio,
            "graph_collectives": count,
            "expected_graph_collectives": expect}


def mesh_gnn_phase(device, hand_kernels, seed: int = 0) -> dict:
    """MESH_GNN's cells of ``get_bundle("mace")`` at their published
    widths (Cora's 2,708 nodes, 10,556 edges and 1,433 features; 128
    molecules), each through :func:`mesh_gnn_step` on a one-rank NCCL
    mesh (``one_rank_mesh``) under :func:`deterministic_algorithms`:
    the edge blocks' ``index_add_`` sums take CUDA atomics in an order
    that changes from run to run without it.  No hand kernel but the
    optimizer's may launch (:func:`gnn_hand_kernel_failures`)."""
    from repro_torch.configs.registry import get_bundle

    t0 = time.perf_counter()
    failures = free_check("mesh gnn", device)
    before = {k.symbol: k.launches for k in hand_kernels}
    bundle = get_bundle("mace")
    cells: Dict[str, dict] = {}
    with one_rank_mesh() as mesh, deterministic_algorithms():
        for name in MESH_GNN:
            spec = bundle.cell_specs[name]
            batch = (gnn_mol_batch(spec.config, bundle.sizes["mol"], seed,
                                   device) if name == "molecule" else
                     gnn_node_batch(spec.config, *bundle.sizes["cora"],
                                    seed, device))
            cells[name] = mesh_gnn_step(name, spec, batch, mesh, device,
                                        failures)
            del batch
    launched = {k.symbol: k.launches - before[k.symbol]
                for k in hand_kernels}
    failures += gnn_hand_kernel_failures("mesh gnn", launched)
    torch.cuda.empty_cache()
    return {"cells": cells, "hand_kernel_launches": launched,
            "seconds": time.perf_counter() - t0, "failures": failures}


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
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the gnn train phase's synthetic data")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
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

    # float32 products in full float32 on the card (stated, not assumed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    kernels = (VARINT_DECODE, SORTED_MEMBER_MASK)
    serve_kernels = (FLASH_ATTENTION_WGMMA, FLASH_ATTENTION, PAGED_ATTENTION)
    backward_kernels = (FLASH_ATTENTION_BACKWARD_WGMMA,
                        FLASH_ATTENTION_BACKWARD)
    train_kernels = serve_kernels + backward_kernels
    # what the training phases reset and count: the optimizer's kernel too
    step_kernels = train_kernels + (ADAMW,)
    # the case each serve kernel's row of the kernels line shows: the
    # f32-route flash kernel serves f32 (the parity phase), the others bf16
    row_dtype = {FLASH_ATTENTION_WGMMA.symbol: "bf16",
                 FLASH_ATTENTION.symbol: "f32",
                 PAGED_ATTENTION.symbol: "bf16"}
    t0 = time.perf_counter()
    lib = cuda_lib.build(verbose=True)
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    search = search_phase(args.scale, device, kernels)
    log(f"search: {search['seconds']:.1f} s, launches {search['launches']}")
    world, std_q = search.pop("world"), search.pop("queries")
    replica = replica_phase(world, std_q, device, kernels)
    del world
    log("search replica: " + json.dumps(
        {k: v for k, v in replica.items() if k != "profile"}))
    log("profile search replica: " + json.dumps(replica["profile"]))
    checks = kernel_phase(search, device)
    failures = list(search["failures"]) + replica["failures"]
    for name, cases in checks.items():
        for where, case in cases.items():
            log(f"kernel {name} {where}: " + json.dumps(case))
            if not case["bit_identical"]:
                failures.append(f"{name} disagrees with its plain version "
                                f"at {where} shape {case['shape']}")

    t0 = time.perf_counter()
    serve = serve_phase(device, serve_kernels)
    log("serve: " + json.dumps({k: v for k, v in serve.items()
                                if not k.endswith("profile")}))
    log("serve profile: " + json.dumps(serve["profile"]))
    log("prefill profile: " + json.dumps(serve["prefill_profile"]))
    failures += serve["failures"]
    torch.cuda.empty_cache()
    parity = parity_phase(device, serve_kernels)
    log("serve parity: " + json.dumps(parity))
    failures += parity["failures"]
    attn = attention_phase(serve["largest"], device)
    for name, cases in attn.items():
        for where, case in cases.items():
            log(f"kernel {name} {where}: " + json.dumps(case))
            if not case["within_tolerance"]:
                failures.append(f"{name} disagrees with its plain version "
                                f"at {where} shape {case['shape']}: error "
                                f"{case['max_err_ratio']:.3g} times its limit")
    log(f"serve phases: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    recsys, dlrm_params = recsys_serve_phase(device, EMBEDDING_BAG)
    log("recsys serve: " + json.dumps({k: v for k, v in recsys.items()
                                       if k != "profile"}))
    log("recsys profile: " + json.dumps(recsys["profile"]))
    failures += recsys["failures"]
    rparity = recsys_parity_phase(device)
    log("recsys parity: " + json.dumps(rparity))
    failures += rparity["failures"]
    bags = bag_phase(dlrm_params, device)
    drawn = {"dlrm-mlperf": dlrm_params}
    del dlrm_params
    for where, case in bags.items():
        log(f"kernel embedding_bag {where}: " + json.dumps(case))
    failures += bag_failures(bags)
    mserve = mesh_recsys_serve_phase(device, EMBEDDING_BAG, drawn)
    log("mesh recsys serve: " + json.dumps(mserve))
    failures += mserve["failures"]
    log(f"recsys phases: {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    train = recsys_train_phase(device, EMBEDDING_BAG, ADAMW)
    log("recsys train: " + json.dumps(
        {k: v for k, v in train.items() if k not in ("profile", "grad_check")}))
    log("recsys train profile: " + json.dumps(train["profile"]))
    log("recsys train gradients: " + json.dumps({
        "loss": train["grad_check"]["loss"],
        **{f"{route}_max_err_ratio": max(
            t[route]["max_err_ratio"] for t in train["grad_check"]["tables"].values())
           for route in ("kernel", "plain")},
        "max_abs_diff": max(t["max_abs_diff"]
                            for t in train["grad_check"]["tables"].values())}))
    failures += train["failures"]
    log(f"recsys train phase: {train['seconds']:.1f} s")
    adamw = adamw_phase(device, ADAMW)
    for where, case in adamw["cases"].items():
        log(f"kernel adamw {where}: " + json.dumps(case))
    failures += adamw["failures"]
    log(f"adamw phase: {adamw['seconds']:.1f} s")

    t0 = time.perf_counter()
    moe = moe_serve_phase(device, serve_kernels)
    log("moe serve: " + json.dumps({k: v for k, v in moe.items()
                                    if k != "profile"}))
    log("moe serve profile: " + json.dumps(moe["profile"]))
    failures += moe["failures"]
    qwen3 = moe_qwen3_phase(device, serve_kernels)
    log("moe serve qwen3: " + json.dumps({k: v for k, v in qwen3.items()
                                          if k != "profile"}))
    log("moe serve qwen3 profile: " + json.dumps(qwen3["profile"]))
    failures += qwen3["failures"]
    torch.cuda.empty_cache()
    mparity = moe_parity_phase(device, serve_kernels)
    log("moe parity: " + json.dumps(mparity))
    failures += mparity["failures"]
    log(f"moe phases: {time.perf_counter() - t0:.1f} s")

    lm = lm_train_phase(device, step_kernels)
    log("lm train: " + json.dumps({k: v for k, v in lm.items()
                                   if k not in ("profile", "grad_check")}))
    log("lm train profile: " + json.dumps(lm["profile"]))
    log("lm train gradients: " + json.dumps(
        {k: v for k, v in lm["grad_check"].items() if k != "rel_l2"}))
    failures += lm["failures"]
    log(f"lm train phase: {lm['seconds']:.1f} s")
    mesh = mesh_phase(device, step_kernels, EMBEDDING_BAG)
    log("mesh: " + json.dumps(mesh))
    failures += mesh["failures"]
    log(f"mesh phase: {mesh['seconds']:.1f} s")
    paths = {"moe_serve": moe, "moe_serve_qwen3": qwen3, "lm_train": lm}
    path_attn = path_attention_phase(paths, device)
    for name, cases in path_attn.items():
        for where, case in cases.items():
            log(f"kernel {name} {where}: " + json.dumps(case))
            if not case["within_tolerance"]:
                failures.append(f"{name} disagrees with its plain version "
                                f"at {where} shape {case['shape']}: error "
                                f"{case['max_err_ratio']:.3g} times its limit")
            attn[name][where] = case

    gnn = gnn_train_phase(device, kernels + step_kernels + (EMBEDDING_BAG,),
                          args.seed)
    for name, cell in gnn["cells"].items():
        log(f"gnn train {name}: " + json.dumps(
            {k: v for k, v in cell.items() if k != "profile"}))
        log(f"gnn train {name} profile: " + json.dumps(cell["profile"]))
    log("gnn train checks: " + json.dumps(
        {k: v for k, v in gnn.items() if k not in ("cells", "config")}))
    failures += gnn["failures"]
    log(f"gnn train phase: {gnn['seconds']:.1f} s")
    mgnn = mesh_gnn_phase(device, kernels + step_kernels + (EMBEDDING_BAG,),
                          args.seed)
    log("mesh gnn: " + json.dumps(mgnn))
    failures += mgnn["failures"]
    log(f"mesh gnn phase: {mgnn['seconds']:.1f} s")

    dry = dryrun_phase(device, step_kernels + kernels + (EMBEDDING_BAG,),
                       smi)
    log("dryrun: " + json.dumps({k: v for k, v in dry.items()
                                 if k not in ("cells", "dry")}))
    failures += dry["failures"]
    log(f"dryrun phase: {dry['seconds']:.1f} s (the cells "
        f"{dry['cells_s']:.1f} s of it)")

    # each attention kernel's launches by path: bf16 serving (granite,
    # Moonshot, Qwen3), the f32 parity engines (the f32-route flash kernel's
    # path), LM training (forward and remat recompute; the backward) and
    # its REDUCED f32 steps (the f32 routes' training path); the mesh
    # phase's granite and moonshot steps
    launch_paths = {"serve": serve, "parity": parity, "moe_serve": moe,
                    "moe_serve_qwen3": qwen3, "moe_parity": mparity,
                    "lm_train": lm, "lm_reduced": lm["reduced_checks"],
                    "mesh": mesh, "mesh_moe": mesh["moe"],
                    "mesh_serve": mesh["serve"],
                    "mesh_serve_moe": mesh["serve_moe"]}
    by_path = {k.symbol: {path: rep["launches"].get(k.symbol, 0)
                          for path, rep in launch_paths.items()}
               for k in train_kernels}
    # AdamW's launches on each training path, each counted from 0 by its
    # phase; every one of them must have launched it
    adamw_by_path = {
        "recsys_train": train["adamw_launches"],
        **{path: launch_paths[path]["launches"][ADAMW.symbol]
           for path in ("lm_train", "lm_reduced", "mesh", "mesh_moe")},
        "gnn_train": gnn["hand_kernel_launches"][ADAMW.symbol],
        "mesh_gnn": mgnn["hand_kernel_launches"][ADAMW.symbol]}
    if not all(adamw_by_path.values()):
        failures.append(f"adamw: a training path launched it 0 times "
                        f"({adamw_by_path})")
    # the backward rows show the lm train microbatch (tensor cores) and
    # REDUCED Moonshot's width in f32 (split-TF32)
    backward_row = {FLASH_ATTENTION_BACKWARD_WGMMA.symbol: "lm_train_bf16",
                    FLASH_ATTENTION_BACKWARD.symbol: "d16_f32"}
    # the cases run twice for bit identity and profiled by kernel
    repeat_row = {FLASH_ATTENTION_BACKWARD_WGMMA.symbol: "lm_train_bf16",
                  FLASH_ATTENTION_BACKWARD.symbol: "d64_f32"}
    # the paged kernel's log-sum-exp route: its launches (every paged
    # launch of the mesh's serve steps) and the serve case's numbers
    lse_serve = attn[PAGED_ATTENTION.symbol][
        f"serve_{row_dtype[PAGED_ATTENTION.symbol]}"]["lse"]
    lse_row = {"launches": mesh["serve"]["lse_route_calls"]
               + mesh["serve_moe"]["lse_route_calls"],
               **{key: lse_serve[key] for key in (
                   "max_abs_err", "sentinel_exact", "output_bit_identical",
                   "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms")}}
    # the search path's own launch: a decoded chunk, a join round
    # DLRM's mesh step, through the row-sharded route
    mesh_bags = mesh["recsys"]["dlrm-mlperf"]["sharded"]["bag_launches"]
    search_case = {VARINT_DECODE.symbol: "search",
                   SORTED_MEMBER_MASK.symbol: "round"}
    line = {"kernels": [
        {
            "name": k.symbol,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": (search["launches"][k.symbol]
                         + replica["launches"][k.symbol]),
            "launches_by_path": {"search": search["launches"][k.symbol],
                                 "search_replica":
                                     replica["launches"][k.symbol]},
            **{key: checks[k.symbol][search_case[k.symbol]][key]
               for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms", "shape")},
            "bit_identical": all(c["bit_identical"]
                                 for c in checks[k.symbol].values()),
            "deploy": checks[k.symbol]["deploy"],
        }
        for k in kernels
    ] + [
        {
            "name": k.symbol,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": sum(by_path[k.symbol].values()),
            "launches_by_path": by_path[k.symbol],
            **{key: attn[k.symbol][f"serve_{row_dtype[k.symbol]}"][key]
               for key in ("max_abs_err", "max_err_ratio", "ms",
                           "plain_ms", "bound_ms", "bound_by", "library_ms",
                           "shape", "dtype")},
            "within_tolerance": all(c["within_tolerance"]
                                    for c in attn[k.symbol].values()),
            "deploy": attn[k.symbol][f"deploy_{row_dtype[k.symbol]}"],
            **({"lse": lse_row} if k is PAGED_ATTENTION else {}),
        }
        for k in serve_kernels
    ] + [
        {
            "name": k.symbol,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": sum(by_path[k.symbol].values()),
            "launches_by_path": by_path[k.symbol],
            **{key: lm["backward"][backward_row[k.symbol]][key]
               for key in ("max_abs_err", "max_err_ratio", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms", "shape",
                           "dtype")},
            "within_tolerance": all(
                c["within_tolerance"] for c in lm["backward"].values()
                if c["kernel"] == k.symbol),
            **{key: lm["backward"][repeat_row[k.symbol]][key]
               for key in ("bit_identical_rerun", "kernels_ms")},
        }
        for k in backward_kernels
    ] + [
        {
            "name": EMBEDDING_BAG.symbol,
            "route": "cuda",
            "source": EMBEDDING_BAG.source,
            "replaces": EMBEDDING_BAG.replaces,
            "launches": (recsys["launches"] + train["launches"]
                         + mesh_bags + mserve["launches"]),
            "launches_by_path": {"serve": recsys["launches"],
                                 "train": train["launches"],
                                 "mesh": mesh_bags,
                                 "mesh_serve": mserve["launches"]},
            **{key: bags["serve_bf16"][key]
               for key in ("max_abs_err", "max_err_ratio", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms", "shape",
                           "dtype", "bit_identical")},
            "within_tolerance": all(c["within_tolerance"]
                                    for c in bags.values()),
            "deploy": bags["deploy_bf16"],
            "grouped": {key: bags["grouped_bf16"][key]
                        for key in ("tables", "shape", "ms", "per_table_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "bit_identical")},
            "windowed": {key: bags["grouped_windowed_bf16"][key]
                         for key in ("tables", "shape", "ms",
                                     "unwindowed_ms", "kernel_ms",
                                     "unwindowed_kernel_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "bit_identical")},
            "backward": train["backward"],
        },
        {
            "name": ADAMW.symbol,
            "route": "cuda",
            "source": ADAMW.source,
            "replaces": ADAMW.replaces,
            "launches": sum(adamw_by_path.values()),
            "launches_by_path": adamw_by_path,
            **{key: adamw["cases"]["dlrm_t0"][key]
               for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                           "library_ms", "shape", "bit_identical")},
            "granite_stacked": adamw["cases"]["granite_stacked"],
        }
    ]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"smi": smi, "search": {k: v for k, v in search.items()
                                    if k != "failures"},
             "search_replica": {k: v for k, v in replica.items()
                                if k != "failures"},
             "search_kernels": checks,
             "serve": serve, "parity": parity, "attention": attn,
             "recsys": recsys, "recsys_parity": rparity,
             "embedding_bag": bags, "mesh_recsys_serve": mserve,
             "recsys_train": train, "adamw": adamw,
             "moe_serve": moe, "moe_serve_qwen3": qwen3,
             "moe_parity": mparity, "lm_train": lm, "mesh": mesh,
             "gnn_train": gnn, "mesh_gnn": mgnn, "dryrun": dry,
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
