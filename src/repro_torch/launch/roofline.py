"""Roofline report of the dry run, the port of ``repro.launch.roofline``:
reads ``build/dryrun/*.json`` (``launch.dryrun``), adds the analytic
MODEL_FLOPS and prints the table, on the H100's figures
(``launch.mesh.HW``).

Per (arch x shape x mesh), a rank's terms:
  compute_s    = each dtype's dot FLOPs over its own peak: bf16 on the
                 tensor cores (989 TFLOP/s), f32 outside them (67), the
                 split-TF32 kernels' f32 products (165)
  memory_s     = bytes over HBM bandwidth
  collective_s = each collective's ring wire bytes over the slowest link
                 its ring crosses (:func:`roofline_terms`)
  MODEL_FLOPS  = analytic useful compute (6*N*D train / 2*N*D serve for
                 LM; op-count models for GNN/recsys), the reference's
  ratio        = counted FLOPs / MODEL_FLOPS  (remat, padding, dispatch
                 and replicated work)

The reference also has ``hlo_graph.py`` and ``hlo_stats.py``, which parse
the XLA HLO text of a compiled step.  A PyTorch program has no HLO to
parse, so the port has no copies of them: their arithmetic, the ring
wire factors (:func:`wire_bytes`) and the roofline terms, lives here, and
their counting (dot FLOPs, bytes a kernel, collectives with their groups)
in ``launch.dryrun``, which counts the aten ops and collectives of the
traced step as they are dispatched.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline
       [--mesh single|multi|both] [--collectives] [--write-md]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Optional

from repro_torch.launch.mesh import HW

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "../../../build/dryrun")

# the dry run's names of the dtypes its FLOPs are filed under, and the
# rate of each in HW
DTYPE_RATES = {"bf16": "peak_bf16_flops", "f32": "peak_f32_flops",
               "tf32x3": "peak_tf32x3_flops"}


def _lm_model_flops(arch: str, shape: str, n_chips: int) -> float:
    from repro_torch.configs.registry import get_bundle

    cfg = get_bundle(arch).config
    n_active = cfg.params_active
    B, S = {
        "train_4k": (256, 4096),
        "prefill_32k": (32, 32768),
        "decode_32k": (128, 32768),
        "long_500k": (1, 524288),
    }[shape]
    if shape == "train_4k":
        flops = 6.0 * n_active * B * S
    elif shape == "prefill_32k":
        # fwd only + causal attention term
        att = 2.0 * cfg.n_layers * B * S * S * cfg.n_heads * cfg.d_head
        flops = 2.0 * n_active * B * S + att
    else:
        # decode: one token per sequence reads the whole KV cache
        att = 4.0 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.d_head
        flops = 2.0 * n_active * B + att
    return flops / n_chips


def _gnn_model_flops(shape: str, n_chips: int) -> float:
    k = 128
    cells = {
        "full_graph_sm": (2708, 10556, 1433),
        "minibatch_lg": (169_984, 168_960, 602),
        "ogb_products": (2_449_029, 61_859_140, 100),
        "molecule": (128 * 30, 128 * 64, 0),
    }
    N, E, dfeat = cells[shape]
    L = 2
    msg = 2.0 * E * k * 9 * 9 * 9          # Gaunt contraction per edge
    bbasis = 2.0 * N * k * 9 * 9 * 9 * 2   # B2 + B3
    mix = 2.0 * N * k * k * 9 * 4          # w1,w2,w3,self
    radial = 2.0 * E * (8 * 32 + 32 * 3 * k)
    feat = 2.0 * N * dfeat * k
    fwd = L * (msg + bbasis + mix + radial) + feat
    return 3.0 * fwd / n_chips  # train step ~ 3x fwd


def _recsys_model_flops(arch: str, shape: str, n_chips: int) -> float:
    B = {"train_batch": 65_536, "serve_p99": 512, "serve_bulk": 262_144,
         "retrieval_cand": 1_000_000}[shape]
    per_ex = {
        # fwd flops per example (dominant MLP/interaction terms)
        "dlrm-mlperf": 2.0 * (13 * 512 + 512 * 256 + 256 * 128
                              + 479 * 1024 + 1024 * 1024 + 1024 * 512
                              + 512 * 256 + 256),
        "din": 2.0 * (100 * (4 * 36 * 80 + 80 * 40 + 40)
                      + 3 * 36 * 200 + 200 * 80 + 80),
        "sasrec": 2.0 * (2 * (4 * 50 * 50 + 2 * 50 * 50 + 2 * 50 * 50) * 50
                         + 50 * 50 * 60_000),
        "two-tower-retrieval": 2.0 * 2 * (512 * 1024 + 1024 * 512 + 512 * 256),
    }[arch]
    if arch == "two-tower-retrieval" and shape == "retrieval_cand":
        return (per_ex / 2 + 2.0 * 1_000_000 * 256) / n_chips
    if arch == "sasrec" and shape != "train_batch":
        per_ex = per_ex - 2.0 * 50 * 50 * 60_000 + 2.0 * 50 * 200  # no full softmax
    mult = 3.0 if shape == "train_batch" else 1.0
    return mult * per_ex * B / n_chips


def model_flops(arch: str, shape: str, n_chips: int) -> Optional[float]:
    try:
        if shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            return _lm_model_flops(arch, shape, n_chips)
        if shape in ("full_graph_sm", "minibatch_lg", "ogb_products",
                     "molecule"):
            return _gnn_model_flops(shape, n_chips)
        return _recsys_model_flops(arch, shape, n_chips)
    except Exception:
        return None


def wire_bytes(kind: str, n: int, result_bytes: float) -> float:
    """Bytes a rank sends in a ring collective of ``kind`` over ``n``
    ranks, from its result's bytes (the reference's ``hlo_stats``
    factors; a group of one rank sends nothing):

      all-reduce          2 (n-1)/n x result
      all-gather          (n-1)/n x result     (result = gathered size)
      reduce-scatter      (n-1) x result       (result = this rank's shard)
      all-to-all          (n-1)/n x result
      broadcast, send     1 x result"""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if kind in ("all-gather", "all-to-all"):
        return (n - 1) / n * result_bytes
    if kind == "reduce-scatter":
        return (n - 1.0) * result_bytes
    return float(result_bytes)


def spans_nodes(ranks, hw: Dict = HW) -> bool:
    """Whether a group's ranks sit on more than one node: rank ``r`` on
    node ``r // gpus_per_node``, the row-major order in which
    ``init_device_mesh`` numbers a mesh's ranks."""
    return len({r // hw["gpus_per_node"] for r in ranks}) > 1


def roofline_terms(flops: Dict[str, float], hbm_bytes: float,
                   node_wire_bytes: float, cross_node_wire_bytes: float,
                   hw: Dict = HW) -> Dict:
    """A rank's three roofline terms in seconds, and which dominates.

    ``flops`` maps the dtypes of ``DTYPE_RATES`` to dot FLOPs; each runs
    at its own peak and the times add.  The collective model: every
    collective is a ring, which moves its wire bytes over the slowest
    link it crosses.  A group whose ranks all sit on one node
    (:func:`spans_nodes`) rings over NVLink at ``link_bw``
    (``node_wire_bytes``); any other group's ring crosses the fabric,
    where each GPU's one NIC at ``net_bw`` is the slowest link
    (``cross_node_wire_bytes``).  Collectives do not overlap one another
    or the compute.  The reference's terms split the same way into ICI
    and DCI."""
    compute_s = sum(f / hw[DTYPE_RATES[dt]] for dt, f in flops.items())
    memory_s = hbm_bytes / hw["hbm_bw"]
    collective_s = (node_wire_bytes / hw["link_bw"]
                    + cross_node_wire_bytes / hw["net_bw"])
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1],
    )[0]
    total = max(compute_s, memory_s, collective_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "bound_s": total,
        "compute_fraction": compute_s / total if total else 0.0,
    }


def load_cells(mesh: str = "single") -> Dict:
    out = {}
    for f in sorted(glob.glob(os.path.join(DRYRUN_DIR, f"*__{mesh}.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("ok"):
            out[(r["arch"], r["shape"])] = r
    return out


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def _fits(mem: Dict) -> str:
    return "yes" if mem["fits"] else \
        f"no (+{(mem['peak_size'] - HW['hbm_bytes']) / 1e9:.1f} GB)"


def build_table(mesh: str = "single") -> str:
    """The report of ``mesh``'s cells; ``"both"`` puts each cell's two
    meshes on one row (per rank: compute / memory / collective, the
    dominant term, MODEL TFLOP, counted over MODEL, peak GB, fits)."""
    if mesh == "both":
        return _both_table()
    cells = load_cells(mesh)
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "MODEL_TF/rank | counted/MODEL | peak GB/rank | fits 80 GB |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), r in sorted(cells.items()):
        t = r["roofline"]
        mf = model_flops(arch, shape, r["n_chips"])
        ratio = (r["flops"] / mf) if (mf and mf > 0) else float("nan")
        mem = r["memory"]
        fits = _fits(mem)
        lines.append(
            f"| {arch} | {shape} | {fmt_s(t['compute_s'])} | "
            f"{fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} | "
            f"**{t['dominant']}** | {(mf or 0)/1e12:.3f} | {ratio:.2f} | "
            f"{mem['peak_size'] / 1e9:.1f} | {fits} |"
        )
    return "\n".join(lines)


def _both_table() -> str:
    single, multi = load_cells("single"), load_cells("multi")
    head = "c / m / coll ms | dom | TF | ×MODEL | GB | fits"
    lines = [f"| arch | shape | single (16, 16): {head} | multi (2, 16, 16):"
             f" {head} |", "|---" * 14 + "|"]
    for key in sorted(set(single) | set(multi)):
        row = [key[0], key[1]]
        for cells in (single, multi):
            r = cells.get(key)
            if r is None:
                row.append("not run")
                continue
            t, mem = r["roofline"], r["memory"]
            mf = model_flops(*key, r["n_chips"])
            ratio = (r["flops"] / mf) if (mf and mf > 0) else float("nan")
            row.append(
                f"{t['compute_s'] * 1e3:.4g} / {t['memory_s'] * 1e3:.4g} / "
                f"{t['collective_s'] * 1e3:.4g} | {t['dominant']} | "
                f"{(mf or 0) / 1e12:.4g} | {ratio:.2f} | "
                f"{mem['peak_size'] / 1e9:.1f} | {_fits(mem)}")
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


def collective_table(mesh: str = "single") -> str:
    """Each cell's collectives on ``mesh``: a rank's ring wire bytes, the
    share that crosses nodes, each mesh axis's count and wire bytes, and
    the bytes its all-gathers return (leaves gathered whole)."""
    lines = ["| arch | shape | wire GB | cross-node | by axis: count, GB |"
             " all-gathered GB |", "|---|---|---|---|---|---|"]
    for (arch, shape), r in sorted(load_cells(mesh).items()):
        c = r["collectives"]
        total = c["total_wire_bytes"]
        if not total:
            continue
        axes = "; ".join(f"{a} {v['count']}, {v['wire_bytes'] / 1e9:.4g}"
                         for a, v in c["by_axis"].items())
        lines.append(
            f"| {arch} | {shape} | {total / 1e9:.4g} | "
            f"{r['cross_node_bytes'] / total:.1%} | {axes} | "
            f"{c['result_bytes'].get('all-gather', 0) / 1e9:.4g} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--collectives", action="store_true",
                    help="the collectives' table of --mesh single or multi")
    ap.add_argument("--write-md", action="store_true")
    args = ap.parse_args()
    table = (collective_table(args.mesh) if args.collectives
             else build_table(args.mesh))
    print(table)
    if args.write_md:
        path = os.path.join(DRYRUN_DIR, f"roofline_{args.mesh}.md")
        with open(path, "w") as f:
            f.write(table + "\n")
        print(f"\nwritten: {path}")


if __name__ == "__main__":
    main()
