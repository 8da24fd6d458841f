"""The operations and bytes each measured piece of work needs, counted
from its shapes and data.

A frozen copy of the port's counting (``kernels/costs.py``'s flash and
bag counts, the LM's model FLOPs of ``launch/roofline.py``), kept here so
that a change to the program cannot change the yardstick.  Bytes count
each input read once and each output written once; operations count
the useful ones only (no recomputation, no masked-out pairs).
"""

from __future__ import annotations

from typing import Dict, Tuple


def causal_pairs(S: int) -> float:
    """(query, key) pairs a causal attention over ``S`` positions needs."""
    return S * (S + 1) / 2


def flash_forward(B: int, H: int, Hkv: int, S: int, D: int, esize: int
                  ) -> Tuple[float, float]:
    """One causal attention forward: q k^T and p v, 2 D operations each
    a pair and head; q, the output and Hkv heads of k and v moved once."""
    flops = 4 * B * H * D * causal_pairs(S)
    nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * esize
    return flops, nbytes


def flash_backward(B: int, H: int, Hkv: int, S: int, D: int, esize: int
                   ) -> Tuple[float, float]:
    """One causal attention backward: q k^T recomputed, then dO V^T,
    P^T dO, dS K and dS^T q; q, k, v, o, dO and the f32 log-sum-exp read
    once, dq, dk, dv written once."""
    flops = 5 * 2 * B * H * D * causal_pairs(S)
    nbytes = 4 * (B * H + B * Hkv) * S * D * esize + 4 * B * H * S
    return flops, nbytes


def lm_matmul_params(d: int, H: int, Hkv: int, D: int, ff: int, L: int,
                     V: int) -> int:
    """The weights a token multiplies: attention's four projections and
    the SwiGLU MLP's three in every layer, and the unembedding."""
    per_layer = d * H * D + 2 * d * Hkv * D + H * D * d + 3 * d * ff
    return L * per_layer + d * V


def lm_train_flops(d: int, H: int, Hkv: int, D: int, ff: int, L: int,
                   V: int, B: int, S: int) -> float:
    """Model FLOPs of one training step over ``B`` x ``S`` tokens: every
    matmul 3 x its forward (2 a weight and token), causal attention 3 x
    its forward over half the square; remat recompute not counted."""
    mm = 2 * lm_matmul_params(d, H, Hkv, D, ff, L, V) * B * S
    att = L * 4 * B * H * D * causal_pairs(S)
    return 3 * (mm + att)


def adamw_bytes(n_params: int) -> int:
    """One AdamW update of f32 parameters, gradients and moments: p, g,
    mu and nu read once, p, mu and nu written once."""
    return 28 * n_params


def mlp_flops(dims) -> int:
    """Forward multiply-adds, as FLOPs, of one row through an MLP of
    widths ``dims``."""
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def dlrm_train_counts(n_dense: int, bot, top, D: int, n_tables: int,
                      B: int) -> Dict[str, float]:
    """FLOPs by dtype of one DLRM training step of ``B`` rows, 3 x the
    forward: the MLPs in bf16, the dot interaction's pairs (each of the
    ``n (n - 1) / 2`` distinct pairs of the 27 vectors once) in f32."""
    n = n_tables + 1
    mlp = mlp_flops((n_dense,) + tuple(bot)) + mlp_flops(
        (D + n * (n - 1) // 2,) + tuple(top))
    inter = 2 * D * n * (n - 1) // 2
    return {"bf16": 3.0 * mlp * B, "f32": 3.0 * inter * B}


def bag_forward_bytes(distinct_rows: int, D: int, table_esize: int,
                      n_ids: int, B: int, slots: int, head_esize: int,
                      out_esize: int) -> int:
    """The grouped bag's forward: each distinct row read once, every
    int32 id once, the single shared weight once, the head vector (slot
    0) read once and the ``slots`` vectors of a row written once."""
    return (distinct_rows * D * table_esize + 4 * n_ids + 4
            + B * D * head_esize + B * slots * D * out_esize)


def dlrm_forward_flops(n_dense: int, bot, top, D: int, n_tables: int,
                       B: int) -> Dict[str, float]:
    """FLOPs by dtype of one DLRM forward of ``B`` rows."""
    return {k: v / 3 for k, v in
            dlrm_train_counts(n_dense, bot, top, D, n_tables, B).items()}
