"""The least work of each hand kernel's launch: its operations and the
bytes it must move, and the least time the card could take for them.

A launch's bytes count each input read once and each output written
once, whatever the kernel reads again; its operations are the useful
ones at the rate of the unit that does them (``launch.mesh.HW``): the
bf16 tensor cores, the split-TF32 tensor cores (three TF32 products an
f32 product), or the 32-bit units outside the tensor cores.  The bound is
the larger of the two times.

Two callers read these: ``chip_smoke.py``, whose kernel table's
``bound_ms`` column is :meth:`Cost.bound_ms` of the shapes and data it
timed, and the dry run (``launch.dryrun``), which charges each launch of
a traced step its :class:`Cost` (``cuda_lib.CudaKernel.charged``).  Where
the work depends on the data (the rows a bag reads, the tokens a decode
row attends to), the card's checks count what their data needs
(:func:`bag_bytes`); the dry run has no data and counts the most the
shapes allow, said at each function.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from repro_torch.launch.mesh import HW

# the rate keys of HW and the name a dry run files their operations under
RATES = {"peak_bf16_flops": "bf16", "peak_tf32x3_flops": "tf32x3",
         "peak_f32_flops": "f32"}


@dataclasses.dataclass(frozen=True)
class Cost:
    """``flops`` operations at ``HW[rate]`` and ``nbytes`` moved."""
    flops: float
    nbytes: float
    rate: str

    def times(self) -> Tuple[float, float]:
        """Seconds for the operations, and for the bytes."""
        return self.flops / HW[self.rate], self.nbytes / HW["hbm_bw"]

    def bound_ms(self) -> float:
        """The least time on the card, in ms."""
        return max(*self.times()) * 1e3

    def bound_by(self) -> str:
        """``"operations"`` or ``"bytes"``: whichever sets the bound."""
        t_ops, t_bytes = self.times()
        return "operations" if t_ops > t_bytes else "bytes"

    @property
    def dtype(self) -> str:
        """The name the dry run files the operations under."""
        return RATES[self.rate]


def _float_rate(dtype: torch.dtype, f32_rate: str) -> str:
    return "peak_bf16_flops" if dtype == torch.bfloat16 else f32_rate


def varint_cost(n_bytes: int, n_values: int) -> Cost:
    """``varint_decode``: each stream byte read and flagged once, each
    int64 value written once."""
    return Cost(n_bytes, n_bytes + 8 * n_values, "peak_f32_flops")


def member_cost(n: int, m: int, segments: int) -> Cost:
    """``sorted_member_mask``: each key of a read once with its mask byte
    written (9 B), each offset read once, and of b all of it or, where
    that is less, one 32-byte sector a key of a (the search route's least
    work); one compare a merged element or, for the search, a key and its
    sector's four keys."""
    nbytes = 9 * n + min(8 * m, 32 * n) + 16 * (segments + 1)
    return Cost(n + min(m, 4 * n), nbytes, "peak_f32_flops")


def _pairs(S: int, causal: bool) -> float:
    return S * (S + 1) / 2 if causal else S * S


def flash_cost(B: int, H: int, Hkv: int, S: int, D: int,
               dtype: torch.dtype, causal: bool) -> Cost:
    """Either flash forward route: q k^T and p v, 2 D operations each a
    (query, key) pair and head; q and the output of H heads and k, v of
    Hkv heads moved once.  bf16 runs on the bf16 tensor cores, f32 on
    the split-TF32 ones."""
    esize = dtype.itemsize
    flops = 4 * B * H * D * _pairs(S, causal)
    nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * esize
    return Cost(flops, nbytes, _float_rate(dtype, "peak_tf32x3_flops"))


def flash_backward_cost(B: int, H: int, Hkv: int, S: int, D: int,
                        dtype: torch.dtype, causal: bool) -> Cost:
    """Either backward route: q k^T recomputed, then dO V^T, P^T dO, dS K
    and dS^T q, five products of 2 D operations a pair and head; q, k, v,
    o, dO and the log-sum-exp read once, dq, dk, dv written once."""
    esize = dtype.itemsize
    flops = 5 * 2 * B * H * D * _pairs(S, causal)
    nbytes = 4 * (B * H + B * Hkv) * S * D * esize + 4 * B * H * S
    return Cost(flops, nbytes, _float_rate(dtype, "peak_tf32x3_flops"))


def paged_cost(R: int, G: int, D: int, tokens: int, pages: int,
               dtype: torch.dtype, lse: bool = False) -> Cost:
    """``paged_attention``: each of a row's ``tokens`` (summed over the
    rows, each row's length capped at its table) read as K and V once, q
    read and the output written once, each used page's table entry and
    each length read once, and with ``lse`` its f32 log-sum-exp written
    once; q k and p v, 2 D operations a token and query head.  bf16 on
    the tensor cores; f32 on the 32-bit units."""
    esize = dtype.itemsize
    nbytes = (2 * tokens * D * esize + 2 * R * G * D * esize
              + 4 * pages + 4 * R + (4 * R * G if lse else 0))
    return Cost(4 * D * G * tokens, nbytes, _float_rate(dtype,
                                                        "peak_f32_flops"))


def adamw_cost(n: int, p_dtype: torch.dtype, g_dtype: torch.dtype) -> Cost:
    """``adamw``: one leaf of ``n`` elements, p and g read once, p and
    the f32 mu and nu read and written once (28 B an element with f32 p
    and g).  Its 17 f32 operations an element are left out, as the dry
    run leaves out every elementwise op's: at 67 TFLOP/s they take under
    a twentieth of the bytes' time."""
    p, g = p_dtype.itemsize, g_dtype.itemsize
    return Cost(0.0, n * (2 * p + g + 16), "peak_f32_flops")


def bag_bytes(tables: Sequence[torch.Tensor], ids: torch.Tensor,
              id_rule: str, weight_bytes: int, out_bytes: int,
              windows=None) -> int:
    """The bytes a bag launch must move on this data: each distinct row
    that table ``t``'s ids (``ids[t]``) read under ``id_rule`` once (an id
    that reads a NaN row, or a row outside the table's window, reads
    none), every id once, and the weights and the output as the caller
    counts them (shared weights once)."""
    from repro_torch.kernels.embedding_bag.ref import resolve_window

    rows = 0
    for t, table in enumerate(tables):
        r, ok, add = resolve_window(ids[t], table.shape[0],
                                    None if windows is None else windows[t],
                                    id_rule)
        keep = ok if add is None else add if ok is None else add & ok
        if keep is not None:
            r = r[keep]
        rows += torch.unique(r).numel() * table.shape[1] * table.element_size()
    return rows + ids.numel() * 4 + weight_bytes + out_bytes


def bag_launch_cost(tables: Sequence[torch.Tensor], B: int, K: int,
                    weight_bytes: int, out_bytes: int) -> Cost:
    """An ``embedding_bags`` launch of ``B`` bags of ``K`` ids a table,
    counted from the shapes alone (the dry run's charge): each table
    reads the most distinct rows its ids can, ``min(B * K, V)``, every
    int32 id once, the weights and the output as the caller counts
    them; one f32 multiply-add an id and column."""
    rows = sum(min(B * K, t.shape[0]) * t.shape[1] * t.element_size()
               for t in tables)
    n_ids = len(tables) * B * K
    return Cost(2 * n_ids * tables[0].shape[1],
                rows + 4 * n_ids + weight_bytes + out_bytes, "peak_f32_flops")
