"""Position-join backends for proximity search.

The window join is the query-side hot spot of the ordinary+join route:
given two posting lists sorted by (doc, pos), keep the rows of ``a``
that have a row of ``b`` in the same doc within ``window`` positions.

Three interchangeable backends:

  * ``numpy_window_join``  — host oracle (searchsorted over packed keys),
  * ``torch_window_join``  — ``torch.searchsorted`` over int64 packed keys
    on the device; ``torch_join_many`` joins many (a, b) pairs of the same
    padded power-of-two shape with ONE batched searchsorted per bucket,
  * ``cuda_window_join``   — doc-level prefilter through the hand-written
    membership kernel (``sorted_member_mask``), then the exact host
    window join over the surviving rows.

Key packing is explicit everywhere: ``pos_scale`` picks the smallest
power of two that can hold ``max_pos + window + 1``, so ``doc * scale +
pos ± window`` never crosses a doc boundary.  The device keys are int64
like the host's, so every doc id joins on the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.kernels.intersect.ops import doc_member_mask

_EMPTY = np.zeros((0, 2), dtype=np.int64)

# pads of the batched device join: b pads sit above every real key, a pads
# stay clear of +window overflow (their mask rows are sliced away)
_BIG = int(np.iinfo(np.int64).max)


# ----------------------------------------------------------- key packing --
def pos_scale(max_pos: int, window: int) -> int:
    """Smallest power of two > max_pos + window (explicit, data-driven)."""
    need = int(max_pos) + int(window) + 1
    scale = 1
    while scale < need:
        scale <<= 1
    return scale


def pack_keys(
    a: np.ndarray, b: np.ndarray, window: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pack (doc, pos) rows into sortable int64 scalar keys.

    Returns ``(akey, bkey, scale)`` with ``key = doc * scale + pos``;
    ``scale`` leaves headroom so ``key ± window`` stays inside the doc.
    """
    max_pos = int(max(a[:, 1].max(), b[:, 1].max())) if a.size and b.size else 0
    scale = pos_scale(max_pos, window)
    akey = a[:, 0] * np.int64(scale) + a[:, 1]
    bkey = b[:, 0] * np.int64(scale) + b[:, 1]
    return akey, bkey, scale


# ------------------------------------------------------------ numpy oracle --
def numpy_window_join(a: np.ndarray, b: np.ndarray, window: int) -> np.ndarray:
    """Rows of ``a`` having a row of ``b`` with the same doc and
    |pos_a - pos_b| <= window.  Both (N,2), sorted by (doc, pos)."""
    if a.size == 0 or b.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    akey, bkey, _ = pack_keys(a, b, window)
    lo = np.searchsorted(bkey, akey - window)
    hi = np.searchsorted(bkey, akey + window, side="right")
    return a[hi > lo]


def numpy_phrase_join(a: np.ndarray, b: np.ndarray, dist: int) -> np.ndarray:
    """Rows of ``a`` where ``b`` has the same doc at exactly pos_a + dist
    (ordered adjacency — the stop-sequence index semantics)."""
    if a.size == 0 or b.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    akey, bkey, _ = pack_keys(a, b, dist)
    want = akey + dist
    i = np.searchsorted(bkey, want)
    i = np.minimum(i, bkey.shape[0] - 1)
    return a[bkey[i] == want]


# -------------------------------------------------------------- torch path --
def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def torch_join_many(
    pairs: List[Tuple[np.ndarray, np.ndarray, int]],
    device: DeviceLike = None,
) -> List[np.ndarray]:
    """Window-join many ``(a, b, window)`` pairs on ``device``.

    Jobs are bucketed by padded power-of-two ``(N, M)``; each bucket is
    one batched ``torch.searchsorted`` over a ``(B, N)`` by ``(B, M)``
    int64 key matrix.  ``right=True`` is numpy's ``side="right"``."""
    dev = resolve_device(device)
    out: List[Optional[np.ndarray]] = [None] * len(pairs)
    buckets: Dict[Tuple[int, int], List] = {}
    for idx, (a, b, w) in enumerate(pairs):
        if a.size == 0 or b.size == 0:
            out[idx] = _EMPTY
            continue
        akey, bkey, _ = pack_keys(a, b, w)
        shape = (_pow2(akey.shape[0]), _pow2(bkey.shape[0]))
        buckets.setdefault(shape, []).append((idx, a, akey, bkey, w))
    for (n, m), jobs in buckets.items():
        nb = _pow2(len(jobs))
        ak = np.full((nb, n), _BIG - 1, np.int64)
        bk = np.full((nb, m), _BIG, np.int64)
        ws = np.zeros((nb, 1), np.int64)
        for r, (idx, a, akey, bkey, w) in enumerate(jobs):
            # pad a below the overflow line for this row's window; pad b
            # above every real key so padding can never witness a hit
            ak[r, : akey.shape[0]] = akey
            ak[r, akey.shape[0]:] = _BIG - w - 1
            bk[r, : bkey.shape[0]] = bkey
            ws[r] = w
        akt = to_device(ak, dev)
        bkt = to_device(bk, dev)
        wst = to_device(ws, dev)
        lo = torch.searchsorted(bkt, akt - wst)
        hi = torch.searchsorted(bkt, akt + wst, right=True)
        mask = (hi > lo).cpu().numpy()
        for r, (idx, a, _akey, _bkey, _w) in enumerate(jobs):
            out[idx] = a[mask[r, : a.shape[0]]]
    return out


def torch_window_join(a: np.ndarray, b: np.ndarray, window: int,
                      device: DeviceLike = None) -> np.ndarray:
    """One window join on the device (a bucket of one)."""
    return torch_join_many([(a, b, window)], device=device)[0]


# ----------------------------------------------------------- cuda backend --
def cuda_window_join(a: np.ndarray, b: np.ndarray, window: int,
                     device: DeviceLike = None) -> np.ndarray:
    """Doc-level prefilter with the membership kernel, exact finish.

    The kernel computes membership of ``a``'s doc ids in ``b``'s doc ids;
    only rows in common docs reach the exact host window join, which on
    real queries is a small fraction of the input."""
    if a.size == 0 or b.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    mask = doc_member_mask(a[:, 0], b[:, 0], device=device)
    a_hit = a[mask]
    if a_hit.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    b_hit = b[np.isin(b[:, 0], np.unique(a_hit[:, 0]))]
    return numpy_window_join(a_hit, b_hit, window)


# every backend takes (a, b, window); the device ones also device=
JOIN_BACKENDS = {
    "numpy": numpy_window_join,
    "torch": torch_window_join,
    "cuda": cuda_window_join,
}
