"""Sorted membership mask: the CUDA kernel's wrapper and its plain version.

``mask[i] = a[i] in b`` for sorted int64 doc-id lists, segment by segment
— the doc prefilter of the ``cuda`` window join (a whole join round in
one launch) and of ``decode_member_prefilter`` (one segment).  The CUDA
kernel (``csrc/sorted_member_mask.cu``) ports the Pallas
``intersect_kernel``; the source says how and what bounds it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.costs import member_cost
from repro_torch.kernels.cuda_lib import CudaKernel, check_operand

SORTED_MEMBER_MASK = CudaKernel(
    "sorted_member_mask",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int],
    source="src/repro_torch/csrc/sorted_member_mask.cu",
    replaces="src/repro/kernels/intersect/kernel.py:46",
)

# merged elements a thread of the merge route (tiles of 256 x MERGE_ITEMS),
# the source's kItems
MERGE_ITEMS = 15
# the search route where b holds at least this many keys for each key of a
# (measured on an H100: PERF.md section 6)
SEARCH_RATIO = 32
# segments whose offsets travel inside the kernel's parameters; more go
# to the device first
INLINE_SEGMENTS = 64


def member_route(n: int, m: int, segments: int) -> str:
    """The route a launch of ``n`` keys of ``a`` against ``m`` of ``b`` in
    ``segments`` segments takes: ``"search"`` where ``b`` holds at least
    ``SEARCH_RATIO`` keys for each key of ``a``, else ``"merge"``.  A
    search costs each key about log2 of its segment's ``m / n`` sectors and
    a merge reads every key once, so only the ratio counts; ``segments``
    only guards a launch without any."""
    if segments < 1 or n == 0:
        return "merge"
    return "search" if m >= SEARCH_RATIO * n else "merge"


def one_segment(t: torch.Tensor) -> np.ndarray:
    """The offsets of ``t`` as one segment."""
    return np.array([0, t.numel()], np.int64)


def check_offsets(off, total: int, name: str) -> np.ndarray:
    """Host int64 offsets of S + 1 entries, from 0 up to ``total``,
    never falling; raise on anything else.  Offsets live on the host, so
    this needs no device sync."""
    if isinstance(off, torch.Tensor):
        if off.device.type != "cpu":
            raise ValueError(f"{name} must lie on the host, not {off.device}")
        off = off.numpy()
    off = np.asarray(off)
    if off.dtype != np.int64 or off.ndim != 1 or off.size < 2:
        raise ValueError(f"{name} must be 1-d int64 with at least 2 "
                         f"entries, got {off.dtype} {off.shape}")
    if off[0] != 0 or off[-1] != total:
        raise ValueError(f"{name} must run from 0 to {total}, got "
                         f"{off[0]} to {off[-1]}")
    if np.any(np.diff(off) < 0):
        raise ValueError(f"{name} must not fall")
    return np.ascontiguousarray(off)


def check_segments(a: torch.Tensor, a_off, b: torch.Tensor,
                   b_off) -> Tuple[np.ndarray, np.ndarray]:
    """Both sides' offsets checked (:func:`check_offsets`), as many
    segments of ``a`` as of ``b``."""
    a_off = check_offsets(a_off, a.numel(), "a_off")
    b_off = check_offsets(b_off, b.numel(), "b_off")
    if a_off.size != b_off.size:
        raise ValueError(f"{a_off.size - 1} segments of a, "
                         f"{b_off.size - 1} of b")
    return a_off, b_off


def segment_tags(a: torch.Tensor, a_off: np.ndarray, b: torch.Tensor,
                 b_off: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """``a`` and ``b`` as one sorted key space: each key becomes
    ``segment * (N + M) + rank``, its rank among all keys of both.  A key
    of ``a`` meets only the keys of ``b`` in its own segment, and the tags
    of each side stay sorted.  Keys of one segment are their own tags."""
    if a_off.size == 2:
        return a, b
    n, m = a.numel(), b.numel()
    keys, rank = torch.unique(torch.cat([a, b]), return_inverse=True)
    span = max(int(keys.numel()), 1)
    if (a_off.size - 1) * span >= 2 ** 63:
        raise ValueError("too many segments to tag in int64")
    seg_a = torch.repeat_interleave(
        torch.arange(a_off.size - 1, device=a.device),
        torch.from_numpy(np.diff(a_off)).to(a.device), output_size=n)
    seg_b = torch.repeat_interleave(
        torch.arange(b_off.size - 1, device=b.device),
        torch.from_numpy(np.diff(b_off)).to(b.device), output_size=m)
    return seg_a * span + rank[:n], seg_b * span + rank[n:]


def sorted_member_mask_segments_plain(a: torch.Tensor, a_off, b: torch.Tensor,
                                      b_off) -> torch.Tensor:
    """Plain PyTorch version: one ``torch.searchsorted`` over segment
    tags (:func:`segment_tags`) and an equality test."""
    a_off, b_off = check_segments(a, a_off, b, b_off)
    if b.numel() == 0 or a.numel() == 0:
        return torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    ta, tb = segment_tags(a, a_off, b, b_off)
    idx = torch.searchsorted(tb, ta).clamp_(max=tb.numel() - 1)
    return tb[idx] == ta


def run_member_mask(a: torch.Tensor, a_off: np.ndarray, b: torch.Tensor,
                    b_off: np.ndarray, route: str) -> torch.Tensor:
    """Launch the kernel on CUDA operands and host offsets that
    :func:`sorted_member_mask_segments` has checked.  Up to
    ``INLINE_SEGMENTS`` segments' offsets go to the kernel as parameters;
    more are copied to the device first.  The wrapper calls it with
    :func:`member_route`'s choice; the card's checks call it to time both
    routes."""
    codes = {"search": 0, "merge": 1}
    if route not in codes:
        raise ValueError(f"no route {route!r}")
    code = codes[route]
    out = torch.empty(a.shape, dtype=torch.bool, device=a.device)
    if a.numel() == 0:
        return out
    segments = a_off.size - 1
    if SORTED_MEMBER_MASK.charged((a, b), lambda: member_cost(
            a.numel(), b.numel(), segments)):
        return out
    offs = (torch.from_numpy(np.concatenate([a_off, b_off])).to(a.device)
            if segments > INLINE_SEGMENTS else None)
    ranks = None
    tiles = -(-(a.numel() + b.numel()) // (256 * MERGE_ITEMS))
    if code and tiles > 1:  # the merge route's tile edges
        ranks = torch.empty(2 * (tiles + 1), dtype=torch.int64,
                            device=a.device)
    SORTED_MEMBER_MASK.launch(
        a.device, (a.numel(), b.numel()), a.data_ptr(), a.numel(),
        a_off.ctypes.data, b.data_ptr(), b.numel(), b_off.ctypes.data,
        offs.data_ptr() if offs is not None else None, segments,
        out.data_ptr(), ranks.data_ptr() if ranks is not None else None,
        code,
    )
    return out


def sorted_member_mask_segments(a: torch.Tensor, a_off, b: torch.Tensor,
                                b_off) -> torch.Tensor:
    """(N,) bool: for each segment s, ``a[i]`` (``a_off[s] <= i <
    a_off[s+1]``) occurs in ``b[b_off[s]:b_off[s+1]]``.

    ``a`` (N,) and ``b`` (M,) are int64 on one device, each segment of
    ``a`` sorted (keys may repeat), each of ``b`` sorted without
    duplicates.  ``a_off`` and ``b_off`` are S + 1 int64 offsets on the
    host (numpy or CPU tensors), checked there.  CUDA tensors go through
    the kernel in one launch; CPU tensors through
    :func:`sorted_member_mask_segments_plain`."""
    check_operand(a, "a", torch.int64)
    check_operand(b, "b", torch.int64)
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.device.type == "cpu":
        return sorted_member_mask_segments_plain(a, a_off, b, b_off)
    a_off, b_off = check_segments(a, a_off, b, b_off)
    route = member_route(a.numel(), b.numel(), a_off.size - 1)
    return run_member_mask(a, a_off, b, b_off, route)


def sorted_member_mask_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the one-segment case of
    :func:`sorted_member_mask_segments_plain`."""
    return sorted_member_mask_segments_plain(a, one_segment(a), b,
                                             one_segment(b))


def sorted_member_mask(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N,) bool: ``a[i]`` occurs in ``b``.

    ``a`` (N,) and ``b`` (M,) are sorted int64 on one device, ``b``
    without duplicates.  CUDA tensors go through the kernel as one
    segment; CPU tensors through :func:`sorted_member_mask_plain`."""
    check_operand(a, "a", torch.int64)
    check_operand(b, "b", torch.int64)
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.device.type == "cpu":
        return sorted_member_mask_plain(a, b)
    return run_member_mask(a, one_segment(a), b, one_segment(b),
                           member_route(a.numel(), b.numel(), 1))
