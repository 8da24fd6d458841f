"""Cluster arena: the paper's "data file organized as a sequence of blocks".

All blocks (clusters) have the same size, fixed at construction (paper
section 3; 32 KB default).  The arena provides:

  * single-cluster allocation (chains, PART clusters, FL area),
  * contiguous *segment* allocation (strategy S) via a first-fit extent
    allocator with coalescing free — segments must be physically sequential
    so that reading a segment is ONE device operation,
  * a free-clusters list (paper section 5.7.1 step 4: freed chain clusters
    are recycled),
  * byte-accurate cluster payloads, so search results can be validated
    against a ground-truth oracle, not just counted.

Cluster payloads are Python ``bytearray``s; the *device traffic* is what is
measured, through the :class:`~repro_torch.core.io_sim.BlockDevice` passed in.
A link slot of ``LINK_BYTES`` is reserved at the end of any cluster that
participates in a linked structure (paper Fig. 1: "the small black box").
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.io_sim import BlockDevice

LINK_BYTES = 8  # reserved link slot at the end of linked clusters


class ExtentAllocator:
    """First-fit extent allocator over cluster ids with free coalescing."""

    def __init__(self, initial_clusters: int = 0):
        # sorted list of (start, length) free extents
        self._free: List[Tuple[int, int]] = []
        self._frontier = 0  # next never-used cluster id
        self.capacity_high_water = 0
        if initial_clusters:
            self._free.append((0, initial_clusters))
            self._frontier = initial_clusters

    def alloc(self, length: int) -> int:
        """Allocate ``length`` physically contiguous clusters, return start id."""
        assert length > 0
        for i, (start, flen) in enumerate(self._free):
            if flen >= length:
                if flen == length:
                    self._free.pop(i)
                else:
                    self._free[i] = (start + length, flen - length)
                return start
        # extend the file
        start = self._frontier
        self._frontier += length
        self.capacity_high_water = max(self.capacity_high_water, self._frontier)
        return start

    def free(self, start: int, length: int) -> None:
        if length <= 0:
            return
        entry = (start, length)
        idx = bisect.bisect_left(self._free, entry)
        self._free.insert(idx, entry)
        self._coalesce(idx)

    def _coalesce(self, idx: int) -> None:
        # merge with previous
        if idx > 0:
            ps, pl = self._free[idx - 1]
            s, l = self._free[idx]
            if ps + pl == s:
                self._free[idx - 1] = (ps, pl + l)
                self._free.pop(idx)
                idx -= 1
        # merge with next
        if idx + 1 < len(self._free):
            s, l = self._free[idx]
            ns, nl = self._free[idx + 1]
            if s + l == ns:
                self._free[idx] = (s, l + nl)
                self._free.pop(idx + 1)

    @property
    def free_clusters(self) -> int:
        return sum(l for _, l in self._free)


@dataclasses.dataclass
class ClusterMeta:
    """Host-side metadata for one allocated cluster."""

    used: int = 0          # payload bytes in use (excluding link slot)
    link: int = -1         # linked cluster id (-1: none); direction is owner-defined
    is_part: bool = False  # PART cluster (subdivided)


class ClusterStore:
    """The data file: payloads + allocator + metadata + device accounting."""

    def __init__(self, device: BlockDevice, cluster_size: Optional[int] = None):
        self.device = device
        self.cluster_size = int(cluster_size or device.cluster_size)
        self.alloc = ExtentAllocator()
        self.payload: Dict[int, bytearray] = {}
        self.meta: Dict[int, ClusterMeta] = {}

    # capacity of a linked cluster's payload area
    @property
    def linked_capacity(self) -> int:
        return self.cluster_size - LINK_BYTES

    # ------------------------------------------------------------------ alloc --
    def alloc_cluster(self) -> int:
        cid = self.alloc.alloc(1)
        self.payload[cid] = bytearray()
        self.meta[cid] = ClusterMeta()
        return cid

    def alloc_segment(self, length: int) -> int:
        start = self.alloc.alloc(length)
        for cid in range(start, start + length):
            self.payload[cid] = bytearray()
            self.meta[cid] = ClusterMeta()
        return start

    def free_clusters(self, ids: List[int]) -> None:
        """Return clusters to the free list (paper 5.7.1 step 4)."""
        for cid in ids:
            self.payload.pop(cid, None)
            self.meta.pop(cid, None)
        # coalesce adjacent ids into extents before freeing
        for start, length in _id_runs(sorted(set(ids))):
            self.alloc.free(start, length)

    # ------------------------------------------------------------------- data --
    def append_bytes(self, cid: int, data: bytes, linked: bool = True) -> int:
        """Append as much of ``data`` into cluster ``cid`` as fits.

        Returns the number of bytes consumed.  No device traffic is charged
        here — the cache layer decides when clusters actually move.
        """
        cap = self.linked_capacity if linked else self.cluster_size
        meta = self.meta[cid]
        room = cap - meta.used
        take = min(room, len(data))
        if take > 0:
            self.payload[cid] += data[:take]
            meta.used += take
        return take

    def read_payload(self, cid: int) -> bytes:
        return bytes(self.payload[cid])

    def set_link(self, cid: int, target: int) -> None:
        self.meta[cid].link = target

    def used(self, cid: int) -> int:
        return self.meta[cid].used


def _id_runs(sorted_ids: List[int]) -> List[Tuple[int, int]]:
    runs: List[Tuple[int, int]] = []
    start = prev = None
    for cid in sorted_ids:
        if start is None:
            start = prev = cid
            continue
        if cid == prev + 1:
            prev = cid
            continue
        runs.append((start, prev - start + 1))
        start = prev = cid
    if start is not None:
        runs.append((start, prev - start + 1))
    return runs
