"""Simulated block device with exact I/O accounting.

This module is the measurement substrate for reproducing the paper's
Tables 2 and 3: every read/write of index clusters during construction,
update and search goes through a :class:`BlockDevice`, which counts

  * the number of I/O *operations* (a contiguous run of clusters moved in one
    call is ONE operation — this is what makes the S strategy's contiguous
    segments cheaper than chains of scattered clusters), and
  * the number of *bytes* moved.

The DS strategy (paper section 5.9) is implemented as a wrapper device that
packs small writes (<= ``small_threshold`` bytes) into a large in-memory
buffer and flushes it with a single write operation, maintaining the
address mapping table the paper describes.

The device is deliberately host-side, single-threaded Python: the paper
measures *disk* behaviour of index construction, which is sequential host
logic.  The TPU-side adaptation of the same ideas lives in
``repro/core/paged_kv.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple


@dataclasses.dataclass
class IOStats:
    """Aggregate I/O accounting, split by direction."""

    read_ops: int = 0
    write_ops: int = 0
    read_bytes: int = 0
    write_bytes: int = 0

    @property
    def total_ops(self) -> int:
        return self.read_ops + self.write_ops

    @property
    def total_bytes(self) -> int:
        return self.read_bytes + self.write_bytes

    def snapshot(self) -> "IOStats":
        return IOStats(self.read_ops, self.write_ops, self.read_bytes, self.write_bytes)

    def delta(self, since: "IOStats") -> "IOStats":
        return IOStats(
            self.read_ops - since.read_ops,
            self.write_ops - since.write_ops,
            self.read_bytes - since.read_bytes,
            self.write_bytes - since.write_bytes,
        )

    def merged(self, other: "IOStats") -> "IOStats":
        return IOStats(
            self.read_ops + other.read_ops,
            self.write_ops + other.write_ops,
            self.read_bytes + other.read_bytes,
            self.write_bytes + other.write_bytes,
        )

    def as_dict(self) -> Dict[str, int]:
        return {
            "read_ops": self.read_ops,
            "write_ops": self.write_ops,
            "read_bytes": self.read_bytes,
            "write_bytes": self.write_bytes,
            "total_ops": self.total_ops,
            "total_bytes": self.total_bytes,
        }


def _runs(sorted_ids: Sequence[int]) -> List[Tuple[int, int]]:
    """Split a sorted id sequence into (start, length) contiguous runs."""
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


class BlockDevice:
    """A flat array of fixed-size clusters with contiguity-aware accounting.

    ``read_clusters``/``write_clusters`` take cluster id iterables; ids that
    form contiguous runs are charged as a single operation per run (the disk
    analogy: one seek + sequential transfer).  ``read_small``/``write_small``
    model sub-cluster transfers (used by the SR strategy's 128-byte blocks
    and dictionary traffic) and are charged one op each unless the device is
    wrapped by :class:`PackedWriteDevice` (strategy DS).
    """

    def __init__(self, cluster_size: int = 32 * 1024, name: str = "dev"):
        self.cluster_size = int(cluster_size)
        self.name = name
        self.stats = IOStats()

    # -- cluster-granular traffic ------------------------------------------------
    def read_clusters(self, cluster_ids: Iterable[int]) -> None:
        ids = sorted(set(int(c) for c in cluster_ids))
        if not ids:
            return
        for _start, length in _runs(ids):
            self.stats.read_ops += 1  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint
            self.stats.read_bytes += length * self.cluster_size  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint

    def write_clusters(self, cluster_ids: Iterable[int]) -> None:
        ids = sorted(set(int(c) for c in cluster_ids))
        if not ids:
            return
        for _start, length in _runs(ids):
            self.stats.write_ops += 1  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint
            self.stats.write_bytes += length * self.cluster_size  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint

    # -- sub-cluster traffic -----------------------------------------------------
    def read_small(self, nbytes: int) -> None:
        if nbytes <= 0:
            return
        self.stats.read_ops += 1  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint
        self.stats.read_bytes += int(nbytes)  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint

    def write_small(self, nbytes: int) -> None:
        if nbytes <= 0:
            return
        self.stats.write_ops += 1  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint
        self.stats.write_bytes += int(nbytes)  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint

    # -- bulk sequential traffic (FL area load, SR file streaming) ----------------
    def read_sequential(self, nbytes: int) -> None:
        """One large sequential read of ``nbytes`` (one op)."""
        if nbytes <= 0:
            return
        self.stats.read_ops += 1  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint
        self.stats.read_bytes += int(nbytes)  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint

    def write_sequential(self, nbytes: int) -> None:
        if nbytes <= 0:
            return
        self.stats.write_ops += 1  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint
        self.stats.write_bytes += int(nbytes)  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint

    def flush(self) -> None:  # interface parity with PackedWriteDevice
        pass


class PackedWriteDevice(BlockDevice):
    """Strategy DS (section 5.9): pack small writes into large buffers.

    Writes of at most ``small_threshold`` bytes are appended to an in-memory
    pack buffer.  When the buffer reaches ``buffer_size`` it is flushed with
    a single sequential write.  A mapping table records, for each elided
    small write, the (buffer epoch, offset) where its data actually lives —
    faithful to the paper's ``A->a, B->b, C->c`` table.  Reads of relocated
    data are charged against the packed file (still one op, but the paper's
    point is the *write* op elision during construction, which dominates).
    """

    def __init__(
        self,
        cluster_size: int = 32 * 1024,
        small_threshold: int = 32 * 1024,
        buffer_size: int = 1024 * 1024,
        name: str = "ds-dev",
    ):
        super().__init__(cluster_size=cluster_size, name=name)
        self.small_threshold = int(small_threshold)
        self.buffer_size = int(buffer_size)
        self._buffered = 0
        self._epoch = 0
        # mapping table: sequential id of elided write -> (epoch, offset)
        self.mapping: Dict[int, Tuple[int, int]] = {}
        self._next_map_id = 0
        self.packed_flushes = 0

    def _pack(self, nbytes: int) -> None:
        if self._buffered + nbytes > self.buffer_size:
            self.flush()
        self.mapping[self._next_map_id] = (self._epoch, self._buffered)
        self._next_map_id += 1
        self._buffered += nbytes

    def flush(self) -> None:
        if self._buffered > 0:
            self.stats.write_ops += 1  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint
            self.stats.write_bytes += self._buffered  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint
            self.packed_flushes += 1
            self._buffered = 0
            self._epoch += 1

    def write_small(self, nbytes: int) -> None:
        if 0 < nbytes <= self.small_threshold:
            self._pack(int(nbytes))
        else:
            super().write_small(nbytes)  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint

    def write_clusters(self, cluster_ids: Iterable[int]) -> None:
        ids = sorted(set(int(c) for c in cluster_ids))
        if not ids:
            return
        for _start, length in _runs(ids):
            nbytes = length * self.cluster_size
            if nbytes <= self.small_threshold:
                self._pack(nbytes)
            else:
                self.stats.write_ops += 1  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint
                self.stats.write_bytes += nbytes  # repro-lint: allow(charge-accounting) port copy of the repro/core/io_sim.py chokepoint
