"""Durable on-disk storage backend for the easily updatable index set.

The paper's substrate organizes posting streams for cheap in-place
update; this package makes that substrate *durable*: a write-ahead part
log (:mod:`repro_torch.store.wal`) feeds the existing ``add_part`` path, CRC-
verified segment files (:mod:`repro_torch.store.segments`) checkpoint full
posting snapshots in lexicon+barrel style, and
:class:`~repro_torch.store.store.DurableIndexStore` ties them together with
crash recovery (torn WAL tails truncated, never a partially visible
part) and background compaction published as just another generation
advance.  Serving I/O stays on the simulated block devices, untouched —
see the :mod:`repro_torch.store.store` module docstring for why accounting
parity with the in-memory substrate is exact by construction.
"""

from repro_torch.store.segments import (
    SegmentCorruptError,
    read_segment,
    snapshot_state,
    write_segment,
)
from repro_torch.store.store import DurableIndexStore
from repro_torch.store.wal import (
    REC_COMPACT,
    REC_PART_MAPS,
    REC_PART_TOKENS,
    WriteAheadLog,
)

__all__ = [
    "DurableIndexStore",
    "WriteAheadLog",
    "SegmentCorruptError",
    "read_segment",
    "write_segment",
    "snapshot_state",
    "REC_PART_TOKENS",
    "REC_PART_MAPS",
    "REC_COMPACT",
]
