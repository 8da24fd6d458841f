"""The write-ahead part log.

Every mutation of a durable index set lands here BEFORE it is applied to
the serving substrate, so each applied part is on disk before its
generation advances (the publish point IS the WAL append).  Records are
framed

    [u32 magic][u8 type][u32 payload_len][u32 crc32(payload)][payload]

and recovery scans the file front to back: the first frame whose magic,
length or CRC fails — a torn tail from a crash mid-append — ends the
scan, and the file is truncated there so a partially written part is
never visible, not even partially.  Everything before the tear replays
byte-identically.

Record types:

  * ``REC_PART_TOKENS`` — one collection part as the raw token stream
    (re-extracted on replay, so replay takes the exact ``add_documents``
    path the live write took);
  * ``REC_PART_MAPS``   — one pre-extracted part map (the per-shard
    queue shape of the update streams);
  * ``REC_COMPACT``     — a background-compaction cycle marker: replay
    re-runs the cycle at the same point in the part sequence, so a
    replayed substrate reproduces the live one's physical layout (and
    therefore its I/O charges) exactly.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path
from typing import List, Tuple

WAL_MAGIC = 0x57414C31  # "WAL1"

REC_PART_TOKENS = 1
REC_PART_MAPS = 2
REC_COMPACT = 3

_HEADER = struct.Struct("<IBII")
HEADER_BYTES = _HEADER.size


class WriteAheadLog:
    def __init__(self, path, fsync: bool = True):
        self.path = Path(path)
        self.fsync = bool(fsync)
        self._f = open(self.path, "ab")
        self._end = self.path.stat().st_size
        self.appends = 0
        self.synced = 0

    # ------------------------------------------------------------ writing --
    def append(self, rec_type: int, payload: bytes) -> int:
        """Durably append one record; returns the file offset after it.
        The record is on disk (fsynced when enabled) when this returns —
        callers apply the mutation to the serving substrate only after."""
        frame = _HEADER.pack(
            WAL_MAGIC, rec_type, len(payload), zlib.crc32(payload) & 0xFFFFFFFF
        )
        self._f.write(frame + payload)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
            self.synced += 1
        self.appends += 1
        self._end += HEADER_BYTES + len(payload)
        return self._end

    def tell(self) -> int:
        return self._end

    def size(self) -> int:
        try:
            return self.path.stat().st_size
        except OSError:
            return 0

    # ----------------------------------------------------------- recovery --
    def recover(self, start: int = 0) -> Tuple[List[Tuple[int, bytes]], int, bool]:
        """Scan records from ``start``; truncate any torn tail.

        Returns ``(records, good_offset, torn)``: the intact records in
        order, the offset the file was left at, and whether anything had
        to be discarded.  ``start`` beyond the physical end (the file
        lost bytes a checkpoint already folded — e.g. an external
        truncation) yields no records and reports ``torn`` so the owner
        can re-publish a consistent checkpoint."""
        records, off, torn = self.read_from(start)
        if torn and off < self.size():
            # drop the tear: O_APPEND writes land at the new end, so the
            # already-open append handle stays valid
            with open(self.path, "rb+") as fh:
                fh.truncate(off)
        self._end = off
        return records, off, torn

    def read_from(self, start: int = 0) -> Tuple[List[Tuple[int, bytes]], int, bool]:
        """Non-destructive scan: the intact records from ``start`` and the
        offset after the last one, WITHOUT truncating a torn tail.

        This is the replica polling surface — a read replica tails a
        LIVE primary's log, where an apparent tear may simply be a frame
        the primary is mid-append on; truncating would corrupt the
        owner.  The owner's :meth:`recover` is the destructive variant."""
        try:
            data = self.path.read_bytes()
        except OSError:
            data = b""
        size = len(data)
        if start > size:
            return [], size, True
        records: List[Tuple[int, bytes]] = []
        off = start
        while off < size:
            if off + HEADER_BYTES > size:
                break
            magic, rtype, ln, crc = _HEADER.unpack_from(data, off)
            if magic != WAL_MAGIC or off + HEADER_BYTES + ln > size:
                break
            payload = data[off + HEADER_BYTES : off + HEADER_BYTES + ln]
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                break
            records.append((rtype, payload))
            off += HEADER_BYTES + ln
        return records, off, off < size

    def close(self) -> None:
        self._f.close()
