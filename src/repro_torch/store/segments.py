"""Segment files: the durable checkpoint format.

One segment file is a full posting snapshot of a (sharded) index set in
lexicon+barrel style — per index a *barrel* of self-contained varint
posting runs, addressed by an inline dictionary of (key, run) pairs —
laid out

    [u32 magic][u16 version][u16 n_shards]
    per shard:  [u16 n_indexes]
      per index: [u8 name_len][name][u32 n_keys]
        per key: [key codec][u32 run_len][varint posting run]
    [u32 crc32 of everything above]

The whole file is covered by the CRC trailer and published via
write-to-temp + fsync + atomic rename, so a reader either sees a
complete, verified snapshot or (on any mismatch) raises
:class:`SegmentCorruptError` and the store falls back to a full WAL
replay.  Snapshot extraction reads the in-memory substrate directly —
never through the simulated block devices — so writing a checkpoint
charges no search or build I/O.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path
from typing import Dict, Hashable, List

import numpy as np

from repro_torch.core.dictionary import K_EM, K_TAG
from repro_torch.core.postings import decode_postings
from repro_torch.store.format import decode_key, decode_run, encode_key, encode_run

SEG_MAGIC = 0x53454731  # "SEG1"
SEG_VERSION = 1

_HEAD = struct.Struct("<IHH")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")

# one shard's posting state: {index name → {key → (N, 2) postings}}
ShardState = Dict[str, Dict[Hashable, np.ndarray]]


class SegmentCorruptError(Exception):
    """The segment file failed its magic/structure/CRC verification."""


# -------------------------------------------------------------- snapshot --
def index_snapshot(index) -> Dict[Hashable, np.ndarray]:
    """Every key's full posting list, decoded straight from the
    in-memory substrate (dictionary-inline EM bytes, shared TAG buckets,
    dedicated streams) with NO device charges — checkpointing must not
    perturb the I/O accounting the benches and oracles measure."""
    out: Dict[Hashable, np.ndarray] = {}
    for key, e in index.dict.entries.items():
        if e.kind == K_EM:
            posts, _ = decode_postings(bytes(e.data))
        else:
            data = bytes(index.mgr.streams[e.sid].data)
            if e.kind == K_TAG:
                posts, tags = decode_postings(data, tagged=True, zigzag=True)
                mine = posts[tags == e.tag]
                posts = mine[np.lexsort((mine[:, 1], mine[:, 0]))]
            else:
                posts, _ = decode_postings(data)
        if posts.shape[0]:
            out[key] = posts
    return out


def snapshot_state(index_set) -> List[ShardState]:
    """Per-shard posting snapshot of a sharded (or single) index set."""
    shards = getattr(index_set, "shards", None) or [index_set]
    return [
        {name: index_snapshot(idx) for name, idx in shard.indexes.items()}
        for shard in shards
    ]


# --------------------------------------------------------------- file io --
def write_segment(path, state: List[ShardState]) -> int:
    """Serialize + publish one segment file atomically; returns its size."""
    body = bytearray(_HEAD.pack(SEG_MAGIC, SEG_VERSION, len(state)))
    for shard_state in state:
        body += _U16.pack(len(shard_state))
        for name, by_key in shard_state.items():
            nb = name.encode("utf-8")
            body += struct.pack("<B", len(nb)) + nb
            body += _U32.pack(len(by_key))
            for key, posts in by_key.items():
                body += encode_key(key)
                body += encode_run(posts)
    body += _U32.pack(zlib.crc32(bytes(body)) & 0xFFFFFFFF)
    path = Path(path)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as fh:
        fh.write(body)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return len(body)


def read_segment(path) -> List[ShardState]:
    """Load + verify one segment file; raises :class:`SegmentCorruptError`
    on any structural or checksum mismatch (including a truncated tail)."""
    try:
        data = Path(path).read_bytes()
    except OSError as exc:
        raise SegmentCorruptError(f"unreadable segment {path}: {exc}") from exc
    if len(data) < _HEAD.size + _U32.size:
        raise SegmentCorruptError(f"segment {path} too short ({len(data)} B)")
    (crc,) = _U32.unpack_from(data, len(data) - _U32.size)
    body = data[: -_U32.size]
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise SegmentCorruptError(f"segment {path} failed CRC")
    magic, version, n_shards = _HEAD.unpack_from(body, 0)
    if magic != SEG_MAGIC or version != SEG_VERSION:
        raise SegmentCorruptError(
            f"segment {path} bad magic/version {magic:#x}/{version}"
        )
    off = _HEAD.size
    try:
        state: List[ShardState] = []
        for _ in range(n_shards):
            (n_indexes,) = _U16.unpack_from(body, off)
            off += _U16.size
            shard_state: ShardState = {}
            for _ in range(n_indexes):
                ln = body[off]
                off += 1
                name = bytes(body[off : off + ln]).decode("utf-8")
                off += ln
                (n_keys,) = _U32.unpack_from(body, off)
                off += _U32.size
                by_key: Dict[Hashable, np.ndarray] = {}
                for _ in range(n_keys):
                    key, off = decode_key(body, off)
                    posts, off = decode_run(body, off)
                    by_key[key] = posts
                shard_state[name] = by_key
            state.append(shard_state)
    except (struct.error, IndexError, ValueError) as exc:
        raise SegmentCorruptError(f"segment {path} malformed: {exc}") from exc
    if off != len(body):
        raise SegmentCorruptError(
            f"segment {path} trailing garbage ({len(body) - off} B)"
        )
    return state
