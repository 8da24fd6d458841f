"""``DurableIndexStore`` — the durable on-disk backend for an index set.

Layering (and why byte-accounting parity is exact by construction):

  * *Serving* stays on the existing easily updatable substrate — a
    :class:`~repro_torch.core.sharded_set.ShardedTextIndexSet` whose
    ``StreamManager``/``InvertedIndex`` machinery charges every search
    and build operation to the simulated block devices, exactly as
    before.  The store never routes a read or write through those
    devices, so every oracle and bench observes identical charges
    against a durable store and a plain in-memory set driven through
    the same operations.
  * *Durability* is real file I/O beside it: each mutation is appended
    to the WAL (fsynced) BEFORE it is applied, checkpoints serialize
    the full posting state into a CRC-verified segment file, and a
    MANIFEST published by atomic rename names the live (segment,
    WAL offset) pair.

Directory layout under ``path``::

    wal.log                   the write-ahead part log
    segments/ckpt-<seq>.seg   posting snapshots (latest is live)
    MANIFEST                  JSON {seq, segment, wal_offset,
                              generation_vector, n_shards}

Recovery state machine (``recovery="checkpoint"``, the default)::

    DISCOVER --------- manifest readable? segment verifies? ----+
       | yes: LOAD_CHECKPOINT (bulk-apply per-shard snapshots)  |
       | no/corrupt: FULL_REPLAY (fresh substrate, WAL offset 0)|
       v                                                        v
    REPLAY_TAIL  -- apply intact WAL records after the folded offset;
       |            first bad frame ends the scan, file truncated there
       v            (a torn part is never visible, not even partially)
    REPAIR       -- if the WAL physically lost folded bytes or the
       |            checkpoint was corrupt, publish a fresh checkpoint
       v            so the (manifest, WAL) invariant holds again
    SERVE

``recovery="replay"`` ignores the checkpoint and replays the entire WAL
— including ``REC_COMPACT`` markers, which re-run background compaction
at the same point in the part sequence — so the reopened substrate
reproduces the crashed one's physical stream layout, and therefore its
simulated I/O charges, byte for byte.  That is the mode the storage
oracle pins parity with; checkpoint recovery trades that layout identity
for O(state) + O(tail) reopen time while serving identical results.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Hashable, List, Optional

import numpy as np

from repro_torch.core.io_sim import IOStats
from repro_torch.core.lexicon import Lexicon
from repro_torch.core.sharded_set import ShardedTextIndexSet
from repro_torch.core.text_index import IndexSetConfig
from repro_torch.store.format import (
    decode_part_maps,
    decode_part_tokens,
    encode_part_maps,
    encode_part_tokens,
)
from repro_torch.store.segments import (
    SegmentCorruptError,
    read_segment,
    snapshot_state,
    write_segment,
)
from repro_torch.store.wal import (
    REC_COMPACT,
    REC_PART_MAPS,
    REC_PART_TOKENS,
    WriteAheadLog,
)

MANIFEST_NAME = "MANIFEST"


class DurableIndexStore:
    """A WAL-fed, checkpointed, crash-recoverable index set.

    Exposes the :class:`~repro_torch.core.text_index.IndexSetLike` capability
    surface (``add_documents`` / ``lookup`` / ``reader`` / the report
    methods), so ``SearchService``, the oracles and every bench drive it
    exactly like the substrate it wraps."""

    def __init__(
        self,
        path,
        cfg: IndexSetConfig,
        lexicon: Lexicon,
        n_shards: int = 1,
        seed: int = 0,
        fsync: bool = True,
        recovery: str = "checkpoint",
        replica: bool = False,
    ):
        if recovery not in ("checkpoint", "replay"):
            raise ValueError(f"unknown recovery mode {recovery!r}")
        self.path = Path(path)
        self.cfg = cfg
        self.lexicon = lexicon
        self.n_shards = int(n_shards)
        self.seed = int(seed)
        # replica mode: a READ-ONLY reopen of a (possibly live) primary's
        # directory — mutations raise, recovery never truncates the
        # primary's WAL, and ``poll()`` tails records the primary appends
        self.replica = bool(replica)
        (self.path / "segments").mkdir(parents=True, exist_ok=True)
        self.set = self._fresh_set()
        self.wal = WriteAheadLog(self.path / "wal.log",
                                 fsync=fsync and not self.replica)
        self.n_checkpoints = 0
        self._parts_since_ckpt = 0
        self._ckpt_seq = 0
        self._wal_pos = 0
        self.recovery_info: Dict[str, object] = {}
        self._recover(recovery)

    @classmethod
    def open_replica(cls, path, cfg, lexicon, n_shards: int = 1,
                     seed: int = 0) -> "DurableIndexStore":
        """Reopen a primary's directory as a read replica: bulk-load the
        checkpoint, restore the manifest's published generation vector
        (so the replica's snapshot coordinates align with the primary's
        — physical part counts collapse across the bulk apply and would
        alias), then tail the WAL.  ``poll()`` catches up with whatever
        the primary appended since."""
        return cls(path, cfg, lexicon, n_shards=n_shards, seed=seed,
                   fsync=False, recovery="checkpoint", replica=True)

    def _fresh_set(self) -> ShardedTextIndexSet:
        return ShardedTextIndexSet(
            self.cfg, self.lexicon, n_shards=self.n_shards, seed=self.seed
        )

    # ----------------------------------------------------------- recovery --
    def _load_manifest(self) -> Optional[dict]:
        try:
            return json.loads((self.path / MANIFEST_NAME).read_text())
        except (OSError, ValueError):
            return None

    def _recover(self, mode: str) -> None:
        info: Dict[str, object] = {
            "mode": mode,
            "from_checkpoint": False,
            "checkpoint_fallback": False,
            "wal_records": 0,
            "torn": False,
            "truncated_bytes": 0,
        }
        start = 0
        manifest = self._load_manifest() if mode == "checkpoint" else None
        if manifest is not None:
            try:
                state = read_segment(
                    self.path / "segments" / str(manifest["segment"])
                )
                for s, shard_state in enumerate(state):
                    if shard_state:
                        self.set.shards[s].apply_part_maps(shard_state)
                # the bulk apply collapsed many published parts into one
                # physical part per index — restore the manifest's
                # PUBLISHED generation vector so this store's snapshot
                # coordinates (and digest-stream positions) stay aligned
                # with the writer that produced the checkpoint
                self._restore_generations(manifest.get("generation_vector"))
                start = int(manifest["wal_offset"])
                self._ckpt_seq = int(manifest["seq"])
                info["from_checkpoint"] = True
            except (SegmentCorruptError, KeyError, IndexError, ValueError):
                # corrupt/missing checkpoint: fall back to a full replay
                self.set = self._fresh_set()
                start = 0
                info["checkpoint_fallback"] = True
        size_before = self.wal.size()
        if self.replica:
            # never truncate a live primary's log from a replica
            records, good, torn = self.wal.read_from(start)
        else:
            records, good, torn = self.wal.recover(start)
        for rec_type, payload in records:
            self._apply_record(rec_type, payload)
        self._wal_pos = good
        info["wal_records"] = len(records)
        info["torn"] = torn
        info["truncated_bytes"] = max(0, size_before - self.wal.size())
        self.recovery_info = info
        if mode == "checkpoint" and not self.replica and (
            info["checkpoint_fallback"] or start > size_before
        ):
            # the published (manifest, WAL) pair was inconsistent —
            # re-publish a checkpoint of the recovered state
            self._checkpoint()

    def _restore_generations(self, gens) -> None:
        """Forward the per-index published generation counters to the
        manifest's recorded vector (nested ``[shard][index]``)."""
        if not gens:
            return
        for shard, row in zip(self.set.shards, gens):
            if not isinstance(row, (list, tuple)):
                return  # pre-vector manifest: nothing restorable
            for idx, g in zip(shard.indexes.values(), row):
                idx.restore_generation(int(g))

    # ------------------------------------------------------- replica tail --
    def poll(self) -> int:
        """Replica catch-up: apply every WAL record the primary appended
        since this replica's position; returns how many were applied.
        The applied parts republish their touched-key digests locally,
        so the replica's own readers take the same targeted-invalidation
        path the primary's do."""
        if not self.replica:
            raise RuntimeError("poll() is the replica tailing surface; "
                               "the primary applies writes directly")
        records, good, _torn = self.wal.read_from(self._wal_pos)
        for rec_type, payload in records:
            self._apply_record(rec_type, payload)
        self._wal_pos = good
        return len(records)

    def _apply_record(self, rec_type: int, payload: bytes) -> None:
        if rec_type == REC_PART_TOKENS:
            doc0, tokens, offsets = decode_part_tokens(payload)
            self.set.add_documents(tokens, offsets, doc0)
        elif rec_type == REC_PART_MAPS:
            self.set.apply_part_maps(decode_part_maps(payload))
        elif rec_type == REC_COMPACT:
            self.set.compact()
        # unknown record types are skipped (forward compatibility)

    # ----------------------------------------------------------- updating --
    def add_documents(
        self, tokens: np.ndarray, offsets: np.ndarray, doc0: int
    ) -> None:
        """Index one collection part, durably: the raw token stream is
        in the WAL (fsynced when enabled) before any index generation
        advances."""
        self._require_primary()
        tokens = np.ascontiguousarray(tokens, dtype=np.int64)
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        self.wal.append(REC_PART_TOKENS, encode_part_tokens(doc0, tokens, offsets))
        self._parts_since_ckpt += 1
        self.set.add_documents(tokens, offsets, doc0)

    def apply_part_maps(
        self, maps: Dict[str, Dict[Hashable, np.ndarray]]
    ) -> List[Dict[str, frozenset]]:
        """Durably apply one pre-extracted part map (the per-shard
        update-queue shape); WAL first, substrate second."""
        self._require_primary()
        self.wal.append(REC_PART_MAPS, encode_part_maps(maps))
        self._parts_since_ckpt += 1
        return self.set.apply_part_maps(maps)

    def compact(self, checkpoint: bool = True) -> List[Dict[str, frozenset]]:
        """One background-compaction cycle, logged ahead like any part
        (replay re-runs it at the same point, reproducing the layout).
        By default a cycle that changed anything — or that has parts
        pending since the last checkpoint — also publishes a fresh
        segment + manifest, folding the WAL prefix into the checkpoint."""
        self._require_primary()
        self.wal.append(REC_COMPACT, b"")
        digests = self.set.compact()
        rewrote = any(bool(d) for d in digests)
        if checkpoint and (rewrote or self._parts_since_ckpt):
            self._checkpoint()
        return digests

    def checkpoint(self) -> None:
        """Publish the current state as a segment + manifest."""
        self._require_primary()
        self._checkpoint()

    def _require_primary(self) -> None:
        if self.replica:
            raise RuntimeError("read replica: single-owner writes happen "
                               "on the primary; replicas only poll()")

    def _checkpoint(self) -> None:
        self._ckpt_seq += 1
        name = f"ckpt-{self._ckpt_seq:06d}.seg"
        write_segment(self.path / "segments" / name, snapshot_state(self.set))
        manifest = {
            "seq": self._ckpt_seq,
            "segment": name,
            "wal_offset": self.wal.tell(),
            "generation_vector": self.set.generation_vector(),
            "n_shards": self.n_shards,
        }
        tmp = self.path / (MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as fh:
            fh.write(json.dumps(manifest))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path / MANIFEST_NAME)
        self._parts_since_ckpt = 0
        self.n_checkpoints += 1
        for old in (self.path / "segments").glob("ckpt-*.seg"):
            if old.name != name:
                try:
                    old.unlink()
                except OSError:
                    pass

    # --------------------------------------------- the IndexSetLike surface --
    @property
    def indexes(self):
        return self.set.indexes

    @property
    def shards(self):
        return self.set.shards

    @property
    def update_streams(self):
        return self.set.update_streams

    def lookup(self, index_name: str, key: Hashable) -> np.ndarray:
        return self.set.lookup(index_name, key)

    def reader(self, cache_bytes: int = 8 << 20, targeted: bool = True):
        return self.set.reader(cache_bytes=cache_bytes, targeted=targeted)

    def generation_vector(self) -> List[List[int]]:
        return self.set.generation_vector()

    def build_io(self) -> Dict[str, IOStats]:
        return self.set.build_io()

    def search_io(self) -> Dict[str, IOStats]:
        return self.set.search_io()

    def census(self) -> Dict[str, Dict[str, int]]:
        return self.set.census()

    def compaction_stats(self) -> Dict[str, int]:
        return self.set.compaction_stats()

    # -------------------------------------------------------------- admin --
    def stats(self) -> Dict[str, object]:
        return {
            "wal_bytes": self.wal.tell(),
            "wal_appends": self.wal.appends,
            "wal_syncs": self.wal.synced,
            "n_checkpoints": self.n_checkpoints,
            "parts_since_checkpoint": self._parts_since_ckpt,
            "recovery": dict(self.recovery_info),
            "compaction": self.compaction_stats(),
        }

    def close(self) -> None:
        self.wal.close()

    def __enter__(self) -> "DurableIndexStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
