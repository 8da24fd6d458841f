"""Sharded index substrate: N per-shard :class:`TextIndexSet` partitions.

The paper's easily updatable index is built for a growing collection;
serving production traffic additionally needs the collection *partitioned*
so shards can be fetched (and eventually updated and replicated)
independently.  :class:`ShardedTextIndexSet` partitions documents by a
multiplicative hash of the doc id across ``n_shards`` full
:class:`~repro_torch.core.text_index.TextIndexSet` substrates:

  * every shard owns complete build/search/dictionary devices, so the
    paper's I/O tables report **per shard and in aggregate** (the
    ``*_per_shard`` variants vs the merged defaults);
  * postings keep their **global** doc ids — a shard stores the doc-subset
    of every key's posting list, sorted by (doc, pos) exactly like the
    unsharded list.  Document-hash sharding therefore preserves the
    property all four planner routes rely on: per-key posting fetches are
    independent across documents, so a whole-set lookup is the disjoint
    union of per-shard lookups and gathers **losslessly** by merge;
  * extraction runs ONCE per part (same vectorized pass as unsharded) and
    the resulting posting maps are scattered row-wise by doc hash, so a
    sharded build indexes byte-for-byte the same postings as an unsharded
    one.

The read side lives in :mod:`repro_torch.search.reader`
(``ShardedIndexSetReader``) and :mod:`repro_torch.search.service` (the
plan → scatter-fetch → join → gather pipeline).
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional

import numpy as np

from repro_torch.core.inverted_index import InvertedIndex
from repro_torch.core.io_sim import IOStats
from repro_torch.core.lexicon import Lexicon
from repro_torch.core.text_index import (
    MULTI_INDEX,
    IndexSetConfig,
    IndexSetLike,
    TextIndexSet,
)
from repro_torch.data.corpus import extract_postings

_EMPTY = np.zeros((0, 2), dtype=np.int64)

# Fibonacci multiplier (2^64 / phi, odd): a multiplicative mix so shard
# assignment is insensitive to doc-id striding (plain modulo would send
# every even doc of a 2-part collection to the same shard, say)
_MIX = 0x9E3779B97F4A7C15
_MASK64 = (1 << 64) - 1


def shard_of(doc_id: int, n_shards: int) -> int:
    """Shard owning one doc id (deterministic multiplicative hash)."""
    return int(((doc_id * _MIX) & _MASK64) >> 33) % n_shards


def shard_of_docs(doc_ids: np.ndarray, n_shards: int) -> np.ndarray:
    """Vectorized :func:`shard_of` over a doc-id column."""
    d = np.asarray(doc_ids).astype(np.uint64)
    mixed = (d * np.uint64(_MIX)) >> np.uint64(33)
    return (mixed % np.uint64(n_shards)).astype(np.int64)


def merge_io_reports(dicts: List[Dict[str, IOStats]]) -> Dict[str, IOStats]:
    """Fold per-shard {index name → IOStats} reports into one aggregate
    (the shared merge for set- and reader-side per-shard reporting)."""
    out: Dict[str, IOStats] = {}
    for d in dicts:
        for name, st in d.items():
            out[name] = out[name].merged(st) if name in out else st
    return out


def merge_shard_postings(arrs: List[np.ndarray]) -> np.ndarray:
    """Gather per-shard (N,2) posting/witness arrays into the unsharded
    order.

    Shard doc sets are disjoint and each per-shard array is the
    (doc, pos)-ordered subsequence of the unsharded array, so a STABLE
    sort on the doc column alone reconstructs the unsharded array
    element-wise (within-doc row order is preserved from the owning
    shard)."""
    arrs = [a for a in arrs if a.shape[0]]
    if not arrs:
        return _EMPTY
    if len(arrs) == 1:
        return arrs[0]
    cat = np.concatenate(arrs, axis=0)
    return cat[np.argsort(cat[:, 0], kind="stable")]


def merge_shard_chunks(chunk_runs: List[List[np.ndarray]]) -> np.ndarray:
    """Gather per-shard lazy-cursor chunk runs into unsharded (doc, pos)
    order — the scatter/gather-aware merge of the streaming top-k stage.

    Each inner list is the chunks ONE shard's cursor has delivered so
    far; their concatenation is a (doc, pos)-sorted run (sequential
    slices of that shard's posting list), and the runs merge across
    shards exactly like :func:`merge_shard_postings`: shard doc sets are
    disjoint, so a stable sort on the doc column reconstructs the
    unsharded prefix element-wise."""
    runs: List[np.ndarray] = []
    for chunks in chunk_runs:
        chunks = [c for c in chunks if c.shape[0]]
        if not chunks:
            continue
        runs.append(
            chunks[0] if len(chunks) == 1 else np.concatenate(chunks, axis=0)
        )
    return merge_shard_postings(runs)


class UpdateStream:
    """Independent live-update applier for ONE shard.

    The paper's defining property — in-place updatability — lifted to the
    sharded substrate: every shard owns an update stream that applies
    collection parts to that shard alone, so shards advance
    independently (a part whose documents all hash elsewhere never
    touches this shard, and a deployment can drain per-shard queues at
    different rates).  Each applied part:

      * runs ``add_part`` only on the indexes that actually received
        rows (an untouched index's generation stays put — its readers
        keep every cached posting);
      * bumps the shard's generation (derived from the per-index
        ``n_parts`` counters, so direct index writes are never missed);
      * publishes the part's *touched-key digest* — the exact
        ``{index → keys}`` set whose posting lists changed — which
        readers use to invalidate only the affected (shard, index, key)
        cache entries instead of dropping whole namespaces.
    """

    def __init__(self, shard_id: int, index_set):
        self.shard_id = int(shard_id)
        self.index_set = index_set
        self.parts_applied = 0
        self.rows_applied = 0
        self.compactions_applied = 0

    @property
    def generation(self) -> int:
        """This shard's scalar snapshot generation (see
        :attr:`~repro_torch.core.text_index.TextIndexSet.generation`)."""
        return self.index_set.generation

    def generation_vector(self) -> List[int]:
        """This shard's per-index published generation vector — the
        alias-free snapshot coordinate replicas subscribe against."""
        return self.index_set.generation_vector()

    def digests_since(
        self, generation_vector: List[int]
    ) -> Optional[Dict[str, List[frozenset]]]:
        """Shard-level digest-stream subscription: the touched-key
        digests every index published after the subscriber's pinned
        per-index ``generation_vector``, as ``{index_name: [digest,
        ...]}`` (current indexes omitted).  ``None`` when ANY index's
        bounded history no longer reaches back that far — the subscriber
        must then take the whole-namespace catch-up path for the shard.
        This is the writer-side surface :class:`repro.search.replica.
        ReplicaReader` consumes."""
        names = list(self.index_set.indexes)
        if len(generation_vector) != len(names):
            return None
        out: Dict[str, List[frozenset]] = {}
        for name, gen in zip(names, generation_vector):
            digests = self.index_set.indexes[name].digests_since(gen)
            if digests is None:
                return None
            if digests:
                out[name] = digests
        return out

    def apply(self, maps) -> Dict[str, frozenset]:
        """Apply one scattered part to this shard; returns its
        touched-key digest (empty when the part carried no rows for the
        shard — in which case nothing, including the generation, moved)."""
        rows = sum(
            arr.shape[0] for by_key in maps.values() for arr in by_key.values()
        )
        digest = self.index_set.apply_part_maps(maps) if rows else {}
        if digest:
            self.parts_applied += 1
            self.rows_applied += rows
        return digest

    def compact(self) -> Dict[str, frozenset]:
        """One background-compaction cycle on this shard alone —
        published through the shard's generation/digest machinery like
        any other part (see :meth:`TextIndexSet.compact`).  Shards
        compact independently, exactly as they update independently."""
        digest = self.index_set.compact()
        if digest:
            self.compactions_applied += 1
        return digest


class ShardedTextIndexSet(IndexSetLike):
    """N document-hash shards, each a full :class:`TextIndexSet`."""

    def __init__(
        self,
        cfg: IndexSetConfig,
        lexicon: Lexicon,
        n_shards: int = 4,
        seed: int = 0,
    ):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.cfg = cfg
        self.lexicon = lexicon
        self.n_shards = int(n_shards)
        # identical seed per shard: dictionaries group keys identically, so
        # one shard-agnostic planner group_of serves the whole set
        self.shards: List[TextIndexSet] = [
            TextIndexSet(cfg, lexicon, seed=seed) for _ in range(n_shards)
        ]
        for s, shard in enumerate(self.shards):
            for idx in shard.indexes.values():
                idx.mgr.device.name = f"s{s}/{idx.mgr.device.name}"
            for dev in list(shard.dict_devices.values()) + list(
                shard.search_devices.values()
            ):
                dev.name = f"s{s}/{dev.name}"
        # one independent live-update stream per shard: `add_documents` is
        # the all-shards convenience path; callers that replay per-shard
        # queues drive `update_streams[s].apply(...)` directly
        self.update_streams: List[UpdateStream] = [
            UpdateStream(s, shard) for s, shard in enumerate(self.shards)
        ]

    # the planner/service capability view: all shards share index kinds,
    # key packing and multi_k, so shard 0 answers every capability question
    @property
    def indexes(self) -> Dict[str, InvertedIndex]:
        return self.shards[0].indexes

    # ------------------------------------------------------------- building --
    def add_documents(
        self, tokens: np.ndarray, offsets: np.ndarray, doc0: int
    ) -> None:
        """Index one collection part: extract once, scatter rows by doc
        hash, run each touched shard's update stream."""
        maps = extract_postings(
            self.lexicon, tokens, offsets, doc0, self.cfg.max_distance
        )
        if MULTI_INDEX in self.indexes:
            maps[MULTI_INDEX] = self.indexes[MULTI_INDEX].extract_part(
                self.lexicon, tokens, offsets, doc0
            )
        self.apply_part_maps(maps)

    def apply_part_maps(
        self, maps: Dict[str, Dict[Hashable, np.ndarray]]
    ) -> List[Dict[str, frozenset]]:
        """Scatter one whole-set extracted part by doc hash and run each
        touched shard's update stream — the primitive under
        :meth:`add_documents`, also driven directly by callers replaying
        a durable part log (``repro.store``).  Returns the per-shard
        touched-key digests (empty dict for untouched shards)."""
        if self.n_shards == 1:
            return [self.update_streams[0].apply(maps)]
        shard_maps: List[Dict[str, Dict[Hashable, np.ndarray]]] = [
            {name: {} for name in maps} for _ in range(self.n_shards)
        ]
        for name, by_key in maps.items():
            for key, arr in by_key.items():
                owner = shard_of_docs(arr[:, 0], self.n_shards)
                for s in range(self.n_shards):
                    rows = arr[owner == s]
                    if rows.size:
                        shard_maps[s][name][key] = rows
        # each shard's update stream applies ONLY what hashed to it: a
        # shard that received zero rows for this part keeps its
        # generation (previously every shard's every index got an
        # `add_part` call, bumping generations and forcing needless full
        # cache drops on untouched shards)
        return [
            self.update_streams[s].apply(shard_maps[s])
            for s in range(self.n_shards)
        ]

    def compact(self) -> List[Dict[str, frozenset]]:
        """One background-compaction cycle, every shard: each shard
        folds its scattered streams and publishes its own generation
        advance + digest (untouched shards publish nothing)."""
        return [us.compact() for us in self.update_streams]

    def compaction_stats(self) -> Dict[str, int]:
        """Aggregate background-compaction counters across all shards."""
        agg = {"compactions": 0, "compacted_streams": 0}
        for shard in self.shards:
            for k, v in shard.compaction_stats().items():
                agg[k] += v
        return agg

    def generation_vector(self) -> List[List[int]]:
        """Per-shard *per-index* published generations — what a
        snapshot-consistent batch pins (see
        ``SearchService.last_trace['snapshot']``).  Nested rather than
        summed per shard: a sum aliases (one index advancing while
        another folds/restores can leave it unchanged), the vector
        cannot."""
        return [shard.generation_vector() for shard in self.shards]

    # -------------------------------------------------------------- queries --
    def lookup(self, index_name: str, key: Hashable) -> np.ndarray:
        """Whole-set lookup: scatter to every shard, gather by merge."""
        return merge_shard_postings(
            [shard.lookup(index_name, key) for shard in self.shards]
        )

    def reader(self, cache_bytes: int = 8 << 20, targeted: bool = True):
        """Per-shard readers behind ONE byte-budgeted posting cache
        (namespaced by (shard, index, key) — see ``repro_torch.search.reader``)."""
        from repro_torch.search.reader import ShardedIndexSetReader

        return ShardedIndexSetReader(self, cache_bytes=cache_bytes,
                                     targeted=targeted)

    # -------------------------------------------------------------- reports --
    def build_io_per_shard(self) -> List[Dict[str, IOStats]]:
        return [shard.build_io() for shard in self.shards]

    def build_io(self) -> Dict[str, IOStats]:
        return merge_io_reports(self.build_io_per_shard())

    def search_io_per_shard(self) -> List[Dict[str, IOStats]]:
        return [shard.search_io() for shard in self.shards]

    def search_io(self) -> Dict[str, IOStats]:
        return merge_io_reports(self.search_io_per_shard())

    def table_rows_per_shard(self) -> List[Dict[str, Dict[str, int]]]:
        return [shard.table_rows() for shard in self.shards]

    def table_rows(self) -> Dict[str, Dict[str, int]]:
        rows: Dict[str, Dict[str, int]] = {}
        for shard_rows in self.table_rows_per_shard():
            for name, row in shard_rows.items():
                agg = rows.setdefault(name, {k: 0 for k in row})
                for k, v in row.items():
                    agg[k] += v
        return rows

    def census(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for shard in self.shards:
            for name, counters in shard.census().items():
                agg = out.setdefault(name, {})
                for k, v in counters.items():
                    agg[k] = agg.get(k, 0) + v
        return out
