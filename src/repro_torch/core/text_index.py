"""The paper's three index kinds over the easily updatable substrate
(sections 6.3-6.5).

``TextIndexSet`` maintains five measured inverted indexes (the rows of
Tables 2 and 3) plus an optional ``ordinary_all`` baseline index used only
by the search-speed experiment:

  known    — ordinary index, known lemmas
  unknown  — ordinary index, unknown words
  wv_kk    — extended (w, v), both known (w FREQUENT)
  wv_ku    — extended (w, v), v unknown
  stopseq  — stop-lemma sequences

plus (unless disabled via ``multi_k=None``) the follow-up work's
multi-component key index:

  multi    — sliding k-word lemma-tuple keys (:mod:`repro_torch.core.multi_key`),
             the planner's fourth route for phrase queries

Each index owns its own simulated block device, so construction I/O is
reported per index exactly like the paper's tables (the ``multi`` index
gets its own build/search accounting rows the same way).  Search I/O is
charged to a separate per-index device so build and search are never
conflated.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Dict, Hashable, List, Optional

import numpy as np

from repro_torch.core.inverted_index import InvertedIndex
from repro_torch.core.io_sim import BlockDevice, IOStats, PackedWriteDevice
from repro_torch.core.lexicon import Lexicon
from repro_torch.core.multi_key import MultiKeyIndex
from repro_torch.core.strategies import StrategyConfig
from repro_torch.data.corpus import extract_postings

INDEX_NAMES = ("known", "unknown", "wv_kk", "wv_ku", "stopseq")
MULTI_INDEX = "multi"

# paper Table 1: 243 known-lemma groups, 96 unknown groups (full scale);
# scaled defaults keep phase counts proportional at CI corpus sizes.
DEFAULT_GROUPS = {
    "known": 24,
    "unknown": 10,
    "wv_kk": 32,
    "wv_ku": 16,
    "stopseq": 8,
    "multi": 24,
    "ordinary_all": 24,
}


@dataclasses.dataclass
class IndexSetConfig:
    strategy: StrategyConfig = dataclasses.field(default_factory=StrategyConfig.set1)
    max_distance: int = 3
    groups: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_GROUPS)
    )
    fl_area_clusters: int = 2048
    build_ordinary_all: bool = False
    # multi-component (k-word) key index: tuple width, or None to disable
    multi_k: Optional[int] = 3


class IndexSetLike(abc.ABC):
    """The capability surface the read stack (``repro_torch.search``) consumes.

    Both the single-substrate :class:`TextIndexSet` and the sharded
    :class:`~repro_torch.core.sharded_set.ShardedTextIndexSet` implement it, so
    every consumer — readers, planner glue, ``SearchService``, benchmarks —
    is substrate-agnostic.  Implementations expose:

      * ``cfg`` / ``lexicon``     — configuration and word classification,
      * ``indexes``               — a capability view mapping index name to
        an :class:`InvertedIndex` (for a sharded set this is one shard's
        view: every shard shares the same index kinds, key packing and
        ``multi_k``, which is all the planner reads from it),
      * ``add_documents``         — index one collection part in place,
      * ``lookup``                — whole-set posting lookup (merged across
        shards for a sharded set), charging search-device I/O,
      * ``reader()``              — the read-only snapshot view feeding
        :class:`~repro_torch.search.service.SearchService`,
      * ``build_io``/``search_io``/``census`` — the paper's I/O tables.
    """

    cfg: IndexSetConfig
    lexicon: Lexicon
    # index-name → writer view (shard-representative when sharded); an
    # attribute/property in implementations, not enforced as abstract so
    # TextIndexSet can keep it a plain instance dict
    indexes: Dict[str, InvertedIndex]

    @abc.abstractmethod
    def add_documents(
        self, tokens: np.ndarray, offsets: np.ndarray, doc0: int
    ) -> None:
        """Index one collection part (build or in-place update)."""

    @abc.abstractmethod
    def lookup(self, index_name: str, key: Hashable) -> np.ndarray:
        """Posting lookup charging I/O to search devices."""

    @abc.abstractmethod
    def reader(self, cache_bytes: int = 8 << 20, targeted: bool = True):
        """Read-only snapshot view with a posting-list LRU cache
        (``targeted=False`` reverts cache invalidation to whole-namespace
        drops — the benchmark baseline for the digest path)."""

    @abc.abstractmethod
    def build_io(self) -> Dict[str, IOStats]:
        """Construction I/O per index (aggregate when sharded)."""

    @abc.abstractmethod
    def search_io(self) -> Dict[str, IOStats]:
        """Search I/O per index (aggregate when sharded)."""

    @abc.abstractmethod
    def census(self) -> Dict[str, Dict[str, int]]:
        """Stream-state census per index (aggregate when sharded)."""


class TextIndexSet(IndexSetLike):
    def __init__(self, cfg: IndexSetConfig, lexicon: Lexicon, seed: int = 0):
        self.cfg = cfg
        self.lexicon = lexicon
        names = list(INDEX_NAMES) + (
            [MULTI_INDEX] if cfg.multi_k is not None else []
        ) + (
            ["ordinary_all"] if cfg.build_ordinary_all else []
        )
        self.indexes: Dict[str, InvertedIndex] = {}
        self.search_devices: Dict[str, BlockDevice] = {}
        self.dict_devices: Dict[str, BlockDevice] = {}
        s = cfg.strategy
        for name in names:
            if s.use_ds:
                dev = PackedWriteDevice(
                    cluster_size=s.cluster_size,
                    small_threshold=s.ds_small_threshold,
                    buffer_size=s.ds_buffer_size,
                    name=name,
                )
            else:
                dev = BlockDevice(cluster_size=s.cluster_size, name=name)
            dict_dev = BlockDevice(cluster_size=s.cluster_size, name=f"{name}-dict")
            common = dict(
                n_groups=cfg.groups.get(name, 16),
                name=name,
                fl_area_clusters=cfg.fl_area_clusters,
                seed=seed,
                dict_device=dict_dev,
            )
            if name == MULTI_INDEX:
                self.indexes[name] = MultiKeyIndex.for_lexicon(
                    s, dev, lexicon, k=cfg.multi_k, **common
                )
            else:
                self.indexes[name] = InvertedIndex(s, dev, **common)
            self.dict_devices[name] = dict_dev
            self.search_devices[name] = BlockDevice(
                cluster_size=s.cluster_size, name=f"{name}-search"
            )

    # ------------------------------------------------------------- building --
    def add_documents(
        self, tokens: np.ndarray, offsets: np.ndarray, doc0: int
    ) -> None:
        """Index one collection part (build or in-place update)."""
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
    ) -> Dict[str, frozenset]:
        """Apply one extracted part to every index that received rows.

        The live-update primitive beneath :meth:`add_documents` (and the
        per-shard :class:`~repro_torch.core.sharded_set.UpdateStream`): indexes
        whose map is empty for this part are NOT touched — their
        generation (``n_parts``) stays put, so readers keep their cached
        postings for those indexes.  Returns the part's touched-key
        digest ``{index name → frozenset of changed keys}`` (empty maps
        omitted), which is also what each index published to its own
        digest history."""
        digest: Dict[str, frozenset] = {}
        for name, index in self.indexes.items():
            by_key = maps.get(name)
            if not by_key:
                continue
            touched = index.add_part(by_key)
            if touched is not None:
                digest[name] = touched
        return digest

    def compact(self) -> Dict[str, frozenset]:
        """One background-compaction cycle across every index.

        Indexes that rewrote nothing are left untouched (no generation
        bump, no digest) — the same no-op rule as an empty part.
        Returns ``{index name → touched-key digest}``, empty cycles
        omitted; the shape :meth:`apply_part_maps` returns, because to
        the read stack a compaction IS just another part."""
        digest: Dict[str, frozenset] = {}
        for name, index in self.indexes.items():
            touched = index.compact()
            if touched is not None:
                digest[name] = touched
        return digest

    def compaction_stats(self) -> Dict[str, int]:
        """Aggregate background-compaction counters across the set."""
        return {
            "compactions": sum(
                i.n_compactions for i in self.indexes.values()
            ),
            "compacted_streams": sum(
                i.compacted_streams for i in self.indexes.values()
            ),
        }

    @property
    def generation(self) -> int:
        """Monotone scalar snapshot counter: the sum of every index's
        *published* generation.  Moves exactly when some reader's view
        of this set could have changed.  Sums alias (two different
        per-index states can share one sum), so snapshot pinning and the
        replica catch-up protocol use :meth:`generation_vector`; the
        scalar survives as a cheap change signal."""
        return sum(idx.generation for idx in self.indexes.values())

    def generation_vector(self) -> List[int]:
        """Per-index published generations, in index declaration order —
        the alias-free form of :attr:`generation`.  One index advancing
        while another restores/folds can leave the *sum* unchanged; the
        vector distinguishes which index moved, so readers pin batches
        and replicas negotiate catch-up against it."""
        return [idx.generation for idx in self.indexes.values()]

    # -------------------------------------------------------------- queries --
    def lookup(self, index_name: str, key: Hashable) -> np.ndarray:
        """Posting lookup charging I/O to the per-index *search* device."""
        index = self.indexes[index_name]
        return index.lookup(key, device=self.search_devices[index_name])

    def reader(self, cache_bytes: int = 8 << 20, targeted: bool = True):
        """Read-only snapshot view with a posting-list LRU cache (the
        reader/planner/executor stack lives in :mod:`repro_torch.search`)."""
        from repro_torch.search.reader import IndexSetReader

        return IndexSetReader(self, cache_bytes=cache_bytes,
                              targeted=targeted)

    # -------------------------------------------------------------- reports --
    def build_io(self) -> Dict[str, IOStats]:
        return {
            name: idx.mgr.device.stats.snapshot()
            for name, idx in self.indexes.items()
        }

    def search_io(self) -> Dict[str, IOStats]:
        return {
            name: dev.stats.snapshot() for name, dev in self.search_devices.items()
        }

    def table_rows(self) -> Dict[str, Dict[str, int]]:
        """Tables 2 and 3 rows: per measured index, bytes and ops."""
        rows = {}
        for name in INDEX_NAMES:
            st = self.indexes[name].mgr.device.stats
            rows[name] = {
                "total_bytes": st.total_bytes,
                "total_ops": st.total_ops,
                "read_bytes": st.read_bytes,
                "write_bytes": st.write_bytes,
                "read_ops": st.read_ops,
                "write_ops": st.write_ops,
            }
        return rows

    def census(self) -> Dict[str, Dict[str, int]]:
        return {name: idx.mgr.state_census() for name, idx in self.indexes.items()}
