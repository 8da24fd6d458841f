"""Paged KV-cache manager: the paper's allocator, adapted to TPU serving
(DESIGN.md section 2).

Correspondence:
  cluster            <-> KV page (``page_size`` tokens)
  stream of clusters <-> one sequence's cache
  CH bounded chain   <-> bounded page-table indirection: a sequence's
                         pages may live in at most ``chain_limit``
                         physically-contiguous RUNS; the attention
                         kernel's gather depth is bounded (paper 5.7.3)
  CH->S conversion   <-> defragmentation: when a sequence exceeds the
                         run limit its pages are re-allocated as ONE
                         contiguous segment (sequential DMA reads)
  SR tail buffer     <-> write-combining: appended tokens accumulate in
                         a host-side tail buffer; only FULL pages are
                         published to the chain, so a page is never
                         re-read for modification
  free-clusters list <-> page free list with extent coalescing

The manager is pure bookkeeping (host side): it returns block tables for
``repro_torch.kernels.paged_attention`` and measures fragmentation, compaction
traffic and gather depth — the serving-side reproduction of the paper's
I/O accounting.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cluster_store import ExtentAllocator


@dataclasses.dataclass
class SeqState:
    seq_id: int
    length: int = 0                 # committed tokens (in published pages)
    tail: int = 0                   # tokens in the SR write-combining buffer
    runs: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    compactions: int = 0


@dataclasses.dataclass
class PagedKVStats:
    pages_allocated: int = 0
    pages_freed: int = 0
    compactions: int = 0
    compaction_pages_moved: int = 0
    max_gather_depth: int = 0


class PagedKVManager:
    def __init__(
        self,
        n_pages: int,
        page_size: int = 128,
        chain_limit: int = 9,
        contiguous_grow: int = 2,   # S-strategy: try to grow runs in place
    ):
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.chain_limit = int(chain_limit)
        self.contiguous_grow = int(contiguous_grow)
        self.alloc = ExtentAllocator(initial_clusters=n_pages)
        self.seqs: Dict[int, SeqState] = {}
        self.stats = PagedKVStats()

    # ------------------------------------------------------------ lifecycle --
    def new_sequence(self, seq_id: int) -> SeqState:
        assert seq_id not in self.seqs
        st = SeqState(seq_id)
        self.seqs[seq_id] = st
        return st

    def free_sequence(self, seq_id: int) -> None:
        st = self.seqs.pop(seq_id)
        for start, length in st.runs:
            self.alloc.free(start, length)
            self.stats.pages_freed += length

    def append_tokens(self, seq_id: int, n: int) -> None:
        """SR semantics: tokens land in the tail buffer; full pages are
        published into the chain (never re-read, never re-written)."""
        st = self.seqs[seq_id]
        st.tail += n
        while st.tail >= self.page_size:
            self._publish_page(st)
            st.tail -= self.page_size
            st.length += self.page_size

    def _publish_page(self, st: SeqState) -> None:
        # S-strategy: extend the last run in place when the next physical
        # page is free (contiguity first)
        if st.runs:
            start, length = st.runs[-1]
            got = self._try_extend(start + length)
            if got:
                st.runs[-1] = (start, length + 1)
                self.stats.pages_allocated += 1
                self._check_chain(st)
                return
        start = self.alloc.alloc(1)
        self.stats.pages_allocated += 1
        if st.runs and st.runs[-1][0] + st.runs[-1][1] == start:
            st.runs[-1] = (st.runs[-1][0], st.runs[-1][1] + 1)
        else:
            st.runs.append((start, 1))
        self._check_chain(st)

    def _try_extend(self, page: int) -> bool:
        """Claim a specific free page id (in-place growth)."""
        for i, (s, l) in enumerate(self.alloc._free):
            if s <= page < s + l:
                if s == page:
                    if l == 1:
                        self.alloc._free.pop(i)
                    else:
                        self.alloc._free[i] = (s + 1, l - 1)
                    return True
                return False
        return False

    def _check_chain(self, st: SeqState) -> None:
        """CH limit (5.7.3): too many runs -> compact to one segment.
        The conversion happens inside the append, so a *reader* never
        observes more than ``chain_limit`` runs; the max-depth stat is
        recorded post-compaction accordingly."""
        if len(st.runs) > self.chain_limit:
            total = sum(l for _, l in st.runs)
            old = list(st.runs)
            # free first so the allocator can re-use the old extents
            for s, l in old:
                self.alloc.free(s, l)
            start = self.alloc.alloc(total)
            st.runs = [(start, total)]
            st.compactions += 1
            self.stats.compactions += 1
            self.stats.compaction_pages_moved += total
        self.stats.max_gather_depth = max(
            self.stats.max_gather_depth, len(st.runs)
        )

    # -------------------------------------------------------------- queries --
    def gather_depth(self, seq_id: int) -> int:
        """Discontiguous runs the attention gather must touch (== the
        paper's per-search I/O op count)."""
        return len(self.seqs[seq_id].runs)

    def page_ids(self, seq_id: int) -> List[int]:
        st = self.seqs[seq_id]
        out: List[int] = []
        for s, l in st.runs:
            out.extend(range(s, s + l))
        return out

    def block_table(self, seq_ids: List[int], max_pages: int) -> np.ndarray:
        """Padded (B, max_pages) table for the paged_attention kernel."""
        out = np.zeros((len(seq_ids), max_pages), np.int32)
        for i, sid in enumerate(seq_ids):
            ids = self.page_ids(sid)
            assert len(ids) <= max_pages, (sid, len(ids), max_pages)
            out[i, : len(ids)] = ids
        return out

    def lengths(self, seq_ids: List[int]) -> np.ndarray:
        return np.asarray(
            [self.seqs[s].length for s in seq_ids], np.int32
        )

    @property
    def free_pages(self) -> int:
        return self.alloc.free_clusters + (self.n_pages - self.alloc._frontier)

    def fragmentation(self) -> float:
        """Mean discontiguous runs per active sequence (1.0 = fully
        compact, the S-strategy ideal)."""
        if not self.seqs:
            return 1.0
        depths = [max(1, len(s.runs)) for s in self.seqs.values()]
        return float(np.mean(depths))
