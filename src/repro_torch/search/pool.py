"""Cross-query shared chunk pool: one physical drain per hot key.

A hot-vocabulary batch opens the SAME ``(shard, index, key)`` posting
stream once per query; without sharing, every cursor re-fetches (or at
best re-serves from cache) the same chunks, so read traffic scales with
the query count.  The :class:`ChunkPool` deduplicates at the chunk
level WITHIN a batch: the first cursor opened for an identity owns the
physical :class:`~repro_torch.search.reader.ReaderCursor`; the pool records
every chunk it yields, and every other cursor for the identity replays
the recorded chunks at zero I/O, fetching a NEW physical chunk only
when it advances past the recorded frontier.  Physical bytes are
charged exactly once — to whichever view triggered the fetch — and
replays are ledgered as ``chunks_shared``/``bytes_shared``, so the
per-view trace invariant becomes

    chunks_planned == chunks_fetched + chunks_shared + chunks_skipped

(bytes likewise) and summing ``chunks_fetched`` over a batch counts
every physical chunk exactly once (``check_trace_complete`` pins this).

Snapshot safety: a pool lives for ONE batch, and every view serves the
open-time snapshot the shared inner cursor pinned — the same guarantee
a private cursor gives.  The pool never outlives the batch precisely so
a writer update between batches cannot leak a stale drain across the
generation check.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np

from repro_torch.search.reader import CacheStats, ReaderCursor


class _SharedStream:
    """One identity's physical cursor plus the replay log of its chunks.

    ``chunks`` holds ``(rows, nbytes)`` per yielded chunk, where
    ``nbytes`` is the physical charge measured as the inner cursor's
    ``bytes_fetched`` delta — so replaying views account the exact bytes
    the original fetch paid (zero for a cache-hit chunk)."""

    def __init__(self, inner: ReaderCursor):
        self.inner = inner
        self.chunks: List[Tuple[np.ndarray, int]] = []

    def extend(self) -> bool:
        """Fetch one more physical chunk into the log; False at EOF."""
        before = self.inner.bytes_fetched
        chunk = self.inner.next_chunk()
        if chunk is None:
            return False
        self.chunks.append((chunk, self.inner.bytes_fetched - before))
        return True


class PooledCursor:
    """One query's view over a shared stream.

    Quacks like a :class:`~repro_torch.core.inverted_index.PostingCursor`:
    ``next_chunk``/``exhausted``/``settled_bound`` plus the full counter
    surface, all PER VIEW — two views of one stream each see the whole
    chunk sequence and keep independent positions, but only the view
    that advances the shared frontier is charged the fetch; the others
    ledger a replay (``chunks_shared``/``bytes_shared``).
    """

    def __init__(self, stream: _SharedStream, first: bool,
                 stats: Optional[CacheStats] = None):
        self._stream = stream
        self._first = first  # the view that opened the physical cursor
        self._pos = 0
        self._stats = stats
        self.chunks_fetched = 0
        self.bytes_fetched = 0
        self.chunks_shared = 0
        self.bytes_shared = 0
        self.postings_delivered = 0
        self.last_doc: Optional[int] = None

    # totals and metadata delegate to the one physical cursor
    @property
    def chunks_total(self) -> int:
        return self._stream.inner.chunks_total

    @property
    def bytes_total(self) -> int:
        return self._stream.inner.bytes_total

    @property
    def max_doc_count(self) -> int:
        return self._stream.inner.max_doc_count

    @property
    def exhausted(self) -> bool:
        return (
            self._pos >= len(self._stream.chunks)
            and self._stream.inner.exhausted
        )

    @property
    def settled_bound(self) -> float:
        if self.exhausted:
            return float("inf")
        if self.last_doc is None:
            return float("-inf")
        return float(self.last_doc)

    @property
    def resumed(self) -> bool:
        """Whether the shared physical cursor resumed a settled prefix
        (``CursorResume`` from the cache's partial tier)."""
        return bool(getattr(self._stream.inner, "resumed", False))

    @property
    def prepaid(self) -> bool:
        """True while this view's next chunk costs zero device bytes:
        a replay of an already-logged chunk (the fetching view paid), or
        the inner cursor's own next chunk is prepaid (a resumed settled
        prefix / cache-hit rows).  Without this, a view over a warm
        resumed stream reports ``settled_bound == -inf`` until the
        executor happens to poll it — the executor instead drains
        prepaid chunks at open, seeding ``last_doc`` from the resumed
        prefix exactly like a private ``ReaderCursor`` gets seeded.
        Replays of chunks another view PAID for stay lazy (zero marginal
        cost, but they are real fetch-frontier data — the executor's
        bound loop decides if they are needed at all)."""
        if self._pos < len(self._stream.chunks):
            return self._stream.chunks[self._pos][1] == 0
        inner = self._stream.inner
        return not inner.exhausted and bool(getattr(inner, "prepaid", False))

    @property
    def chunks_skipped(self) -> int:
        return self.chunks_total - self.chunks_fetched - self.chunks_shared

    @property
    def bytes_skipped(self) -> int:
        return self.bytes_total - self.bytes_fetched - self.bytes_shared

    def next_chunk(self) -> Optional[np.ndarray]:
        if self._pos < len(self._stream.chunks):
            chunk, nbytes = self._stream.chunks[self._pos]
            self.chunks_shared += 1
            self.bytes_shared += nbytes
            if self._stats is not None:
                self._stats.pool_hits += 1
        else:
            if not self._stream.extend():
                return None
            chunk, nbytes = self._stream.chunks[self._pos]
            self.chunks_fetched += 1
            self.bytes_fetched += nbytes
        self._pos += 1
        if chunk.shape[0]:
            self.last_doc = int(chunk[-1, 0])
            self.postings_delivered += chunk.shape[0]
        return chunk

    def read_all(self) -> np.ndarray:
        parts: List[np.ndarray] = []
        while True:
            chunk = self.next_chunk()
            if chunk is None:
                break
            if chunk.shape[0]:
                parts.append(chunk)
        if not parts:
            return np.zeros((0, 2), dtype=np.int64)
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


class ChunkPool:
    """Per-batch registry of shared streams, keyed by cursor identity.

    ``cursor(ident, opener)`` returns a :class:`PooledCursor` view; the
    first call for an identity invokes ``opener`` to open the physical
    cursor, later calls share it.  ``streams()`` exposes the physical
    cursors so the batch teardown can :meth:`ReaderCursor.settle` each
    one exactly once (per-view settling would admit duplicate partials).
    """

    def __init__(self, stats: Optional[CacheStats] = None):
        self._streams: Dict[Hashable, _SharedStream] = {}
        self._stats = stats

    def cursor(
        self, ident: Hashable, opener: Callable[[], ReaderCursor]
    ) -> PooledCursor:
        stream = self._streams.get(ident)
        first = stream is None
        if first:
            stream = _SharedStream(opener())
            self._streams[ident] = stream
        return PooledCursor(stream, first, stats=self._stats)

    def streams(self) -> List[ReaderCursor]:
        """The physical cursors, one per distinct identity."""
        return [s.inner for s in self._streams.values()]

    def __len__(self) -> int:
        return len(self._streams)
