"""Read-side snapshot views over the easily updatable indexes.

The writer (:class:`~repro_torch.core.inverted_index.InvertedIndex`) owns the
build device and the update protocol; readers own everything about
serving lookups:

  * each :class:`IndexReader` charges its I/O to a dedicated *search*
    device, so build and search traffic are never conflated (previously
    done by temporarily swapping the stream manager's device — a
    writer-side hack that could not be made concurrent-safe);
  * posting lists are cached in a byte-budgeted LRU shared across the
    readers of a :class:`IndexSetReader` — a cache hit costs ZERO device
    I/O, which is what makes repeated keys in a query batch (and hot stop
    pairs across batches) nearly free;
  * readers snapshot the writer's part counter; when the writer indexes
    another collection part, the next lookup invalidates exactly the
    keys the writer's touched-key digest names (falling back to a
    whole-namespace drop only when the bounded digest history no longer
    covers the reader's snapshot) — single-writer, read-your-writes
    semantics with the cache kept warm for untouched keys;
  * cursors pin their open-time generation: an open cursor keeps serving
    its snapshot across writer updates, and the cache-admit path
    re-checks the generation so a mid-update drain can never publish a
    stale list.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.inverted_index import (
    CURSOR_CHUNK_CLUSTERS,
    InvertedIndex,
    PostingCursor,
)
from repro_torch.core.io_sim import BlockDevice, IOStats
from repro_torch.core.sharded_set import merge_io_reports, merge_shard_postings
from repro_torch.kernels.posting_decode.ops import (
    from_device_rows,
    to_device_rows,
)


def _frozen(arr: np.ndarray) -> np.ndarray:
    """An immutable alias of ``arr``: frozen in place when it owns its
    buffer, a frozen copy when the buffer stays writeable through a base
    (freezing only the view would let a holder of the base — or anyone
    flipping the flag back on, which numpy permits while the base is
    writeable — mutate it anyway)."""
    owner = arr if arr.base is None else arr.base
    if isinstance(owner, np.ndarray) and not owner.flags.writeable:
        return arr
    if arr.base is not None:
        arr = arr.copy()
    arr.flags.writeable = False
    return arr


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0      # capacity pressure: LRU victims only
    invalidations: int = 0  # correctness drops: writer-generation changes
    full_drops: int = 0     # whole-namespace sweeps (no digest coverage)
    bytes_used: int = 0
    pool_hits: int = 0       # chunk replays served by a batch ChunkPool
    device_hits: int = 0     # cursors served from the device-buffer tier
    partial_admits: int = 0  # settled prefixes admitted by early stops

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class PostingCache:
    """Byte-budgeted LRU over decoded posting arrays.

    Values are (N,2) int64 arrays, charged at ``arr.nbytes`` with a small
    per-entry floor (so negative-cache entries for absent keys stay
    bounded by the budget too).  Entries are namespaced by index name AT
    THE API level — ``get``/``put`` take ``(index_name, key)`` as two
    separate arguments — so different indexes whose packed integer keys
    happen to coincide numerically (e.g. an extended ``(w, v)`` key and
    a 2-word multi-component key) can never share a cache slot, and no
    caller can accidentally pass an un-namespaced key.  Cached arrays
    are marked read-only: every consumer of a posting list treats it as
    immutable, and the flag turns an accidental in-place mutation into a
    loud error instead of silent cross-query corruption.
    """

    # accounting floor per entry: map/key overhead, and the reason a
    # stream of distinct absent keys cannot grow the cache unboundedly
    MIN_CHARGE = 64

    def __init__(self, budget_bytes: int = 8 << 20):
        self.budget = int(budget_bytes)
        self._map: "OrderedDict[Tuple[str, Hashable], np.ndarray]" = OrderedDict()
        # partial tier: (prefix rows, CursorResume) per slot — settled
        # prefixes admitted by early-terminated cursors (ReaderCursor.settle)
        self._partials: "OrderedDict[Tuple[str, Hashable], Tuple[np.ndarray, object]]" = (
            OrderedDict()
        )
        # device tier: decoded rows pinned as int32 torch tensors on the
        # serving device, admitted beside the host tier when a
        # device-decode reader drains
        self._device: "OrderedDict[Tuple[str, Hashable], object]" = OrderedDict()
        self.stats = CacheStats()

    def get(self, index_name: str, key: Hashable) -> Optional[np.ndarray]:
        slot = (index_name, key)
        arr = self._map.get(slot)
        if arr is None:
            self.stats.misses += 1
            return None
        self._map.move_to_end(slot)
        self.stats.hits += 1
        return arr

    def _charge(self, arr) -> int:
        return max(int(arr.nbytes), self.MIN_CHARGE)

    def _partial_charge(self, prefix: np.ndarray, resume) -> int:
        return max(
            int(prefix.nbytes) + len(resume.decoder_state[0]), self.MIN_CHARGE
        )

    def _evict(self) -> None:
        # one byte budget across ALL tiers; reclaim order mirrors value
        # density: full host lists first (cheapest to rebuild via the
        # partial), then partials, then device buffers
        while self.stats.bytes_used > self.budget:
            if self._map:
                _, victim = self._map.popitem(last=False)
                self.stats.bytes_used -= self._charge(victim)
            elif self._partials:
                _, (pfx, res) = self._partials.popitem(last=False)
                self.stats.bytes_used -= self._partial_charge(pfx, res)
            elif self._device:
                _, victim = self._device.popitem(last=False)
                self.stats.bytes_used -= self._charge(victim)
            else:
                return
            self.stats.evictions += 1

    def put(self, index_name: str, key: Hashable, arr: np.ndarray) -> None:
        if self._charge(arr) > self.budget:
            return  # bigger than the whole budget: not cacheable
        slot = (index_name, key)
        old = self._map.pop(slot, None)
        if old is not None:
            self.stats.bytes_used -= self._charge(old)
        # a full list supersedes any cached partial of the same slot
        part = self._partials.pop(slot, None)
        if part is not None:
            self.stats.bytes_used -= self._partial_charge(*part)
        # detach through a view so _frozen can never flip the CALLER's
        # handle read-only: put() borrows the array, it does not take
        # ownership (a writeable owner forces _frozen to copy instead)
        arr = _frozen(arr.view())
        self._map[slot] = arr
        self.stats.bytes_used += self._charge(arr)
        self._evict()

    # ------------------------------------------------------ partial tier --
    def get_partial(
        self, index_name: str, key: Hashable
    ) -> Optional[Tuple[np.ndarray, object]]:
        """(prefix rows, resume token) for a slot, or None.  NOT counted
        as a hit/miss — the partial tier shortens a miss, it does not
        replace one."""
        slot = (index_name, key)
        entry = self._partials.get(slot)
        if entry is None:
            return None
        self._partials.move_to_end(slot)
        return entry

    def put_partial(
        self, index_name: str, key: Hashable, prefix: np.ndarray, resume
    ) -> None:
        """Admit an early-terminated cursor's settled prefix + resume
        token.  Skipped when a FULL list for the slot is already cached
        (strictly better)."""
        slot = (index_name, key)
        if slot in self._map:
            return
        charge = self._partial_charge(prefix, resume)
        if charge > self.budget:
            return
        old = self._partials.pop(slot, None)
        if old is not None:
            self.stats.bytes_used -= self._partial_charge(*old)
        self._partials[slot] = (_frozen(prefix), resume)
        self.stats.bytes_used += charge
        self.stats.partial_admits += 1
        self._evict()

    def drop_partial(self, index_name: str, key: Hashable) -> None:
        """Discard one slot's partial (its resume token went stale)."""
        entry = self._partials.pop((index_name, key), None)
        if entry is not None:
            self.stats.bytes_used -= self._partial_charge(*entry)

    # ------------------------------------------------------- device tier --
    def get_device(self, index_name: str, key: Hashable) -> Optional[object]:
        """Device-resident decoded rows for a slot, or None."""
        slot = (index_name, key)
        buf = self._device.get(slot)
        if buf is None:
            return None
        self._device.move_to_end(slot)
        self.stats.device_hits += 1
        return buf

    def put_device(self, index_name: str, key: Hashable, buf) -> None:
        """Pin a decoded list as a device buffer beside the host entry.
        The buffer shares the byte budget (charged at its nbytes)."""
        if buf is None:
            return
        if self._charge(buf) > self.budget:
            return
        slot = (index_name, key)
        old = self._device.pop(slot, None)
        if old is not None:
            self.stats.bytes_used -= self._charge(old)
        self._device[slot] = buf
        self.stats.bytes_used += self._charge(buf)
        self._evict()

    # ----------------------------------------------------- invalidation --
    def drop_index(self, index_name: str) -> None:
        """Invalidate every entry of one index namespace (writer advanced).

        Counted as ``invalidations`` — NOT ``evictions``, which stay a pure
        capacity-pressure signal — and each entry reclaims the same
        ``_charge`` (nbytes with the ``MIN_CHARGE`` floor) it was admitted
        at, so ``bytes_used`` returns exactly to its pre-admission level
        even for floor-charged (e.g. negative-cache) entries.  Sweeps ALL
        tiers: a stale device buffer or resume token is as poisonous as a
        stale host list."""
        stale = [k for k in self._map if k[0] == index_name]
        for k in stale:
            self.stats.bytes_used -= self._charge(self._map.pop(k))
            self.stats.invalidations += 1
        stale_p = [k for k in self._partials if k[0] == index_name]
        for k in stale_p:
            self.stats.bytes_used -= self._partial_charge(*self._partials.pop(k))
            self.stats.invalidations += 1
        stale_d = [k for k in self._device if k[0] == index_name]
        for k in stale_d:
            self.stats.bytes_used -= self._charge(self._device.pop(k))
            self.stats.invalidations += 1
        self.stats.full_drops += 1

    def drop_touched(self, index_name: str, digests) -> int:
        """Targeted invalidation: drop the namespace entries whose key
        appears in any of the writer's touched-key ``digests`` (one set
        per applied part), leaving every other entry warm.

        Iterates the CACHED entries — bounded by the byte budget — not
        the digests: a part can touch most of the vocabulary, and a
        refresh that walked the digest union would cost update-sized
        work per reader even when almost none of it is cached.  Each
        dropped entry counts as an ``invalidation`` and reclaims its
        admission ``_charge``.  Applies to every tier (host, partial,
        device) under the same digest test.  Returns the number of
        entries dropped."""

        def touched(slot) -> bool:
            return slot[0] == index_name and any(slot[1] in d for d in digests)

        stale = [slot for slot in self._map if touched(slot)]
        for slot in stale:
            self.stats.bytes_used -= self._charge(self._map.pop(slot))
            self.stats.invalidations += 1
        stale_p = [slot for slot in self._partials if touched(slot)]
        for slot in stale_p:
            self.stats.bytes_used -= self._partial_charge(
                *self._partials.pop(slot)
            )
            self.stats.invalidations += 1
        stale_d = [slot for slot in self._device if touched(slot)]
        for slot in stale_d:
            self.stats.bytes_used -= self._charge(self._device.pop(slot))
            self.stats.invalidations += 1
        return len(stale) + len(stale_p) + len(stale_d)

    def __len__(self) -> int:
        return len(self._map)


class ReaderCursor:
    """Cache-aware lazy cursor over one (index, key) posting list.

    A cache hit serves the whole cached list as ONE zero-I/O chunk; a
    miss wraps the index's chunked :class:`PostingCursor` and — only if
    the cursor drains completely — assembles the full list and admits it
    to the cache, so the next reader of the key pays nothing.  An
    early-terminated cursor never caches a partial list AS a full list
    (serving a truncated list would be silent corruption) — but via
    :meth:`settle` it CAN admit its settled prefix plus a resume token
    to the cache's partial tier, so the next reader of the key replays
    the decoded prefix for free and pays I/O only past the stop point.

    ``generation`` pins the reader's writer-snapshot at open time: the
    cursor keeps serving that snapshot however long it stays open, and
    the admit path re-checks the generation so a drain that outlived an
    update can never publish its (now stale) list to the cache.
    """

    def __init__(
        self,
        inner: PostingCursor,
        on_complete: Optional[Callable[[np.ndarray], None]] = None,
        generation: Optional[int] = None,
        on_partial: Optional[Callable[[np.ndarray, object], None]] = None,
    ):
        self._inner = inner
        self._on_complete = on_complete
        self._on_partial = on_partial
        self._parts: List[np.ndarray] = []
        self._completed = False
        # open-time snapshot pin, read-only record — not an advance
        self.generation = generation  # repro-lint: allow(generation-discipline)

    def next_chunk(self) -> Optional[np.ndarray]:
        chunk = self._inner.next_chunk()
        if chunk is None:
            self._complete()
            return None
        if chunk.shape[0] and (
            self._on_complete is not None or self._on_partial is not None
        ):
            self._parts.append(chunk)
        if self._inner.exhausted:
            # the consumer has every chunk: admit the full list NOW — a
            # caller that stops polling at `exhausted` (the streaming
            # executor does) must still warm the cache
            self._complete()
        return chunk

    def _complete(self) -> None:
        if self._completed:
            return
        self._completed = True
        if self._on_complete is not None:
            if not self._parts:
                full = np.zeros((0, 2), dtype=np.int64)
            elif len(self._parts) == 1:
                full = self._parts[0]
            else:
                full = np.concatenate(self._parts, axis=0)
            # admitted lists are frozen exactly like IndexReader.lookup
            # results: a single-chunk drain would otherwise hand the
            # cache a view over a buffer the consumer can still reach
            full = _frozen(full)
            self._on_complete(full)

    def settle(self) -> bool:
        """Admit this cursor's settled prefix to the partial cache tier.

        Called by the executor when a query early-terminates: the chunks
        delivered so far plus the inner cursor's resume token (decoder
        carry included) let the NEXT reader of the key replay the prefix
        at zero I/O and fetch only past the stop point.  A no-op (False)
        when the drain completed (the full list was already admitted),
        no partial sink is wired, or the inner cursor has nothing worth
        resuming (e.g. it never fetched a real storage unit)."""
        if self._completed or self._on_partial is None:
            return False
        suspend = getattr(self._inner, "suspend", None)
        if suspend is None:
            return False
        resume = suspend()
        if resume is None:
            return False
        if not self._parts:
            prefix = np.zeros((0, 2), dtype=np.int64)
        elif len(self._parts) == 1:
            prefix = self._parts[0]
        else:
            prefix = np.concatenate(self._parts, axis=0)
        self._on_partial(_frozen(prefix), resume)
        return True

    def read_all(self) -> np.ndarray:
        """Drain the remaining chunks through :meth:`next_chunk` (NEVER
        the inner cursor's ``read_all``, which would bypass the
        accumulation above and let a later completion admit a truncated
        list to the cache).  The result is immutable, like every other
        posting list a reader hands out."""
        parts: List[np.ndarray] = []
        while True:
            chunk = self.next_chunk()
            if chunk is None:
                break
            if chunk.shape[0]:
                parts.append(chunk)
        if not parts:
            return np.zeros((0, 2), dtype=np.int64)
        full = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        return _frozen(full)

    def __getattr__(self, name):
        # the counter/bound/metadata surface (exhausted, settled_bound,
        # chunks_*, bytes_*, postings_delivered, max_doc_count — the ranked
        # executor's score upper bound) delegates to the underlying cursor
        return getattr(self._inner, name)


class IndexReader:
    """Read-only access to one :class:`InvertedIndex` snapshot.

    All lookup I/O is charged to ``self.device`` (never the writer's
    build device); decoded posting lists go through the shared LRU.
    """

    def __init__(
        self,
        index: InvertedIndex,
        device: Optional[BlockDevice] = None,
        cache: Optional[PostingCache] = None,
        cache_ns: Optional[str] = None,
        targeted: bool = True,
    ):
        self.index = index
        self.device = device if device is not None else BlockDevice(
            cluster_size=index.cfg.cluster_size, name=f"{index.name}-read"
        )
        self.cache = cache
        # cache namespace: defaults to the index name; a sharded reader
        # passes "s{shard}:{name}" so the shared cache is keyed by
        # (shard, index, key) and shards can never answer for each other
        self.cache_ns = cache_ns if cache_ns is not None else index.name
        # targeted invalidation: refresh drops only the keys the writer's
        # touched-key digests name; False forces the whole-namespace drop
        # (the pre-digest behaviour, kept as the benchmark baseline)
        self.targeted = targeted
        # the writer's PUBLISHED generation counter — NOT the physical
        # part counter ``n_parts``: checkpoint reopens bulk-apply
        # collapsed state (one part standing in for many), so a reader
        # tracking parts could believe itself current across a fold that
        # rewrote every list and skip both the targeted drop and the
        # behind-history namespace-drop fallback
        self._generation = index.generation

    # ------------------------------------------------------------ lookups --
    def lookup(self, key: Hashable) -> np.ndarray:
        if self.index.generation != self._generation:
            self.refresh()
        if self.cache is not None:
            hit = self.cache.get(self.cache_ns, key)
            if hit is not None:
                return hit
        posts = self.index.lookup(key, device=self.device)
        # readers hand out immutable postings: the same buffer is shared
        # with every later cache hit, so a mutation by the first caller
        # must fail loudly instead of corrupting other queries' results
        posts.flags.writeable = False
        if self.cache is not None:
            self.cache.put(self.cache_ns, key, posts)  # repro-lint: allow(cache-tier) port copy of repro/search/reader.py, the cache's owner
        return posts

    def open_cursor(
        self,
        key: Hashable,
        chunk_clusters: int = CURSOR_CHUNK_CLUSTERS,
        make_decoder: Optional[Callable[[], object]] = None,
        device_tier: Optional[torch.device] = None,
    ) -> ReaderCursor:
        """Lazy chunked :meth:`lookup` — the streaming executor's fetch
        primitive.  Cache hits serve one zero-I/O chunk; misses read the
        key's storage units on demand and cache the full list only if the
        cursor drains completely.

        Hit order: host tier, then device tier (``device_tier`` is the
        torch device the tier lives on, ``None`` leaves it out: decoded
        rows pinned as device buffers are rematerialized without touching
        storage), then the partial tier (a settled prefix + resume token
        replays for free and fetches only past the stop point), then a
        fresh storage read.  ``make_decoder`` swaps the OWN-stream decoder
        (e.g. the device-backed one); a full drain additionally pins the
        rows on ``device_tier`` when it is set and the values fit int32."""
        if self.index.generation != self._generation:
            self.refresh()
        gen = self._generation
        if self.cache is not None:
            hit = self.cache.get(self.cache_ns, key)
            if hit is not None:
                return ReaderCursor(PostingCursor.from_array(hit),
                                    generation=gen)
            if device_tier is not None:
                dev_buf = self.cache.get_device(self.cache_ns, key)
                if dev_buf is not None:
                    return ReaderCursor(
                        PostingCursor.from_array(from_device_rows(dev_buf)),
                        generation=gen,
                    )
        resume_entry = (
            self.cache.get_partial(self.cache_ns, key)
            if self.cache is not None else None
        )
        prefix, resume = resume_entry if resume_entry is not None else (None, None)
        inner = self.index.open_cursor(
            key,
            device=self.device,
            chunk_clusters=chunk_clusters,
            make_decoder=make_decoder,
            resume=resume,
            prefix=prefix,
        )
        if resume is not None and not inner.resumed:
            # the token no longer matches the stream's unit layout (the
            # key was repacked without a digest naming it — e.g. its
            # strategy changed): drop it so it is not retried forever
            self.cache.drop_partial(self.cache_ns, key)
        on_complete = None
        on_partial = None
        if self.cache is not None:
            def on_complete(full, key=key, gen=gen):
                # admit-time generation re-check: a cursor that stayed
                # open across a writer update still DELIVERS its open-time
                # snapshot (correct for the batch it serves), but its list
                # is stale the moment the writer advanced — admitting it
                # would poison every later lookup of the key.  The check
                # at open time alone cannot see an update that landed
                # mid-drain.
                if self.index.generation != gen:
                    return
                self.cache.put(self.cache_ns, key, full)  # repro-lint: allow(cache-tier) port copy of repro/search/reader.py, the cache's owner
                if device_tier is not None:
                    self.cache.put_device(  # repro-lint: allow(cache-tier) port copy of repro/search/reader.py, the cache's owner
                        self.cache_ns, key, to_device_rows(full, device_tier)
                    )

            def on_partial(prefix, resume, key=key, gen=gen):
                # same mid-drain staleness rule as full admission
                if self.index.generation != gen:
                    return
                self.cache.put_partial(self.cache_ns, key, prefix, resume)  # repro-lint: allow(cache-tier) port copy of repro/search/reader.py, the cache's owner
        return ReaderCursor(inner, on_complete, generation=gen,
                            on_partial=on_partial)

    def lookup_ops(self, key: Hashable) -> int:
        return self.index.lookup_ops(key)

    def group_of(self, key: Hashable) -> int:
        """Dictionary group of a key — the planner's amortization unit."""
        return self.index.dict.group_of(key)

    # ------------------------------------------------------------- state --
    def refresh(self) -> str:
        """Re-snapshot after the writer published more generations.

        A no-op when the writer's *published* generation is unchanged:
        cached postings are still valid, and dropping them would turn
        every periodic refresh sweep into a full cold restart of the
        posting cache.  (Published generation, not ``n_parts``: physical
        part counts alias across checkpoint reopens and folds.)

        When the writer DID advance, the writer's per-part touched-key
        digests (``InvertedIndex.digests_since``) name exactly the keys
        whose lists changed, so only those ``(shard, index, key)`` cache
        entries are invalidated — every untouched hot key stays warm.
        The whole-namespace drop survives as the fallback for a reader so
        far behind that the bounded digest history no longer covers its
        snapshot (and as the explicit ``targeted=False`` baseline).

        Returns the catch-up mode taken — ``"current"``, ``"targeted"``
        or ``"full_drop"`` — which the replica fabric ledgers per
        replica."""
        if self.index.generation == self._generation:
            return "current"
        mode = "targeted"
        if self.cache is not None:
            digests = (
                self.index.digests_since(self._generation)
                if self.targeted else None
            )
            if digests is None:
                self.cache.drop_index(self.cache_ns)
                mode = "full_drop"
            else:
                self.cache.drop_touched(self.cache_ns, digests)
        self._generation = self.index.generation
        return mode

    def io_stats(self) -> IOStats:
        return self.device.stats.snapshot()


class IndexSetReader:
    """Readers for every index of a :class:`TextIndexSet`, one shared cache.

    Reuses the set's per-index search devices so the existing
    ``TextIndexSet.search_io()`` reporting keeps aggregating reader
    traffic.
    """

    # the executor's scatter surface: an unsharded reader is the 1-shard
    # degenerate case, so SearchService has exactly one fetch/gather path
    n_shards = 1

    def __init__(self, index_set, cache_bytes: int = 8 << 20,
                 targeted: bool = True):
        self.index_set = index_set
        self.cache = PostingCache(cache_bytes) if cache_bytes > 0 else None
        self.readers: Dict[str, IndexReader] = {
            name: IndexReader(
                idx, device=index_set.search_devices[name], cache=self.cache,
                targeted=targeted,
            )
            for name, idx in index_set.indexes.items()
        }
        self.lexicon = index_set.lexicon

    def lookup(self, index_name: str, key: Hashable) -> np.ndarray:
        return self.readers[index_name].lookup(key)

    def lookup_shard(self, shard: int, index_name: str, key: Hashable) -> np.ndarray:
        if shard != 0:
            raise IndexError(f"unsharded reader has one shard, got {shard}")
        return self.readers[index_name].lookup(key)

    def open_cursor_shard(
        self, shard: int, index_name: str, key: Hashable,
        make_decoder=None, device_tier: Optional[torch.device] = None,
    ) -> ReaderCursor:
        """Lazy cursor over one shard's posting subset (the streaming
        executor's scatter primitive; shard 0 is the whole set here)."""
        if shard != 0:
            raise IndexError(f"unsharded reader has one shard, got {shard}")
        return self.readers[index_name].open_cursor(
            key, make_decoder=make_decoder, device_tier=device_tier
        )

    def group_of(self, index_name: str, key: Hashable) -> int:
        return self.readers[index_name].group_of(key)

    def refresh(self) -> None:
        for r in self.readers.values():
            r.refresh()

    def generation_vector(self) -> List[List[int]]:
        """Per-shard, per-index published generations (one shard entry:
        the unsharded set is the 1-shard degenerate case).  Per-index
        vectors, never a sum: summed counters alias — one index
        advancing while another folds/restores can leave the sum
        unchanged, letting a mid-batch write dodge
        ``SnapshotViolationError`` and a refresh no-op on a changed
        set.  Derived from the writers' published counters, so a direct
        ``add_part`` is never missed."""
        return [[r.index.generation for r in self.readers.values()]]

    def io_stats(self) -> Dict[str, IOStats]:
        return {name: r.io_stats() for name, r in self.readers.items()}

    @property
    def cache_stats(self) -> Optional[CacheStats]:
        return self.cache.stats if self.cache is not None else None


class ShardedIndexSetReader:
    """Per-shard :class:`IndexReader` fabric over a
    :class:`~repro_torch.core.sharded_set.ShardedTextIndexSet`.

    One byte-budgeted :class:`PostingCache` is shared by ALL shards'
    readers, namespaced ``s{shard}:{index}`` so entries are keyed by
    (shard, index, key): hot keys of a hot shard may claim most of the
    budget (global LRU), but shards can never answer for each other, and
    a single shard's writer advancing invalidates ONLY that shard's
    entries.  Each per-shard reader charges the owning shard's search
    devices, so ``ShardedTextIndexSet.search_io_per_shard()`` keeps
    reporting true per-shard read traffic.
    """

    def __init__(self, sharded_set, cache_bytes: int = 8 << 20,
                 targeted: bool = True):
        self.index_set = sharded_set
        self.cache = PostingCache(cache_bytes) if cache_bytes > 0 else None
        self.shard_readers: List[Dict[str, IndexReader]] = [
            {
                name: IndexReader(
                    idx,
                    device=shard.search_devices[name],
                    cache=self.cache,
                    cache_ns=f"s{s}:{name}",
                    targeted=targeted,
                )
                for name, idx in shard.indexes.items()
            }
            for s, shard in enumerate(sharded_set.shards)
        ]
        self.lexicon = sharded_set.lexicon

    @property
    def n_shards(self) -> int:
        return len(self.shard_readers)

    # ------------------------------------------------------------ lookups --
    def lookup_shard(self, shard: int, index_name: str, key: Hashable) -> np.ndarray:
        """One shard's posting subset for a key (the scatter primitive)."""
        return self.shard_readers[shard][index_name].lookup(key)

    def open_cursor_shard(
        self, shard: int, index_name: str, key: Hashable,
        make_decoder=None, device_tier: Optional[torch.device] = None,
    ) -> ReaderCursor:
        """Lazy cursor over one shard's posting subset.  Per-shard cursors
        share the set-wide posting cache under the shard's namespace, so a
        fully drained cursor warms exactly the slot ``lookup_shard`` uses."""
        return self.shard_readers[shard][index_name].open_cursor(
            key, make_decoder=make_decoder, device_tier=device_tier
        )

    def lookup(self, index_name: str, key: Hashable) -> np.ndarray:
        """Whole-set lookup: scatter to every shard, gather by merge."""
        return merge_shard_postings(
            [
                readers[index_name].lookup(key)
                for readers in self.shard_readers
            ]
        )

    def group_of(self, index_name: str, key: Hashable) -> int:
        # dictionary grouping is shard-invariant (identical seeds): the
        # planner stays shard-agnostic by asking shard 0
        return self.shard_readers[0][index_name].group_of(key)

    # ------------------------------------------------------------- state --
    def refresh(self) -> None:
        for readers in self.shard_readers:
            for r in readers.values():
                r.refresh()

    def generation_vector(self) -> List[List[int]]:
        """Per-shard, per-index published generations: row ``s`` moves
        exactly when shard ``s``'s update stream applied a part that
        touched it — what a snapshot-consistent batch pins in
        ``last_trace``.  Per-index vectors, never per-shard sums, for
        the aliasing reason documented on
        :meth:`IndexSetReader.generation_vector`."""
        return [
            [r.index.generation for r in readers.values()]
            for readers in self.shard_readers
        ]

    def io_stats_per_shard(self) -> List[Dict[str, IOStats]]:
        return [
            {name: r.io_stats() for name, r in readers.items()}
            for readers in self.shard_readers
        ]

    def io_stats(self) -> Dict[str, IOStats]:
        return merge_io_reports(self.io_stats_per_shard())

    @property
    def cache_stats(self) -> Optional[CacheStats]:
        return self.cache.stats if self.cache is not None else None
