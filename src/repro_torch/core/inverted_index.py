"""The easily updatable associative array (paper sections 2.2-5).

``InvertedIndex`` is the user-facing structure: an associative array in
external memory mapping keys to posting lists, updatable in place (Method 2)
— no sort-and-merge pass.  It composes:

  * :class:`~repro_torch.core.dictionary.Dictionary` — key → entry (EM/TAG/OWN),
  * :class:`~repro_torch.core.stream.StreamManager` — stream-of-clusters lifecycle,
  * :class:`~repro_torch.core.io_sim.BlockDevice` — exact I/O accounting
    (optionally :class:`PackedWriteDevice` for strategy DS).

Construction/update protocol (paper 2.2, 5.1): the caller hands one *part*
of the collection at a time as ``{key: (N,2) postings}``; the index runs a
C1 phase per key group, appending each key's batch into its stream.  TAG
buckets receive one merged, tag-prefixed batch per phase; a member whose
share outgrows ``tag_extract_bytes`` is extracted to a dedicated stream
(5.6).  Doc ids must be globally increasing across parts — the natural
consequence of indexing a growing collection.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Dict, Hashable, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.dictionary import (
    ENTRY_FIXED_BYTES,
    Dictionary,
    Entry,
    K_EM,
    K_OWN,
    K_TAG,
    key_bytes,
    stable_hash,
)
from repro_torch.core.io_sim import BlockDevice, IOStats
from repro_torch.core.postings import (
    PostingDecoder,
    decode_postings,
    encode_postings,
    max_doc_run,
)
from repro_torch.core.strategies import StrategyConfig
from repro_torch.core.stream import DigestLog, StreamManager

_EMPTY = np.zeros((0, 2), dtype=np.int64)

# default cursor granularity: at most this many clusters fetched per chunk,
# so a lazy reader can stop inside a large contiguous segment
CURSOR_CHUNK_CLUSTERS = 4

# parts of touched-key digest history a writer retains for readers: a
# reader within this many generations invalidates only the touched keys;
# one further behind falls back to dropping its whole cache namespace
DIGEST_HISTORY = 64

# per-part digest size cap: a part touching more keys than this records a
# sentinel instead (readers fall back to the whole-namespace drop, which
# is cheaper than a vocabulary-sized targeted scan anyway), so retained
# digests can never dwarf the posting cache they exist to protect
DIGEST_MAX_KEYS = 1 << 16


@dataclasses.dataclass(frozen=True)
class CursorResume:
    """Where a suspended K_OWN cursor stopped: enough to reopen the
    stream past its consumed storage units with the decoder carry intact.

    ``units_consumed``/``payload_consumed`` pin the open-time unit
    layout (``chunk_clusters`` included) so a resume against a stream
    whose storage moved is detected and refused — the caller falls back
    to a fresh cursor.  ``decoder_state`` is the
    ``PostingDecoder.state()`` carry tuple (tail bytes + delta
    continuation), shared with the device decoder."""

    chunk_clusters: int
    units_consumed: int
    payload_consumed: int
    decoder_state: Tuple[bytes, int, int, bool]


@dataclasses.dataclass
class _SuspendCtx:
    """Per-cursor bookkeeping that makes ``PostingCursor.suspend`` work:
    the shared decoder, the absolute stream-unit index behind each thunk
    (``None`` for a replayed cache prefix), and per-thunk payload sizes."""

    decoder: object
    chunk_clusters: int
    base_payload: int
    unit_index: List[Optional[int]]
    unit_payload: List[int]


class PostingCursor:
    """Lazy chunked reader over one key's (doc, pos)-sorted posting list.

    ``next_chunk()`` returns the next slice of the list (possibly empty
    when a storage unit ends mid-record) and charges the owning device
    only for the storage units actually fetched; ``None`` once exhausted.
    Fetching every chunk charges exactly the bytes ``lookup`` would, so
    ``bytes_total - bytes_fetched`` is the read traffic an early stop
    saved.  ``settled_bound`` is the exclusive doc-id bound below which
    the delivered rows are final: postings are stored sorted by
    (doc, pos), so every future chunk carries docs ``>= last delivered
    doc`` (the last doc itself may continue into the next chunk).
    """

    # sharing ledger slots: real on pooled cursor views
    # (repro_torch.search.pool), zero here so the trace invariant
    # ``planned == fetched + shared + skipped`` holds for every cursor
    chunks_shared = 0
    bytes_shared = 0

    def __init__(
        self,
        thunks: List[Tuple[int, Callable[[], np.ndarray]]],
        max_doc_count: Optional[int] = None,
        suspend_ctx: Optional[_SuspendCtx] = None,
    ):
        self._thunks = thunks
        self._i = 0
        self.chunks_total = len(thunks)
        self.chunks_fetched = 0
        self.bytes_total = sum(nb for nb, _ in thunks)
        self.bytes_fetched = 0
        self.postings_delivered = 0
        self.last_doc: Optional[int] = None
        self._max_doc_count = max_doc_count
        self._src: Optional[np.ndarray] = None
        self._suspend_ctx = suspend_ctx
        # set by InvertedIndex.open_cursor when a CursorResume was applied
        self.resumed = False

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "PostingCursor":
        """Single-chunk cursor over pre-decoded rows (EM/TAG/absent keys:
        their whole-list read was charged — or costs nothing — at open)."""
        if arr.shape[0] == 0:
            cur = cls([], max_doc_count=0)
        else:
            cur = cls([(0, lambda: arr)])
        cur._src = arr
        return cur

    @property
    def max_doc_count(self) -> int:
        """Largest per-doc posting count this cursor's key can deliver —
        the ranked executor's WAND-style upper-bound metadata.  Dictionary
        cursors carry the entry's lifetime max; array-backed cursors
        (cache hits, batch-shared rows) compute the exact max of their
        rows on first use (free: the rows are already decoded)."""
        if self._max_doc_count is None:
            self._max_doc_count = (
                max_doc_run(self._src) if self._src is not None else 0
            )
        return self._max_doc_count

    @property
    def exhausted(self) -> bool:
        return self._i >= len(self._thunks)

    @property
    def settled_bound(self) -> float:
        """Docs strictly below this bound can gain no further postings."""
        if self.exhausted:
            return float("inf")
        if self.last_doc is None:
            return float("-inf")
        return float(self.last_doc)

    @property
    def prepaid(self) -> bool:
        """True while the next chunk costs zero device bytes to deliver —
        a resumed settled prefix or pre-decoded cache-hit rows.  The
        streaming executor drains prepaid chunks eagerly at open so their
        rows seed ``settled_bound`` before the first fetch round; the
        bound stays delivery-based (seeding an *undelivered* bound would
        let a region cut lose rows)."""
        return self._i < len(self._thunks) and self._thunks[self._i][0] == 0

    @property
    def chunks_skipped(self) -> int:
        return self.chunks_total - self.chunks_fetched

    @property
    def bytes_skipped(self) -> int:
        return self.bytes_total - self.bytes_fetched

    def suspend(self) -> Optional[CursorResume]:
        """Freeze a partially-drained K_OWN cursor into a resume token.

        Returns None when there is nothing worth resuming: cursors
        without a suspend context (EM/TAG/array-backed), exhausted
        cursors (the complete drain goes to the main cache tier), and
        cursors that fetched no real storage unit (a replayed cache
        prefix alone — resuming would re-record the same token).
        """
        ctx = self._suspend_ctx
        if ctx is None or self.exhausted:
            return None
        consumed = [ctx.unit_index[k] for k in range(self._i)]
        real = [u for u in consumed if u is not None]
        if not real:
            return None
        units_consumed = real[-1] + 1
        payload = ctx.base_payload + sum(
            ctx.unit_payload[k]
            for k in range(self._i)
            if ctx.unit_index[k] is not None
        )
        return CursorResume(
            chunk_clusters=ctx.chunk_clusters,
            units_consumed=units_consumed,
            payload_consumed=payload,
            decoder_state=ctx.decoder.state(),
        )

    def next_chunk(self) -> Optional[np.ndarray]:
        if self.exhausted:
            return None
        nbytes, thunk = self._thunks[self._i]
        self._i += 1
        arr = thunk()
        self.chunks_fetched += 1
        self.bytes_fetched += nbytes
        if arr.shape[0]:
            self.last_doc = int(arr[-1, 0])
            self.postings_delivered += arr.shape[0]
        if arr.flags.writeable:
            arr = arr.view()
            arr.flags.writeable = False
        return arr

    def read_all(self) -> np.ndarray:
        """Drain the cursor; the concatenation of every chunk."""
        parts = []
        while True:
            chunk = self.next_chunk()
            if chunk is None:
                break
            if chunk.shape[0]:
                parts.append(chunk)
        if not parts:
            return _EMPTY
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


class InvertedIndex:
    def __init__(
        self,
        cfg: StrategyConfig,
        device: BlockDevice,
        n_groups: int = 16,
        name: str = "index",
        fl_area_clusters: int = 8192,
        seed: int = 0,
        dict_device: Optional[BlockDevice] = None,
        digest_history: int = DIGEST_HISTORY,
        digest_max_keys: int = DIGEST_MAX_KEYS,
    ):
        self.cfg = cfg
        self.name = name
        self.mgr = StreamManager(
            cfg, device, n_groups, name=name,
            fl_area_clusters=fl_area_clusters, seed=seed,
        )
        # dictionary partition traffic is identical across strategy sets and
        # is accounted separately (the paper's tables measure the index data
        # file); defaults to the main device when not supplied.
        self.dict_dev = dict_device if dict_device is not None else device
        self.dict = Dictionary(n_groups)
        self._group_dict_bytes: Dict[int, int] = defaultdict(int)
        # TAG bucket assignment: per group, the currently-open bucket stream
        self._open_bucket: Dict[int, int] = {}
        self.n_extractions = 0
        self.n_parts = 0
        # published snapshot generation.  Decoupled from the physical part
        # counter ``n_parts``: a checkpoint reopen bulk-applies collapsed
        # state (one part standing in for many), so counting parts would
        # alias a reopened replica's position against the writer's.  The
        # published counter is monotone, advances with every part/compact
        # publication, and is *restored* (never rewound) from a durable
        # manifest via :meth:`restore_generation`.
        self.generation = 0  # repro-lint: allow(generation-discipline) port copy of InvertedIndex, the generation's publisher
        # live-update observability: per-part touched-key digests, keyed by
        # the published generation the part produced.  Bounded: a reader
        # further behind than the history falls back to a full namespace
        # drop (see repro_torch.search.reader.IndexReader.refresh).
        self._part_digests = DigestLog(digest_history)
        self._digest_max_keys = int(digest_max_keys)
        # background-compaction observability (repro.store rides on these)
        self.n_compactions = 0
        self.compacted_streams = 0

    # ------------------------------------------------------------ updating --
    def add_part(
        self, postings_by_key: Dict[Hashable, np.ndarray]
    ) -> Optional[frozenset]:
        """Index one part of the collection (build or in-place update).

        The generation counter ``n_parts`` advances ONLY when the part
        actually carried postings: an empty part changes no stored state,
        so bumping the generation would force every reader into a
        needless cache invalidation sweep.  Each applied part publishes
        its *touched-key digest* — the exact key set whose posting lists
        changed — so readers can invalidate only those keys.  Returns
        that digest, or ``None`` when the part was a no-op."""
        by_group: Dict[int, List[Tuple[Hashable, np.ndarray]]] = defaultdict(list)
        for key, posts in postings_by_key.items():
            arr = np.asarray(posts, dtype=np.int64)
            if arr.size == 0:
                continue
            by_group[self.dict.group_of(key)].append((key, arr))
        if not by_group:
            return None
        for group in sorted(by_group):
            self._run_phase(group, by_group[group])
        self.n_parts += 1
        self.generation += 1  # repro-lint: allow(generation-discipline) port copy of InvertedIndex, the generation's publisher
        digest = frozenset(
            key for items in by_group.values() for key, _ in items
        )
        # oversized digests are recorded as a sentinel: readers behind
        # this part take the whole-namespace fallback instead of a
        # vocabulary-sized targeted scan, and the retained history stays
        # bounded in bytes, not just in parts
        self._part_digests.publish(
            self.generation,
            digest if len(digest) <= self._digest_max_keys else None,
        )
        return digest

    def digests_since(self, generation: int) -> Optional[List[frozenset]]:
        """Touched-key digests of every part applied after ``generation``.

        Returns one frozenset per part, oldest first — their union is the
        complete set of keys whose posting lists changed since the caller
        snapshotted :attr:`generation` — or ``None`` when the bounded
        digest history no longer reaches back that far, or some covered
        part's digest was too large to retain (the caller must then
        treat EVERY key as potentially stale)."""
        return self._part_digests.since(generation, self.generation)

    def restore_generation(self, generation: int) -> None:
        """Restore the *published* generation counter from a durable
        manifest after bulk-applying checkpointed state.

        Forward-only: the published counter is monotone, so restoring
        below the current value is a protocol violation.  Jumping
        forward clears the digest history — the bulk-applied state has
        no per-generation digests for the span the checkpoint collapsed,
        so readers behind the restore point must take the
        whole-namespace fallback rather than get a false "current"."""
        generation = int(generation)
        if generation < self.generation:
            raise ValueError(
                f"generation restore moves backwards "
                f"({self.generation} -> {generation})"
            )
        if generation > self.generation:
            self.generation = generation  # repro-lint: allow(generation-discipline) port copy of InvertedIndex, the generation's publisher
            self._part_digests.clear()

    def compact(self) -> Optional[frozenset]:
        """Background compaction: fold every dedicated stream whose
        storage is scattered (chained segments, SR/FL tails, loose
        power-of-two over-allocation) into one tight EM-tier segment.

        Published as *just another generation advance*: ``n_parts``
        bumps once for the whole cycle and the touched-key digest lands
        in the same bounded history ``add_part`` feeds, so snapshot
        pins, open cursors and targeted cache invalidation all see a
        compaction exactly like an update part.  A cycle that rewrites
        nothing is a FULL no-op — no generation bump, no digest —
        mirroring the empty-part rule.  Returns the digest, or ``None``
        for a no-op cycle."""
        touched: List[Hashable] = []
        for key, e in self.dict.entries.items():
            if e.kind != K_OWN:
                continue
            if self.mgr.compact_stream(e.sid):
                touched.append(key)
        if not touched:
            return None
        self.n_compactions += 1
        self.compacted_streams += len(touched)
        self.n_parts += 1
        self.generation += 1  # repro-lint: allow(generation-discipline) port copy of InvertedIndex, the generation's publisher
        digest = frozenset(touched)
        self._part_digests.publish(
            self.generation,
            digest if len(digest) <= self._digest_max_keys else None,
        )
        return digest

    def _run_phase(self, group: int, items: List[Tuple[Hashable, np.ndarray]]) -> None:
        dev = self.dict_dev
        dev.read_sequential(self._group_dict_bytes[group])  # repro-lint: allow(charge-accounting) port copy of the repro/core/inverted_index.py chokepoint
        self.mgr.begin_phase(group)
        bucket_batches: Dict[int, List[Tuple[int, Optional[np.ndarray], np.ndarray]]] = (
            defaultdict(list)
        )
        for key, posts in items:
            self._append_key(group, key, posts, bucket_batches)
        extract_candidates: List[Hashable] = []
        for sid, batch in bucket_batches.items():
            extract_candidates.extend(self._flush_bucket(group, sid, batch))
        for key in extract_candidates:
            self._extract_key(group, key)
        self.mgr.end_phase()
        dev.write_sequential(self._group_dict_bytes[group])  # repro-lint: allow(charge-accounting) port copy of the repro/core/inverted_index.py chokepoint
        dev.flush()

    def _append_key(
        self,
        group: int,
        key: Hashable,
        posts: np.ndarray,
        bucket_batches: Dict[int, List],
    ) -> None:
        cfg = self.cfg
        e = self.dict.get(key)
        if e is None:
            e = self.dict.get_or_create(key)
            self._group_dict_bytes[group] += ENTRY_FIXED_BYTES + len(key_bytes(key))

        # every posting batch for a key passes through here exactly once
        # (EM/TAG/OWN alike), and parts partition the doc-id space, so the
        # running max of per-part per-doc counts IS the key's lifetime max
        part_max = max_doc_run(posts)
        if part_max > e.max_doc_count:
            e.max_doc_count = part_max

        if e.kind == K_EM:
            chunk = encode_postings(posts, prev_doc=e.last_doc)
            if cfg.use_em and e.nbytes + len(chunk) <= cfg.em_limit:
                e.data += chunk
                self._group_dict_bytes[group] += len(chunk)
                self._bump(e, posts, len(chunk))
                return
            # leaving EM: the inline bytes move out of the dictionary
            old_em = bytes(e.data)
            old_posts = None
            if old_em:
                old_posts, _ = decode_postings(old_em)
                self._group_dict_bytes[group] -= len(old_em)
                e.data = bytearray()
            if cfg.use_tag and e.nbytes + len(chunk) <= cfg.tag_extract_bytes:
                sid, tag = self._join_bucket(group, key)
                e.kind, e.sid, e.tag = K_TAG, sid, tag
                bucket_batches[sid].append((tag, old_posts, posts))
                # nbytes re-accounted by _flush_bucket's tagged encoding
                e.nbytes = 0
                e.npostings += posts.shape[0]
                e.last_doc = int(posts[-1, 0])
                return
            # dedicated stream
            sid = self.mgr.new_stream(group)
            e.kind, e.sid = K_OWN, sid
            payload = old_em + chunk
            self.mgr.append_stream(sid, payload)
            self.mgr.streams[sid].last_doc = int(posts[-1, 0])
            self._bump(e, posts, len(chunk))
            return

        if e.kind == K_TAG:
            bucket_batches[e.sid].append((e.tag, None, posts))
            # nbytes updated in _flush_bucket (needs the merged encoding)
            e.npostings += posts.shape[0]
            e.last_doc = int(posts[-1, 0])
            return

        # K_OWN
        chunk = encode_postings(posts, prev_doc=e.last_doc)
        self.mgr.append_stream(e.sid, chunk)
        self.mgr.streams[e.sid].last_doc = int(posts[-1, 0])
        self._bump(e, posts, len(chunk))

    @staticmethod
    def _bump(e: Entry, posts: np.ndarray, nbytes: int) -> None:
        e.nbytes += nbytes
        e.npostings += posts.shape[0]
        e.last_doc = int(posts[-1, 0])

    # --------------------------------------------------------- TAG buckets --
    def _join_bucket(self, group: int, key: Hashable) -> Tuple[int, int]:
        sid = self._open_bucket.get(group, -1)
        members = self.dict.bucket_members.get(sid)
        if sid < 0 or members is None or len(members) >= self.cfg.tag_bucket_keys:
            sid = self.mgr.new_stream(group, tagged=True)
            self.dict.bucket_members[sid] = []
            self._open_bucket[group] = sid
            members = self.dict.bucket_members[sid]
        tag = len(members)
        members.append(key)
        return sid, tag

    def _flush_bucket(
        self, group: int, sid: int,
        batch: List[Tuple[int, Optional[np.ndarray], np.ndarray]],
    ) -> List[Hashable]:
        """Append one merged tag-prefixed batch; return extraction candidates."""
        stream = self.mgr.streams[sid]
        # old EM remnants of joining keys come first (older doc ranges)
        groups: List[Tuple[np.ndarray, np.ndarray]] = []
        for which in (1, 2):  # 1: old EM posts, 2: this part's posts
            posts_list, tags_list = [], []
            for tag, old_posts, new_posts in batch:
                arr = old_posts if which == 1 else new_posts
                if arr is None or arr.size == 0:
                    continue
                posts_list.append(arr)
                tags_list.append(np.full(arr.shape[0], tag, dtype=np.int64))
            if not posts_list:
                continue
            posts = np.concatenate(posts_list, axis=0)
            tags = np.concatenate(tags_list, axis=0)
            order = np.lexsort((tags, posts[:, 1], posts[:, 0]))
            groups.append((posts[order], tags[order]))
        total_chunk = bytearray()
        prev_doc = stream.last_doc
        counts: Dict[int, int] = defaultdict(int)
        for posts, tags in groups:
            chunk = encode_postings(posts, tags=tags, prev_doc=prev_doc, zigzag=True)
            total_chunk += chunk
            prev_doc = int(posts[-1, 0])
            for t in tags:
                counts[int(t)] += 1
        if not total_chunk:
            return []
        self.mgr.append_stream(sid, bytes(total_chunk))
        stream.last_doc = prev_doc
        # apportion bytes to members by posting share (untagged-equivalent)
        n_total = sum(counts.values())
        per_posting = len(total_chunk) / max(1, n_total)
        members = self.dict.bucket_members[sid]
        out: List[Hashable] = []
        for tag, cnt in counts.items():
            key = members[tag]
            if key is None:
                continue
            e = self.dict.entries[key]
            e.nbytes += int(per_posting * cnt)
            if e.nbytes > self.cfg.tag_extract_bytes:
                out.append(key)
        return out

    def _extract_key(self, group: int, key: Hashable) -> None:
        """TAG extraction (5.6): pull one key out into a dedicated stream."""
        e = self.dict.entries[key]
        assert e.kind == K_TAG
        sid, tag = e.sid, e.tag
        data = self.mgr.read_stream(sid)  # charged: extraction is build I/O
        posts, tags = decode_postings(data, tagged=True, zigzag=True)
        mine = posts[tags == tag]
        order = np.lexsort((mine[:, 1], mine[:, 0]))
        mine = mine[order]
        keep = tags != tag
        rest_posts, rest_tags = posts[keep], tags[keep]
        rest_bytes = encode_postings(
            rest_posts, tags=rest_tags, prev_doc=0, zigzag=True
        ) if rest_posts.size else b""
        rest_last = int(rest_posts[-1, 0]) if rest_posts.size else 0
        self.mgr.rewrite_stream(sid, rest_bytes, rest_last)
        members = self.dict.bucket_members[sid]
        members[tag] = None  # tag slot retired
        new_sid = self.mgr.new_stream(group)
        chunk = encode_postings(mine, prev_doc=0)
        self.mgr.append_stream(new_sid, chunk)
        self.mgr.streams[new_sid].last_doc = int(mine[-1, 0]) if mine.size else 0
        e.kind, e.sid, e.tag = K_OWN, new_sid, -1
        e.nbytes = len(chunk)
        e.last_doc = int(mine[-1, 0]) if mine.size else 0
        self.n_extractions += 1

    # ------------------------------------------------------------- queries --
    def lookup(self, key: Hashable, device: Optional[BlockDevice] = None) -> np.ndarray:
        """Return the (N, 2) posting list for a key.

        I/O is charged to ``device`` when given (how readers separate
        search accounting from the build device — see
        ``repro_torch.search.reader``); otherwise to the build device."""
        e = self.dict.get(key)
        dev = device if device is not None else self.mgr.device
        if e is None:
            dev.read_small(ENTRY_FIXED_BYTES)  # repro-lint: allow(charge-accounting) port copy of the repro/core/inverted_index.py chokepoint
            return _EMPTY
        dev.read_small(ENTRY_FIXED_BYTES + len(key_bytes(key)) + len(e.data))  # repro-lint: allow(charge-accounting) port copy of the repro/core/inverted_index.py chokepoint
        if e.kind == K_EM:
            posts, _ = decode_postings(bytes(e.data))
            return posts
        data = self.mgr.read_stream(e.sid, device=dev)
        if e.kind == K_TAG:
            posts, tags = decode_postings(data, tagged=True, zigzag=True)
            mine = posts[tags == e.tag]
            order = np.lexsort((mine[:, 1], mine[:, 0]))
            return mine[order]
        posts, _ = decode_postings(data)
        return posts

    def open_cursor(
        self,
        key: Hashable,
        device: Optional[BlockDevice] = None,
        chunk_clusters: int = CURSOR_CHUNK_CLUSTERS,
        make_decoder: Optional[Callable[[], object]] = None,
        resume: Optional[CursorResume] = None,
        prefix: Optional[np.ndarray] = None,
    ) -> PostingCursor:
        """Lazy chunked :meth:`lookup`: the dictionary entry is read now,
        each posting storage unit only when the cursor fetches it.

        EM keys (list inline in the dictionary) and TAG keys (bucket
        streams interleave keys, so a partial read cannot isolate one
        key's sorted rows) degenerate to single-chunk cursors; dedicated
        (OWN) streams — where the large lists live — are fetched unit by
        unit in payload order, large segments split into ranges of at
        most ``chunk_clusters`` clusters.  Draining the cursor charges
        exactly the device bytes ``lookup`` charges.

        ``make_decoder`` swaps the incremental decoder on the OWN path
        (e.g. the device-backed one); ``resume`` + ``prefix`` replay a
        suspended drain: when the token still matches the stream's unit
        layout the already-decoded ``prefix`` rows become a zero-charge
        first chunk, the decoder carry is restored, and fetching starts
        at the first unconsumed unit (``cursor.resumed`` is True).  A
        stale token is ignored and the cursor opens fresh.
        """
        e = self.dict.get(key)
        dev = device if device is not None else self.mgr.device
        if e is None:
            dev.read_small(ENTRY_FIXED_BYTES)  # repro-lint: allow(charge-accounting) port copy of the repro/core/inverted_index.py chokepoint
            return PostingCursor.from_array(_EMPTY)
        dev.read_small(ENTRY_FIXED_BYTES + len(key_bytes(key)) + len(e.data))  # repro-lint: allow(charge-accounting) port copy of the repro/core/inverted_index.py chokepoint
        if e.kind == K_EM:
            posts, _ = decode_postings(bytes(e.data))
            return PostingCursor.from_array(posts)
        if e.kind == K_TAG:
            # one deferred chunk: charged only if the cursor is consumed.
            # The bucket BYTES are pinned at open time (bucket streams are
            # rewritten in place by extraction, and other members keep
            # appending): a cursor drained mid-update must deliver the
            # open-time snapshot, never the rewritten bucket — the charge
            # closures likewise price the open-time layout.
            units = self.mgr.stream_read_units(e.sid)
            charge_bytes = sum(cb for _, cb, _ in units)
            charges = [c for _, _, c in units]
            snap = self.mgr.stream_snapshot(e.sid)

            def read_tagged(snap=snap, tag=e.tag, charges=charges):
                for charge in charges:
                    charge(dev)
                posts, tags = decode_postings(snap, tagged=True, zigzag=True)
                mine = posts[tags == tag]
                order = np.lexsort((mine[:, 1], mine[:, 0]))
                return mine[order]

            return PostingCursor(
                [(charge_bytes, read_tagged)], max_doc_count=e.max_doc_count
            )
        # K_OWN: unit-by-unit fetch + incremental decode
        st = self.mgr.streams[e.sid]
        units = self.mgr.stream_read_units(e.sid, chunk_clusters=chunk_clusters)
        decoder = make_decoder() if make_decoder is not None else PostingDecoder()
        payloads = [pnb for pnb, _, _ in units]
        # resume validation: the token must describe THIS unit layout —
        # same chunking, a strict mid-stream cut, and a payload offset
        # that lands exactly on the consumed-units boundary.  Streams are
        # append-only between repacks, so a surviving prefix layout means
        # the consumed bytes are byte-identical to what was decoded.
        resumed = (
            resume is not None
            and resume.chunk_clusters == chunk_clusters
            and 0 < resume.units_consumed < len(units)
            and resume.payload_consumed == sum(payloads[: resume.units_consumed])
        )
        thunks: List[Tuple[int, Callable[[], np.ndarray]]] = []
        unit_index: List[Optional[int]] = []
        unit_payload: List[int] = []
        base_payload = 0
        start_unit = 0
        if resumed:
            decoder.set_state(resume.decoder_state)
            base_payload = resume.payload_consumed
            start_unit = resume.units_consumed
            if prefix is not None and prefix.shape[0]:
                thunks.append((0, lambda: prefix))
                unit_index.append(None)
                unit_payload.append(0)
        off = sum(payloads[:start_unit])
        for k in range(start_unit, len(units)):
            payload_nb, charge_nb, charge = units[k]
            lo, hi = off, off + payload_nb
            off = hi

            def fetch(lo=lo, hi=hi, charge=charge):
                charge(dev)
                posts, _ = decoder.feed(bytes(st.data[lo:hi]))
                return posts

            thunks.append((charge_nb, fetch))
            unit_index.append(k)
            unit_payload.append(payload_nb)
        cur = PostingCursor(
            thunks,
            max_doc_count=e.max_doc_count,
            suspend_ctx=_SuspendCtx(
                decoder=decoder,
                chunk_clusters=chunk_clusters,
                base_payload=base_payload,
                unit_index=unit_index,
                unit_payload=unit_payload,
            ),
        )
        cur.resumed = resumed
        return cur

    def lookup_ops(self, key: Hashable) -> int:
        """Device ops one search of this key costs (paper 5.7.3 criterion)."""
        e = self.dict.get(key)
        if e is None or e.kind == K_EM:
            return 1  # dictionary access
        return 1 + self.mgr.read_ops_estimate(e.sid)

    # ------------------------------------------------------------- reports --
    def stats(self) -> Dict[str, object]:
        return {
            "keys": len(self.dict.entries),
            "streams": len(self.mgr.streams),
            "extractions": self.n_extractions,
            "census": self.mgr.state_census(),
            "io": self.mgr.device.stats.as_dict(),
            "clusters": self.mgr.storage_clusters(),
        }
