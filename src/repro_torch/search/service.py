"""Batched proximity-search execution: plan → scatter-fetch → join → gather.

``SearchService`` is the read-side query processor, restructured as four
explicit stages so the same code path serves an unsharded
:class:`~repro_torch.core.text_index.TextIndexSet` (the 1-shard degenerate
case) and a :class:`~repro_torch.core.sharded_set.ShardedTextIndexSet`:

  1. **plan** — the batch is planned ONCE (:mod:`repro_torch.search.plan`);
     the lexicon/planner layer is shard-agnostic because document-hash
     sharding never changes which (index, key) lookups a query needs.
  2. **scatter-fetch** — the plan's unique lookups are walked in
     (index, dictionary-group) waves so group-mates amortize dictionary
     visits; every lookup is scattered to all shards of the reader.  A
     single-worker *prefetch pipeline* overlaps the NEXT wave's device
     fetches with the CURRENT wave's host-side join work: as soon as a
     query's last lookup lands, its phrase-chain / single-lookup result
     is finalized on the main thread while the worker is already reading
     the next (index, group) wave.  (One worker means exactly one thread
     ever touches the readers and the shared posting cache.)
  3. **join** — ordinary-route window joins from ALL (query, shard) jobs
     are executed together: with the ``torch`` backend they land in the
     same power-of-two ``(B, N, M)`` buckets, so sharding *increases*
     bucket occupancy (bigger launches) instead of multiplying kernel
     dispatches.  ``cuda`` routes each join through the hand-written
     membership kernel's doc-level prefilter; ``numpy`` is the exact
     host oracle.
  4. **gather** — per-shard results concatenate losslessly: shard doc
     sets are disjoint and per-shard arrays are (doc, pos)-ordered
     subsequences, so a stable merge on the doc column reconstructs the
     unsharded result element-wise.

All backends and all shard counts return results element-wise identical
to the unsharded numpy oracle.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.sharded_set import merge_shard_chunks, merge_shard_postings
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.search.join import (
    JOIN_BACKENDS,
    cuda_join_many,
    numpy_phrase_join,
    numpy_window_join,
    torch_join_many,
)
from repro_torch.search.plan import (
    ROUTE_MULTI,
    ROUTE_ORDINARY,
    ROUTE_STOPSEQ,
    ROUTE_WV,
    KeyLookup,
    MultiKeySpec,
    Query,
    QueryPlan,
    QueryResult,
    plan_batch,
)
from repro_torch.core.inverted_index import PostingCursor
from repro_torch.kernels.posting_decode.ops import DECODE_BACKENDS, DeviceDecoder
from repro_torch.search.pool import ChunkPool
from repro_torch.search.reader import IndexSetReader, ShardedIndexSetReader
from repro_torch.search.replica import ReplicaSetReader
from repro_torch.search.schema import validate_trace
from repro_torch.search.scoring import (
    doc_counts,
    head_order,
    max_doc_run,
    score_docs,
    score_docs_torch,
)

_EMPTY = np.zeros((0, 2), dtype=np.int64)
_INF = float("inf")


class TraceIncompleteError(RuntimeError):
    """The executor's trace failed the completeness invariant: a planned
    fetch wave / lookup / cursor chunk is neither recorded as executed nor
    as explicitly skipped.  Raised by
    :meth:`SearchService.check_trace_complete` — the guard that keeps the
    route-census/trace observability honest (an optimization that silently
    drops accounting would otherwise look like saved I/O)."""


class SnapshotViolationError(RuntimeError):
    """A writer advanced some shard's generation while a batch was
    executing against its pinned snapshot.  Every batch runs against the
    per-shard generation vector recorded at plan time
    (``last_trace['snapshot']``); a mid-batch update would mix posting
    lists from two collection states inside one result set, so the
    executor re-reads the vector after the gather stage and refuses to
    return torn results."""

QueryLike = Union[Query, Sequence[int]]

# per-shard posting lists of one fetched (index, key), in shard order
ShardPosts = List[np.ndarray]


def _as_query(q: QueryLike) -> Query:
    if isinstance(q, Query):
        return q
    return Query(tuple(int(w) for w in q))


class SearchService:
    """Planned, batched query execution over a (possibly sharded) index set.

    ``source`` is a ``TextIndexSet``/``ShardedTextIndexSet`` (a reader is
    built over it) or an existing ``IndexSetReader``/
    ``ShardedIndexSetReader``.  ``backend`` is ``"cuda"`` (the
    hand-written kernels) | ``"torch"`` (PyTorch operators on the
    device) | ``"numpy"`` (the host oracle) or any callable
    ``join(a, b, window) -> rows of a`` (executed per (query, shard)
    pair).  ``device`` is where the device backends run: ``None`` means
    the CUDA card and raises without one; the tests pass ``"cpu"``.
    ``prefetch=False`` disables the pipelined fetch worker (pure in-order
    fetching — same results, used by the equivalence tests as the
    sequential oracle).

    ``share_chunks`` pools the streaming stage's physical posting drains
    across the queries of one batch: N queries over the same hot
    (shard, index, key) read each chunk once and replay it N-1 times
    (``last_trace['topk']`` ledgers replays as ``chunks_shared``).
    ``device_decode`` swaps the OWN-stream varint decoder for the
    device-backed one and pins fully-drained hot lists as device
    buffers in the posting cache; defaults to on for the torch/cuda
    backends, off for numpy/callable (numpy with it on keeps the host
    decoder and only adds the device tier).  Both knobs change I/O and
    residency only — results stay element-wise identical.
    """

    def __init__(
        self,
        source,
        window: int = 3,
        backend: Union[str, Callable] = "cuda",
        cache_bytes: int = 8 << 20,
        use_multi: bool = True,
        prefetch: bool = True,
        share_chunks: bool = True,
        device_decode: Optional[bool] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if isinstance(
            source, (IndexSetReader, ShardedIndexSetReader, ReplicaSetReader)
        ):
            self.reader = source
        else:
            self.reader = source.reader(cache_bytes=cache_bytes)
        # replica-fabric failover counter at the last trace cut, so
        # last_trace['replicas'] can report the PER-BATCH delta
        self._failovers_seen = 0
        self.index_set = self.reader.index_set
        self.lexicon = self.reader.lexicon
        self.window = min(window, self.index_set.cfg.max_distance)
        self.prefetch = prefetch
        # observability for the pipeline stage: wave/overlap counters and
        # per-shard fetch seconds of the LAST search_batch call
        self.last_trace: Dict[str, object] = {}
        # multi-component route: available when the set built the multi
        # index and the caller did not opt out (use_multi=False forces
        # phrase queries down the ordinary path — the benchmark baseline)
        self.multi: Optional[MultiKeySpec] = None
        if use_multi and "multi" in self.index_set.indexes:
            mi = self.index_set.indexes["multi"]
            self.multi = MultiKeySpec(k=mi.k, pack=mi.pack,
                                      cover=mi.cover_keys)
        if callable(backend):
            self.backend: Union[str, Callable] = backend
        elif backend in JOIN_BACKENDS:
            self.backend = backend
        else:
            raise ValueError(
                f"unknown backend {backend!r}; expected one of "
                f"{sorted(JOIN_BACKENDS)} or a callable"
            )
        self.share_chunks = bool(share_chunks)
        if device_decode is None:
            device_decode = self.backend in ("torch", "cuda")
        self.device_decode = bool(device_decode)
        if self.device_decode:
            # numpy keeps its host decoder (the tier is still pinned on
            # the device); a callable join backend decodes with torch
            dec_backend = (
                self.backend if self.backend in DECODE_BACKENDS else "torch"
            )
            self._make_decoder: Optional[Callable[[], DeviceDecoder]] = (
                lambda: DeviceDecoder(backend=dec_backend, device=self.device)
            )
        else:
            self._make_decoder = None

    @property
    def n_shards(self) -> int:
        return self.reader.n_shards

    # ------------------------------------------------------------ planning --
    def plan(self, queries: Sequence[QueryLike]) -> QueryPlan:
        # per-query windows obey the same max_distance clamp as the default:
        # the stopseq/wv indexes are precomputed at max_distance, so a wider
        # ordinary-route join would give route-dependent semantics
        md = self.index_set.cfg.max_distance
        qs = [
            dataclasses.replace(q, window=min(q.window, md))
            if q.window is not None and q.window > md else q
            for q in map(_as_query, queries)
        ]
        return plan_batch(qs, self.lexicon, self.reader.group_of, self.window,
                          multi=self.multi, max_distance=md)

    # ----------------------------------------------------------- execution --
    def search(
        self,
        words: Sequence[int],
        window: Optional[int] = None,
        phrase: bool = False,
        top_k: Optional[int] = None,
        rank: Optional[str] = None,
    ) -> QueryResult:
        q = Query(tuple(int(w) for w in words), window, phrase=phrase,
                  top_k=top_k, rank=rank)
        return self.search_batch([q])[0]

    def search_batch(self, queries: Sequence[QueryLike]) -> List[QueryResult]:
        # pin the serving snapshot: apply any pending (targeted) cache
        # invalidations NOW, then record the per-shard generation vector
        # the whole batch executes against — a lookup mid-batch can never
        # observe a different collection state than the plan did
        self.reader.refresh()
        snapshot = list(self.reader.generation_vector())
        plan = self.plan(queries)                               # stage 1
        results: List[Optional[QueryResult]] = [None] * len(plan.queries)
        ordinary: List[Tuple[int, List[ShardPosts]]] = []
        posts: Dict[Tuple[str, int], ShardPosts] = {}

        # best-k queries take the streaming (lazy cursor) stage; their
        # lookups are deferred out of the batch scatter-fetch waves unless
        # a batch query also needs the same (index, key)
        streaming = [i for i, pq in enumerate(plan.queries)
                     if pq.top_k is not None]
        batch_idents = {
            (lk.index, lk.key)
            for pq in plan.queries if pq.top_k is None
            for lk in pq.lookups
        }

        # countdown of unlanded lookups per batch query, so each query
        # finalizes the moment its last wave lands (overlapping the next
        # fetch wave); streaming queries never enter the countdown
        pending = [
            len({(lk.index, lk.key) for lk in pq.lookups})
            if pq.top_k is None else -1
            for pq in plan.queries
        ]
        waiting: Dict[Tuple[str, int], List[int]] = {}
        for i, pq in enumerate(plan.queries):
            if pq.top_k is not None:
                continue
            for lk in pq.lookups:
                waiting.setdefault((lk.index, lk.key), [])
                if i not in waiting[(lk.index, lk.key)]:
                    waiting[(lk.index, lk.key)].append(i)

        def on_landed(idents: List[Tuple[str, int]]) -> int:
            done = 0
            for ident in idents:
                for qi in waiting.get(ident, ()):
                    pending[qi] -= 1
                    if pending[qi] == 0:
                        self._finalize(plan, qi, posts, results, ordinary)
                        done += 1
            return done

        self._scatter_fetch(plan, posts, on_landed, batch_idents)  # stage 2
        self.last_trace["snapshot"] = snapshot
        self._execute_ordinary(plan, ordinary, results)         # stages 3+4
        self._execute_streaming(plan, streaming, results, posts)  # top-k stage
        now = list(self.reader.generation_vector())
        if now != snapshot:
            raise SnapshotViolationError(
                f"shard generations moved {snapshot} -> {now} while the "
                f"batch executed against its pinned snapshot"
            )
        if getattr(self.reader, "is_replica_fabric", False):
            rt = self.reader.route_trace()
            rt["failovers_batch"] = rt["failovers"] - self._failovers_seen
            self._failovers_seen = rt["failovers"]
            self.last_trace["replicas"] = rt
        self.check_trace_complete(plan)
        # serving-health counters: cumulative posting-cache stats (the
        # full_drops count is THE regression signal for targeted
        # invalidation — it moves only when a reader fell back to a
        # whole-namespace sweep) and the substrate's background-compaction
        # totals, so traces tie a batch to the maintenance that preceded it
        cs = self.reader.cache_stats
        if cs is not None:
            self.last_trace["cache"] = {
                "hits": cs.hits,
                "misses": cs.misses,
                "evictions": cs.evictions,
                "invalidations": cs.invalidations,
                "full_drops": cs.full_drops,
                "bytes_used": cs.bytes_used,
                "pool_hits": cs.pool_hits,
                "device_hits": cs.device_hits,
                "partial_admits": cs.partial_admits,
            }
        comp = getattr(self.index_set, "compaction_stats", None)
        if comp is not None:
            self.last_trace["compactions"] = comp()
        return results

    # --------------------------------------------- stage 2: scatter-fetch --
    def _scatter_fetch(
        self,
        plan: QueryPlan,
        posts: Dict[Tuple[str, int], ShardPosts],
        on_landed: Callable[[List[Tuple[str, int]]], int],
        batch_idents: Optional[set] = None,
    ) -> None:
        """Fetch each unique (index, key) once from every shard, walking
        (index, group) waves in order so lookups of the same dictionary
        group run back to back.  With ``prefetch`` on, wave ``i+1``'s
        device reads run on a worker thread while wave ``i``'s completed
        queries finalize (host joins) on this thread.

        Lookups needed ONLY by best-k queries are *deferred* to the
        streaming stage (recorded, never silently dropped): a wave whose
        lookups all defer is an explicitly ``skipped_wave``.  The trace
        invariant ``waves == executed_waves + skipped_waves`` and
        ``lookups_planned == lookups_fetched + lookups_deferred`` is
        enforced by :meth:`check_trace_complete` after every batch."""
        S = self.n_shards
        shard_s = [0.0] * S
        trace = {"waves": 0, "executed_waves": 0, "skipped_waves": 0,
                 "lookups_planned": plan.n_unique_lookups,
                 "lookups_fetched": 0, "lookups_deferred": 0,
                 "prefetched_waves": 0,
                 "overlapped_finalizes": 0, "shard_fetch_s": shard_s}
        waves = []
        for gkey in sorted(plan.grouped):
            wave = plan.grouped[gkey]
            if batch_idents is not None:
                keep = [lk for lk in wave
                        if (lk.index, lk.key) in batch_idents]
            else:
                keep = wave
            trace["waves"] += 1
            trace["lookups_deferred"] += len(wave) - len(keep)
            if not keep:
                trace["skipped_waves"] += 1
                continue
            trace["executed_waves"] += 1
            trace["lookups_fetched"] += len(keep)
            waves.append(keep)

        # replica fabrics pin one replica per shard per fetch wave: the
        # in-flight-wave counter is the load signal routing balances on
        begin_wave = getattr(self.reader, "begin_wave", None)
        end_wave = getattr(self.reader, "end_wave", None)

        def fetch_wave(wave: List[KeyLookup]) -> List[Tuple[Tuple[str, int], ShardPosts]]:
            out = []
            if begin_wave is not None:
                begin_wave()
            try:
                for lk in wave:
                    per_shard: ShardPosts = []
                    for s in range(S):
                        t0 = time.perf_counter()
                        per_shard.append(
                            self.reader.lookup_shard(s, lk.index, lk.key)
                        )
                        shard_s[s] += time.perf_counter() - t0
                    out.append(((lk.index, lk.key), per_shard))
            finally:
                if end_wave is not None:
                    end_wave()
            return out

        def land(fetched, overlapping: bool) -> None:
            for ident, per_shard in fetched:
                posts[ident] = per_shard
            n = on_landed([ident for ident, _ in fetched])
            if overlapping:
                trace["overlapped_finalizes"] += n

        if not self.prefetch or len(waves) <= 1:
            for wave in waves:
                land(fetch_wave(wave), overlapping=False)
        else:
            # exactly ONE worker: the readers and the shared posting cache
            # are only ever touched from the worker thread during the
            # pipeline, while this thread runs the finalize joins
            with ThreadPoolExecutor(max_workers=1) as pool:
                fut = pool.submit(fetch_wave, waves[0])
                for i in range(len(waves)):
                    fetched = fut.result()
                    overlapping = i + 1 < len(waves)
                    if overlapping:
                        fut = pool.submit(fetch_wave, waves[i + 1])
                        trace["prefetched_waves"] += 1
                    land(fetched, overlapping)
        self.last_trace = trace

    # --------------------------------------- per-query assembly + gather --
    def _finalize(
        self,
        plan: QueryPlan,
        qi: int,
        posts: Dict[Tuple[str, int], ShardPosts],
        results: List[Optional[QueryResult]],
        ordinary: List[Tuple[int, List[ShardPosts]]],
    ) -> None:
        """All lookups of query ``qi`` have landed: finalize every route
        except the ordinary window join, which is deferred so all
        (query, shard) jobs share the stage-3 buckets."""
        pq = plan.queries[qi]
        fetched = [posts[(lk.index, lk.key)] for lk in pq.lookups]
        log = [(lk.index, lk.key) for lk in pq.lookups]
        scanned = sum(a.shape[0] for per_shard in fetched for a in per_shard)
        if pq.route == ROUTE_ORDINARY and not pq.query.phrase:
            ordinary.append((qi, fetched))
            results[qi] = QueryResult(_EMPTY[:, 0], _EMPTY, log, scanned,
                                      pq.route)
        elif pq.route == ROUTE_MULTI or pq.route == ROUTE_ORDINARY:
            # phrase reconstruction: lookup j's records must sit at
            # start+j (multi: k-gram at word offset j; ordinary phrase:
            # word j itself) — staged exact host joins, chained per shard
            # (disjoint doc sets) and gathered by stable doc merge
            acc = merge_shard_postings([
                self._phrase_chain([f[s] for f in fetched])
                for s in range(self.n_shards)
            ])
            docs, counts = np.unique(acc[:, 0], return_counts=True)
            results[qi] = QueryResult(docs, acc, log, scanned, pq.route,
                                      counts)
        else:
            p = merge_shard_postings(fetched[0])
            docs, counts = np.unique(p[:, 0], return_counts=True)
            results[qi] = QueryResult(docs, p, log, scanned, pq.route,
                                      counts)

    @staticmethod
    def _phrase_chain(fetched: List[np.ndarray]) -> np.ndarray:
        acc = fetched[0]
        for dist, nxt in enumerate(fetched[1:], start=1):
            acc = numpy_phrase_join(acc, nxt, dist)
        return acc

    # ---------------------- stage 3: bucketed window joins, stage 4: gather --
    def _execute_ordinary(
        self,
        plan: QueryPlan,
        jobs: List[Tuple[int, List[ShardPosts]]],
        results: List[Optional[QueryResult]],
    ) -> None:
        # state per (query, shard) job: accumulator + lists still to join.
        # Every shard of every query joins in the same rounds, so one torch
        # bucket holds jobs from the whole batch AND all shards.
        S = self.n_shards
        accs: Dict[Tuple[int, int], np.ndarray] = {}
        rest: Dict[Tuple[int, int], List[np.ndarray]] = {}
        for qi, fetched in jobs:
            for s in range(S):
                accs[(qi, s)] = fetched[0][s]
                rest[(qi, s)] = [f[s] for f in fetched[1:]]
        while any(rest.values()):
            round_ids = [k for k in accs if rest[k]]
            pairs = [
                (accs[k], rest[k].pop(0), plan.queries[k[0]].window)
                for k in round_ids
            ]
            for k, joined in zip(round_ids, self._join_many(pairs)):
                accs[k] = joined
        for qi, _ in jobs:
            acc = merge_shard_postings([accs[(qi, s)] for s in range(S)])
            r = results[qi]
            docs, counts = np.unique(acc[:, 0], return_counts=True)
            results[qi] = QueryResult(
                docs, acc, r.lookups, r.postings_scanned, r.route, counts,
            )

    def _join_many(
        self, pairs: List[Tuple[np.ndarray, np.ndarray, int]]
    ) -> List[np.ndarray]:
        if callable(self.backend):
            return [self.backend(a, b, w) for a, b, w in pairs]
        if self.backend == "torch":
            # one batched searchsorted per power-of-two bucket
            return torch_join_many(pairs, device=self.device)
        if self.backend == "cuda":
            # the round's doc prefilter in one membership launch
            return cuda_join_many(pairs, device=self.device)
        return [numpy_window_join(a, b, w) for a, b, w in pairs]

    # ------------------------------- streaming top-k stage (lazy cursors) --
    def _execute_streaming(
        self,
        plan: QueryPlan,
        streaming: List[int],
        results: List[Optional[QueryResult]],
        posts: Optional[Dict[Tuple[str, int], ShardPosts]] = None,
    ) -> None:
        """Serve every best-k query through lazy cursors, aggregating the
        chunks-fetched/skipped and bytes-saved observability into
        ``last_trace['topk']``.  ``posts`` carries the batch stage's
        already-fetched lookups: a key shared with a batch query streams
        from those rows at zero extra device I/O instead of re-reading.

        With ``share_chunks`` a batch-lifetime :class:`ChunkPool`
        deduplicates the physical drains: queries hitting the same
        (shard, index, key) replay pooled chunks (``chunks_shared``)
        instead of re-fetching.  After the whole batch, every physical
        cursor that early-terminated is *settled* — its decoded prefix
        and resume token go to the cache's partial tier, so the NEXT
        batch of the same hot keys replays the prefix at zero I/O."""
        if not streaming:
            return
        t = {"queries": len(streaming), "ranked_queries": 0,
             # per-query stop classification: every streaming query ends
             # exactly one way — ranked threshold stop, doc-id bound stop,
             # or full drain (check_trace_complete enforces the partition)
             "early_terminated": 0, "threshold_stops": 0, "bound_stops": 0,
             "fully_drained": 0, "threshold_checks": 0,
             "chunks_planned": 0, "chunks_fetched": 0, "chunks_skipped": 0,
             "chunks_shared": 0,
             "bytes_planned": 0, "bytes_fetched": 0, "bytes_skipped": 0,
             "bytes_shared": 0,
             "query_s": []}
        pool = (
            ChunkPool(stats=self.reader.cache_stats)
            if self.share_chunks else None
        )
        # physical ReaderCursors opened by this stage (pooled: one per
        # distinct identity), settled once after the batch
        settle: List[object] = []
        for qi in streaming:
            t0 = time.perf_counter()
            results[qi] = self._search_topk(plan.queries[qi], t,
                                            posts or {}, pool, settle)
            t["query_s"].append(time.perf_counter() - t0)
        t["pool_streams"] = len(pool) if pool is not None else 0
        for rc in settle:
            settler = getattr(rc, "settle", None)
            if settler is not None:
                settler()
        self.last_trace["topk"] = t

    def _search_topk(
        self,
        pq,
        trace: Dict[str, int],
        posts: Dict[Tuple[str, int], ShardPosts],
        pool: Optional[ChunkPool] = None,
        settle: Optional[List[object]] = None,
    ) -> QueryResult:
        """Best-k execution of one query over per-(lookup, shard) cursors.

        Every cursor delivers its key's postings in (doc, pos) order, so a
        cursor's *settled bound* — the doc id of its last delivered row
        (``+inf`` once exhausted) — is a lower bound on everything it has
        not delivered yet: no future chunk of any cursor can produce a
        match in a doc strictly below the minimum bound over all cursors.
        The loop joins the settled prefix region by region, and stops
        fetching by the mode's rule:

        * **doc-id mode** (``rank=None``): stop the moment ``k`` matching
          docs lie below the global bound — the lowest-id best-k set is
          provably final, remaining chunks are skipped.
        * **ranked mode** (``rank="prox"``): the WAND-style threshold
          test.  Every settled doc's score is exact (its region held ALL
          slot postings); every *unsettled* doc's score is bounded by the
          sum over slots of ``w_slot * tf_sat(max_doc_count)``, where an
          exhausted slot's bound is refined to the actual max over its
          still-pending rows (in particular: an exhausted slot with no
          pending rows kills every future match — conjunctive death).
          Stop once the k-th best settled score >= that remaining upper
          bound: a candidate can at best TIE the k-th score, and every
          candidate's doc id exceeds the bound (hence every settled id),
          so under the (score desc, doc id asc) tie rule it cannot enter
          the head.  See DESIGN_SEARCH.md §9 for the full argument.

        Either way, exhaustion of every cursor degenerates to the
        exhaustive answer, and per-shard cursors merge by the same global
        bound, so scatter/gather and the 1-shard case share one code path.
        """
        k = pq.top_k
        ranked = pq.rank is not None
        spec = pq.score_spec
        S = self.n_shards
        # one cursor per unique (index, key) — a repeated lookup inside
        # one query (e.g. a periodic phrase's cover) shares the stream
        idents: List[KeyLookup] = []
        slot: Dict[Tuple[str, int], int] = {}
        for lk in pq.lookups:
            ident = (lk.index, lk.key)
            if ident not in slot:
                slot[ident] = len(idents)
                idents.append(lk)
        lookup_slots = [slot[(lk.index, lk.key)] for lk in pq.lookups]

        def open_physical(s: int, lk: KeyLookup):
            fetched = posts.get((lk.index, lk.key))
            if fetched is not None:
                # the batch waves already read this key: stream its rows
                # as one zero-I/O chunk (same shape as a cache hit)
                return PostingCursor.from_array(fetched[s])
            c = self.reader.open_cursor_shard(
                s, lk.index, lk.key,
                make_decoder=self._make_decoder,
                device_tier=self.device if self.device_decode else None,
            )
            if settle is not None:
                settle.append(c)
            return c

        def open_cursor(s: int, lk: KeyLookup):
            if pool is None:
                return open_physical(s, lk)
            # pool identity is the full (shard, index, key): shards hold
            # disjoint doc sets and must never share a drain
            return pool.cursor(
                (s, lk.index, lk.key),
                lambda s=s, lk=lk: open_physical(s, lk),
            )

        cursors = [
            [open_cursor(s, lk) for s in range(S)]
            for lk in idents
        ]
        flat = [c for row in cursors for c in row]

        key_max: List[int] = []
        if ranked:
            trace["ranked_queries"] += 1
            # static per-key score bound ingredient: the key's largest
            # per-doc posting count, carried as cursor metadata from the
            # dictionary entry (array-backed cursors compute it from
            # their rows).  A doc lives in exactly one shard, so the max
            # over the shard row bounds every doc the key can deliver.
            key_max = [max(c.max_doc_count for c in row) for row in cursors]

        # incremental settled-region execution: matches are per-doc (no
        # join crosses a doc boundary), so joining ONLY the newly settled
        # [prev_bound, bound) rows each round and appending reproduces the
        # full-prefix join — every delivered row is merged and joined once
        pending: List[np.ndarray] = [_EMPTY] * len(idents)
        fresh: List[List[List[np.ndarray]]] = [
            [[] for _ in range(S)] for _ in idents
        ]
        # deliver every PREPAID chunk up front — resumed settled
        # prefixes, cache-hit rows, pooled prefix replays: they cost
        # zero device bytes, and delivering them now seeds each cursor's
        # settled bound before the first fetch round instead of leaving
        # a warm cursor at -inf.  The bound itself stays delivery-based:
        # seeding a bound whose rows were NOT delivered would let a
        # region cut below it lose matches.
        for i, row in enumerate(cursors):
            for s, c in enumerate(row):
                while not c.exhausted and getattr(c, "prepaid", False):
                    chunk = c.next_chunk()
                    if chunk is not None and chunk.shape[0]:
                        fresh[i][s].append(chunk)
        acc_parts: List[np.ndarray] = []
        doc_parts: List[np.ndarray] = []
        score_parts: List[np.ndarray] = []
        n_docs = 0
        prev_bound = -_INF
        while True:
            bound = min(c.settled_bound for c in flat)
            if bound > prev_bound:
                region = []
                for i in range(len(idents)):
                    merged = merge_shard_chunks([[pending[i]]] + fresh[i])
                    fresh[i] = [[] for _ in range(S)]
                    if bound < _INF:
                        cut = int(np.searchsorted(merged[:, 0], bound))
                        region.append(merged[:cut])
                        pending[i] = merged[cut:]
                    else:
                        region.append(merged)
                        pending[i] = _EMPTY
                part = self._streaming_join(
                    pq, [region[i] for i in lookup_slots]
                )
                if part.shape[0]:
                    acc_parts.append(part)
                    rdocs = np.unique(part[:, 0])
                    n_docs += int(rdocs.shape[0])
                    if ranked:
                        # score the region's docs NOW: the region holds
                        # every slot posting of every settled doc, so the
                        # per-slot counts — hence the scores — are exact
                        doc_parts.append(rdocs)
                        counts = [doc_counts(rdocs, region[i])
                                  for i in lookup_slots]
                        score_parts.append(self._score(counts, spec))
                prev_bound = bound
                if bound == _INF:
                    break
                if ranked:
                    if self._ranked_stop(trace, cursors, pending, key_max,
                                         lookup_slots, spec, score_parts,
                                         n_docs, k):
                        break
                elif n_docs >= k:
                    break
            elif bound == _INF:  # nothing newly settled and all drained
                break
            # advance the laggards: every cursor sitting at the bound is
            # fetched until it clears it (every such chunk is required
            # before the global bound can rise), so the bound strictly
            # increases per round
            for i, row in enumerate(cursors):
                for s, c in enumerate(row):
                    while not c.exhausted and c.settled_bound <= bound:
                        chunk = c.next_chunk()
                        if chunk is not None and chunk.shape[0]:
                            fresh[i][s].append(chunk)

        acc = (
            acc_parts[0] if len(acc_parts) == 1
            else np.concatenate(acc_parts, axis=0) if acc_parts
            else _EMPTY
        )

        # stop-reason ledger: every streaming query lands in exactly one
        # bucket (check_trace_complete enforces the partition per batch)
        if any(not c.exhausted for c in flat):
            trace["early_terminated"] += 1
            trace["threshold_stops" if ranked else "bound_stops"] += 1
        else:
            trace["fully_drained"] += 1
        for c in flat:
            trace["chunks_planned"] += c.chunks_total
            trace["chunks_fetched"] += c.chunks_fetched
            trace["chunks_skipped"] += c.chunks_skipped
            trace["chunks_shared"] += c.chunks_shared
            trace["bytes_planned"] += c.bytes_total
            trace["bytes_fetched"] += c.bytes_fetched
            trace["bytes_skipped"] += c.bytes_skipped
            trace["bytes_shared"] += c.bytes_shared

        log = [(lk.index, lk.key) for lk in pq.lookups]
        # count delivered postings per LOOKUP OCCURRENCE (a duplicated
        # cover key streams once but is scanned by both positions), so a
        # full drain reports exactly the batch stage's postings_scanned
        per_ident = [sum(c.postings_delivered for c in row)
                     for row in cursors]
        scanned = sum(per_ident[i] for i in lookup_slots)

        if ranked:
            zero = np.zeros(0, dtype=np.int64)
            docs_all = np.concatenate(doc_parts) if doc_parts else zero
            scores_all = np.concatenate(score_parts) if score_parts else zero
            order = head_order(docs_all, scores_all, k, ranked=True)
            top_docs = docs_all[order]
            witnesses = (acc[np.isin(acc[:, 0], top_docs)]
                         if acc.shape[0] else acc)
            return QueryResult(top_docs, witnesses, log, scanned, pq.route,
                               scores_all[order])

        docs, counts = np.unique(acc[:, 0], return_counts=True)
        order = head_order(docs, counts, k, ranked=False)
        top_docs = docs[order]
        witnesses = acc[np.isin(acc[:, 0], top_docs)] if acc.shape[0] else acc
        return QueryResult(top_docs, witnesses, log, scanned, pq.route,
                           counts[order])

    def _score(self, slot_counts, spec) -> np.ndarray:
        """Backend dispatch for region scoring: torch/cuda score on the
        device, everything else with the numpy reference — all-integer
        arithmetic, so the outputs are bit-identical."""
        if self.backend in ("torch", "cuda"):
            return score_docs_torch(slot_counts, spec, device=self.device)
        return score_docs(slot_counts, spec)

    def _ranked_stop(
        self,
        trace: Dict[str, int],
        cursors,
        pending: List[np.ndarray],
        key_max: List[int],
        lookup_slots: List[int],
        spec,
        score_parts: List[np.ndarray],
        n_docs: int,
        k: int,
    ) -> bool:
        """The WAND threshold test at the current global bound.

        Upper-bounds the score of every not-yet-settled doc: slot by
        slot, a candidate's posting count is at most the key's lifetime
        ``max_doc_count`` — refined, once a key's cursors are all
        exhausted, to the exact max over its still-pending rows (all of
        which sit at or above the bound).  An exhausted key with an empty
        pending region can never witness another match (the joins are
        conjunctive): stop immediately regardless of how many docs have
        settled.  Otherwise stop iff k docs have settled and the k-th
        best settled score already meets the bound (a candidate tie
        loses on doc id — candidates sit above every settled doc).
        """
        trace["threshold_checks"] += 1
        per_ident: List[int] = []
        for i, row in enumerate(cursors):
            if all(c.exhausted for c in row):
                cnt = max_doc_run(pending[i])
                if cnt == 0:
                    return True  # conjunctive death: no future match
            else:
                cnt = key_max[i]
            per_ident.append(cnt)
        ub = sum(
            spec.weights[s] * min(per_ident[ident], spec.tf_cap)
            for s, ident in enumerate(lookup_slots)
        )
        if n_docs < k:
            return False
        scores = (score_parts[0] if len(score_parts) == 1
                  else np.concatenate(score_parts))
        theta = int(np.partition(scores, scores.shape[0] - k)
                    [scores.shape[0] - k])
        return theta >= ub

    def _streaming_join(
        self, pq, prefix: List[np.ndarray]
    ) -> np.ndarray:
        """Join the settled prefix of every lookup — the same staged exact
        joins as the batch stage, on the numpy oracle path (prefixes are
        small by construction: the loop stops at ~k matching docs)."""
        if pq.route in (ROUTE_STOPSEQ, ROUTE_WV):
            return prefix[0]
        acc = prefix[0]
        if pq.route == ROUTE_MULTI or pq.query.phrase:
            for dist, nxt in enumerate(prefix[1:], start=1):
                acc = numpy_phrase_join(acc, nxt, dist)
        else:
            for nxt in prefix[1:]:
                acc = numpy_window_join(acc, nxt, pq.window)
        return acc

    # ------------------------------------------- trace completeness guard --
    def check_trace_complete(self, plan: Optional[QueryPlan] = None) -> None:
        """Assert every planned fetch was either executed or explicitly
        skipped/deferred in ``last_trace`` (and, for the streaming stage,
        every cursor chunk either fetched or skipped).  Runs after every
        ``search_batch``; raises :class:`TraceIncompleteError` so a future
        edit that drops a wave without accounting for it fails loudly
        instead of masquerading as saved I/O."""
        tr = self.last_trace
        # schema gate first: the runtime trace and the static registry in
        # repro_torch.search.schema must agree on the key set, so an undeclared
        # key fails here even when no completeness partition involves it
        msg = validate_trace(tr)
        if msg:
            raise TraceIncompleteError(msg)
        if "snapshot" not in tr:
            raise TraceIncompleteError(
                "trace carries no pinned snapshot generation vector"
            )
        if tr.get("waves", 0) != (
            tr.get("executed_waves", 0) + tr.get("skipped_waves", 0)
        ):
            raise TraceIncompleteError(
                f"waves {tr.get('waves')} != executed "
                f"{tr.get('executed_waves')} + skipped "
                f"{tr.get('skipped_waves')}"
            )
        if tr.get("lookups_planned", 0) != (
            tr.get("lookups_fetched", 0) + tr.get("lookups_deferred", 0)
        ):
            raise TraceIncompleteError(
                f"lookups planned {tr.get('lookups_planned')} != fetched "
                f"{tr.get('lookups_fetched')} + deferred "
                f"{tr.get('lookups_deferred')}"
            )
        if plan is not None and tr.get("lookups_planned") != plan.n_unique_lookups:
            raise TraceIncompleteError(
                f"trace covers {tr.get('lookups_planned')} lookups, plan "
                f"has {plan.n_unique_lookups}"
            )
        rb = tr.get("replicas")
        if rb is not None:
            # per-replica staleness bound against the batch's pinned
            # snapshot: no replica may have consumed the digest stream
            # PAST the snapshot (it would have served a newer collection
            # state into this batch), and every LIVE replica must sit
            # exactly AT it (refresh() catches live replicas up before
            # the snapshot is pinned; dead replicas may lag — they serve
            # nothing until revived)
            snap = tr["snapshot"]
            for s, row in enumerate(rb["snapshot"]):
                for r, gv in enumerate(row):
                    if any(g > w for g, w in zip(gv, snap[s])):
                        raise TraceIncompleteError(
                            f"replica s{s}r{r} generation vector {gv} runs "
                            f"AHEAD of the pinned snapshot {list(snap[s])}"
                        )
                    if rb["live"][s][r] and list(gv) != list(snap[s]):
                        raise TraceIncompleteError(
                            f"live replica s{s}r{r} at {gv} is stale "
                            f"against the pinned snapshot {list(snap[s])}"
                        )
        tk = tr.get("topk")
        if tk is not None:
            # per-query stop partition: every streaming query ended
            # exactly one way, and "early_terminated" is a true per-query
            # COUNT (it used to accumulate a bool per batch, conflating
            # "how many stopped early" with "did any stop early")
            if tk["queries"] != tk["early_terminated"] + tk["fully_drained"]:
                raise TraceIncompleteError(
                    f"streaming queries {tk['queries']} != early_terminated "
                    f"{tk['early_terminated']} + fully_drained "
                    f"{tk['fully_drained']}"
                )
            if tk["early_terminated"] != (
                tk["threshold_stops"] + tk["bound_stops"]
            ):
                raise TraceIncompleteError(
                    f"early_terminated {tk['early_terminated']} != "
                    f"threshold_stops {tk['threshold_stops']} + bound_stops "
                    f"{tk['bound_stops']}"
                )
            if not 0 <= tk["ranked_queries"] <= tk["queries"]:
                raise TraceIncompleteError(
                    f"ranked_queries {tk['ranked_queries']} outside "
                    f"[0, {tk['queries']}]"
                )
            # shared chunks are replays of a chunk some OTHER view of the
            # same pooled stream physically fetched: per cursor view,
            # planned partitions into fetched (this view paid the I/O),
            # shared (replayed from the pool at zero I/O) and skipped —
            # so summed over a batch, chunks_fetched counts every
            # physical chunk EXACTLY once however many queries read it
            shared = tk.get("chunks_shared", 0)
            if tk["chunks_planned"] != (
                tk["chunks_fetched"] + tk["chunks_skipped"] + shared
            ):
                raise TraceIncompleteError(
                    f"cursor chunks planned {tk['chunks_planned']} != "
                    f"fetched {tk['chunks_fetched']} + skipped "
                    f"{tk['chunks_skipped']} + shared {shared}"
                )
            bshared = tk.get("bytes_shared", 0)
            if tk["bytes_planned"] != (
                tk["bytes_fetched"] + tk["bytes_skipped"] + bshared
            ):
                raise TraceIncompleteError(
                    f"cursor bytes planned {tk['bytes_planned']} != "
                    f"fetched {tk['bytes_fetched']} + skipped "
                    f"{tk['bytes_skipped']} + shared {bshared}"
                )
