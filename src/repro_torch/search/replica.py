"""Replica read fabric: N read replicas per shard behind one scatter surface.

The paper's updatability claim (arXiv:2007.09377) keeps WRITE cost flat
while parts stream in; read qps is scaled the other way — by fanning
each shard's digest stream out to N replica readers (the serve side of
the build/serve split in arXiv:2006.07954).  Writers stay single-owner:
a replica never mutates index state, it *subscribes*.

Topology (one fabric = the whole serving tier)::

    shard 0 writer ──digests──► ReplicaReader(s0,r0) ─┐
                   └──────────► ReplicaReader(s0,r1) ─┤
    shard 1 writer ──digests──► ReplicaReader(s1,r0) ─┼─► ReplicaSetReader
                   └──────────► ReplicaReader(s1,r1) ─┘   (routing+failover)

Each :class:`ReplicaReader` is one (shard, replica): per-index
:class:`~repro_torch.search.reader.IndexReader` snapshots over the shard's
published storage with the replica's OWN posting cache and OWN search
devices (``s{shard}r{replica}/{index}-read``), so read I/O is charged —
and capacity measured — per replica.  Catch-up consumes the shard
writer's touched-key digest stream (``digests_since``): a replica
within the bounded digest history invalidates exactly the touched keys;
one behind it falls back to the existing whole-namespace drop.  Both
modes are ledgered per replica.

Routing: ``SearchService`` pins one replica per shard per *fetch wave*
(:meth:`ReplicaSetReader.begin_wave` — least-loaded live replica by the
in-flight-wave counter, ties by waves served).  A replica that dies
mid-wave (the injectable ``fault`` hook, or an explicit :meth:`kill`)
raises :class:`ReplicaDeadError`; the fabric marks it dead, counts a
failover, and re-pins a live sibling — results stay element-wise
identical to the single-reader path because every replica serves the
same published snapshot.

Staleness bound: ``last_trace['replicas']`` carries every replica's
generation vector next to the batch's pinned snapshot;
``check_trace_complete`` asserts no replica runs AHEAD of the snapshot
and every live replica is exactly AT it (dead replicas may lag — they
catch up on revive, targeted or full-drop).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, List, Optional

import numpy as np
import torch

from repro_torch.core.io_sim import BlockDevice, IOStats
from repro_torch.search.reader import (
    IndexReader,
    PostingCache,
    ReaderCursor,
)


class ReplicaDeadError(RuntimeError):
    """Raised when a serve hits a dead (or fault-injected) replica; the
    fabric catches it and fails over to a live sibling."""


class AllReplicasDeadError(RuntimeError):
    """No live replica is left for a shard — nothing to fail over to."""


class ReplicaReader:
    """One (shard, replica): per-index readers over the shard's published
    storage, with this replica's own cache, devices and catch-up ledger."""

    def __init__(
        self,
        shard_id: int,
        replica_id: int,
        shard_set,
        cache_bytes: int = 8 << 20,
        targeted: bool = True,
    ):
        self.shard_id = int(shard_id)
        self.replica_id = int(replica_id)
        self.shard_set = shard_set
        self.cache = PostingCache(cache_bytes) if cache_bytes > 0 else None
        ns = f"s{self.shard_id}r{self.replica_id}"
        # per-replica search devices: replica capacity and read traffic
        # are measured per replica, never pooled into the writer's devices
        self.devices: Dict[str, BlockDevice] = {
            name: BlockDevice(
                cluster_size=idx.cfg.cluster_size,
                name=f"{ns}/{name}-read",
            )
            for name, idx in shard_set.indexes.items()
        }
        self.readers: Dict[str, IndexReader] = {
            name: IndexReader(
                idx,
                device=self.devices[name],
                cache=self.cache,
                cache_ns=f"{ns}:{name}",
                targeted=targeted,
            )
            for name, idx in shard_set.indexes.items()
        }
        self.live = True
        # routing load signals: waves currently in flight on this replica
        # plus waves served overall (the tiebreak that round-robins)
        self.inflight = 0
        self.waves_served = 0
        self.lookups_served = 0
        self.cursors_served = 0
        # accumulated real serve seconds — the capacity denominator the
        # --replicas bench scales by
        self.busy_s = 0.0
        # injectable fault hook: called before every serve as
        # ``fault(replica, op)``; raise ReplicaDeadError to simulate a
        # crash mid-batch (the fabric then marks this replica dead and
        # fails the wave over to a sibling)
        self.fault: Optional[Callable[["ReplicaReader", str], None]] = None
        self.failures = 0
        # digest-stream consumption ledger, by catch-up mode
        self.catch_ups = {"current": 0, "targeted": 0, "full_drop": 0}

    # ------------------------------------------------------------- serving --
    def _check(self, op: str) -> None:
        if self.fault is not None:
            self.fault(self, op)
        if not self.live:
            raise ReplicaDeadError(
                f"replica s{self.shard_id}r{self.replica_id} is down"
            )

    def lookup(self, index_name: str, key: Hashable) -> np.ndarray:
        self._check("lookup")
        t0 = time.perf_counter()
        try:
            return self.readers[index_name].lookup(key)
        finally:
            self.busy_s += time.perf_counter() - t0
            self.lookups_served += 1

    def open_cursor(
        self, index_name: str, key: Hashable,
        make_decoder=None, device_tier: Optional[torch.device] = None,
    ) -> ReaderCursor:
        self._check("cursor")
        t0 = time.perf_counter()
        try:
            return self.readers[index_name].open_cursor(
                key, make_decoder=make_decoder, device_tier=device_tier
            )
        finally:
            self.busy_s += time.perf_counter() - t0
            self.cursors_served += 1

    # ---------------------------------------------------------- subscribing --
    def catch_up(self) -> List[str]:
        """Consume the shard writer's digest stream: every index reader
        refreshes from its pinned published generation — targeted drops
        within the bounded digest history, the whole-namespace fallback
        behind it.  Returns the per-index modes taken."""
        modes = [r.refresh() for r in self.readers.values()]
        for m in modes:
            self.catch_ups[m] += 1
        return modes

    def generation_vector(self) -> List[int]:
        """This replica's pinned per-index published generations — its
        position on the digest stream (lags the writer while dead)."""
        return [r._generation for r in self.readers.values()]

    def lag(self) -> int:
        """Generations behind the writer (max over indexes)."""
        return max(
            r.index.generation - r._generation
            for r in self.readers.values()
        )

    # -------------------------------------------------------------- faults --
    def kill(self) -> None:
        self.live = False

    def revive(self, catch_up: bool = True) -> List[str]:
        """Bring the replica back; by default it catches up on the digest
        stream immediately (behind the bounded history this is the
        namespace-drop path — the ledger records which)."""
        self.live = True
        self.fault = None
        return self.catch_up() if catch_up else []

    def io_stats(self) -> Dict[str, IOStats]:
        return {name: d.stats.snapshot() for name, d in self.devices.items()}

    def read_bytes(self) -> int:
        return sum(s.read_bytes for s in self.io_stats().values())


class _FabricCacheStats:
    """Aggregate cache-stats view over every replica's private cache.

    Quacks like :class:`~repro_torch.search.reader.CacheStats` for the
    service's trace block; ``pool_hits`` is a REAL attribute (the batch
    ``ChunkPool`` increments it in place) layered over the replicas'
    own counters."""

    def __init__(self, caches: List[PostingCache]):
        self._caches = caches
        self.pool_hits_extra = 0

    def _sum(self, field: str) -> int:
        return sum(getattr(c.stats, field) for c in self._caches)

    @property
    def hits(self) -> int:
        return self._sum("hits")

    @property
    def misses(self) -> int:
        return self._sum("misses")

    @property
    def evictions(self) -> int:
        return self._sum("evictions")

    @property
    def invalidations(self) -> int:
        return self._sum("invalidations")

    @property
    def full_drops(self) -> int:
        return self._sum("full_drops")

    @property
    def bytes_used(self) -> int:
        return self._sum("bytes_used")

    @property
    def device_hits(self) -> int:
        return self._sum("device_hits")

    @property
    def partial_admits(self) -> int:
        return self._sum("partial_admits")

    @property
    def pool_hits(self) -> int:
        return self._sum("pool_hits") + self.pool_hits_extra

    @pool_hits.setter
    def pool_hits(self, value: int) -> None:
        self.pool_hits_extra = value - self._sum("pool_hits")

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class ReplicaSetReader:
    """N replicas per shard behind the standard reader scatter surface.

    Drop-in for :class:`~repro_torch.search.reader.ShardedIndexSetReader`
    (``n_shards`` / ``lookup_shard`` / ``open_cursor_shard`` /
    ``group_of`` / ``refresh`` / ``generation_vector`` /
    ``cache_stats``), plus the wave-routing surface ``SearchService``
    pins fetch waves with (:meth:`begin_wave` / :meth:`end_wave`) and
    the failover loop.  ``generation_vector()`` reports the WRITERS'
    published truth (that is what a batch pins); per-replica positions
    are a separate observable (:meth:`replica_generations`).
    """

    # duck-type marker SearchService keys the routing/trace extras on
    is_replica_fabric = True

    def __init__(
        self,
        source,
        n_replicas: int = 2,
        cache_bytes: int = 8 << 20,
        targeted: bool = True,
    ):
        if n_replicas < 1:
            raise ValueError(f"need at least one replica, got {n_replicas}")
        # source: ShardedTextIndexSet / DurableIndexStore (.shards) or a
        # bare TextIndexSet (the 1-shard degenerate case)
        shards = getattr(source, "shards", None)
        self._shards = list(shards) if shards is not None else [source]
        self.index_set = source
        self.lexicon = source.lexicon
        self.replicas: List[List[ReplicaReader]] = [
            [
                ReplicaReader(s, r, shard, cache_bytes=cache_bytes,
                              targeted=targeted)
                for r in range(n_replicas)
            ]
            for s, shard in enumerate(self._shards)
        ]
        self.failovers = 0
        self._wave_pin: List[Optional[ReplicaReader]] = [None] * len(
            self._shards
        )
        self.cache_stats = _FabricCacheStats(
            [rep.cache for row in self.replicas for rep in row
             if rep.cache is not None]
        )

    # ---------------------------------------------------------------- shape --
    @property
    def n_shards(self) -> int:
        return len(self.replicas)

    @property
    def n_replicas(self) -> int:
        return len(self.replicas[0])

    # -------------------------------------------------------------- routing --
    def _route(self, shard: int) -> ReplicaReader:
        """Least-loaded LIVE replica: fewest waves in flight, then least
        cumulative read I/O (waves have very unequal costs — counting
        them would park one hot wave's replica at the same priority as
        its idle siblings; simulated bytes are a deterministic cost
        proxy, where wall time would make routing — and every failover
        test — timing-dependent), then waves served (round-robin when
        costs tie), then replica id."""
        live = [rep for rep in self.replicas[shard] if rep.live]
        if not live:
            raise AllReplicasDeadError(
                f"shard {shard}: all {self.n_replicas} replicas are down"
            )
        return min(
            live,
            key=lambda rep: (rep.inflight, rep.read_bytes(),
                             rep.waves_served, rep.replica_id),
        )

    def begin_wave(self) -> None:
        """Pin one replica per shard for the next fetch wave and count it
        in flight — the load signal :meth:`_route` balances on."""
        for s in range(self.n_shards):
            rep = self._route(s)
            rep.inflight += 1
            self._wave_pin[s] = rep

    def end_wave(self) -> None:
        for s, rep in enumerate(self._wave_pin):
            if rep is not None:
                rep.inflight -= 1
                rep.waves_served += 1
                self._wave_pin[s] = None

    def _serve(self, shard: int, op: Callable[[ReplicaReader], object]):
        """Serve through the wave-pinned (or freshly routed) replica,
        failing over to a live sibling when it dies mid-serve."""
        rep = self._wave_pin[shard]
        pinned = rep is not None
        if rep is None:
            rep = self._route(shard)
        while True:
            try:
                return op(rep)
            except ReplicaDeadError:
                rep.live = False
                rep.failures += 1
                if pinned and rep.inflight > 0:
                    rep.inflight -= 1
                self.failovers += 1
                rep = self._route(shard)  # AllReplicasDeadError if none
                if pinned:
                    rep.inflight += 1
                    self._wave_pin[shard] = rep

    # ----------------------------------------------------- reader surface --
    def lookup_shard(
        self, shard: int, index_name: str, key: Hashable
    ) -> np.ndarray:
        return self._serve(shard, lambda rep: rep.lookup(index_name, key))

    def open_cursor_shard(
        self, shard: int, index_name: str, key: Hashable,
        make_decoder=None, device_tier: Optional[torch.device] = None,
    ) -> ReaderCursor:
        return self._serve(
            shard,
            lambda rep: rep.open_cursor(
                index_name, key,
                make_decoder=make_decoder, device_tier=device_tier,
            ),
        )

    def lookup(self, index_name: str, key: Hashable) -> np.ndarray:
        from repro_torch.core.sharded_set import merge_shard_postings

        return merge_shard_postings(
            [self.lookup_shard(s, index_name, key)
             for s in range(self.n_shards)]
        )

    def group_of(self, index_name: str, key: Hashable) -> int:
        # dictionary grouping is shard- and replica-invariant
        return self.replicas[0][0].readers[index_name].group_of(key)

    def refresh(self) -> None:
        """Catch every LIVE replica up on its shard's digest stream (dead
        replicas stay where they are; they catch up on revive)."""
        for row in self.replicas:
            for rep in row:
                if rep.live:
                    rep.catch_up()

    def generation_vector(self) -> List[List[int]]:
        """The WRITERS' published per-shard per-index generations — the
        source of truth a snapshot-consistent batch pins.  Replica
        positions live in :meth:`replica_generations`."""
        return [shard.generation_vector() for shard in self._shards]

    # -------------------------------------------------------- observability --
    def replica_generations(self) -> List[List[List[int]]]:
        """``[shard][replica] -> per-index generation vector``: each
        replica's position on its shard's digest stream."""
        return [[rep.generation_vector() for rep in row]
                for row in self.replicas]

    def replica_liveness(self) -> List[List[bool]]:
        return [[rep.live for rep in row] for row in self.replicas]

    def route_trace(self) -> Dict[str, object]:
        """The per-batch trace block ``SearchService`` embeds as
        ``last_trace['replicas']`` (and ``check_trace_complete`` bounds
        staleness with)."""
        return {
            "n_replicas": self.n_replicas,
            "snapshot": self.replica_generations(),
            "live": self.replica_liveness(),
            "failovers": self.failovers,
            "waves": [[rep.waves_served for rep in row]
                      for row in self.replicas],
            "lookups": [[rep.lookups_served for rep in row]
                        for row in self.replicas],
            "cursors": [[rep.cursors_served for rep in row]
                        for row in self.replicas],
            "busy_s": [[rep.busy_s for rep in row]
                       for row in self.replicas],
            "catch_ups": [[dict(rep.catch_ups) for rep in row]
                          for row in self.replicas],
        }

    def io_stats_per_replica(self) -> List[List[Dict[str, IOStats]]]:
        return [[rep.io_stats() for rep in row] for row in self.replicas]

    def read_bytes_per_replica(self) -> List[List[int]]:
        return [[rep.read_bytes() for rep in row] for row in self.replicas]

    def io_stats(self) -> Dict[str, IOStats]:
        from repro_torch.core.sharded_set import merge_io_reports

        return merge_io_reports(
            [rep.io_stats() for row in self.replicas for rep in row]
        )
