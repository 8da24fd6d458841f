"""Stream-of-clusters lifecycle engine (paper sections 4, 5, Fig. 8).

A *stream of clusters* stores one posting list (or, under TAG, the combined
posting list of a bucket of keys).  This module implements the full
strategy state machine:

    EM ──► SR0 ──► CH ──► S          (when SR is active: sets 2 and 3)
    EM ──► PART ──► [CH ──►] S       (when SR is off: set 1)

with the auxiliary strategies:

    C1  — per-phase cluster cache with a per-stream quota; indexing is
          phase-wise over key groups (caller drives begin/end_phase),
    FL  — bulk-loadable first-level tail clusters (whole clusters saved
          per phase — the waste the SR strategy eliminates),
    SR  — short-record tail accumulator in 128-byte blocks, streamed
          sequentially per phase; guarantees only FULL clusters enter
          chains (no tail read-modify-write),
    TAG — handled one level up (dictionary); streams just carry `tagged`,
    DS  — handled one level down (PackedWriteDevice).

I/O accounting policy (what reproduces Tables 2 and 3):

  * clusters that are *resident* (in the C1 cache) this phase cost nothing
    to touch; dirty residents are flushed at ``end_phase`` through
    ``BlockDevice.write_clusters`` which charges ONE op per physically
    contiguous run — this is why coalesced chains and contiguous segments
    are cheap and scattered tail clusters are expensive;
  * appending to a partial cluster written in an earlier phase requires
    reading it back first (read-modify-write) unless its bytes are covered
    by FL (bulk-loaded) or SR (tail never on disk, chain clusters full);
  * FL areas and SR files are loaded/saved sequentially once per phase:
    FL is charged whole clusters (its documented weakness), SR only its
    actual 128-byte-block bytes;
  * segment moves (S doubling, CH coalescing, CH→S conversion) read only
    non-resident source clusters and write through the cache.

Cluster *content* is tracked logically at the stream level (one byte
string per stream, plus exact per-cluster byte occupancy) — the device
traffic is what the paper measures, and search results are validated
against a posting-level oracle in the tests.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.cluster_store import LINK_BYTES, ExtentAllocator
from repro_torch.core.io_sim import BlockDevice, IOStats
from repro_torch.core.strategies import StrategyConfig

# stream lifecycle states (Fig. 8)
EM = "em"      # posting list embedded in the dictionary entry
SR0 = "sr0"    # SR-record only, no clusters allocated
PART = "part"  # 1/2^k sub-cluster part
CH = "ch"      # backward-linked bounded chain of segments
S = "s"        # power-of-two contiguous segments

ALL_STATES = (EM, SR0, PART, CH, S)


class DigestLog:
    """Bounded, generation-keyed history of touched-key digests.

    The writer-side publication surface of the live-update protocol:
    every published generation advance (update part, compaction fold)
    appends its touched-key digest here, and readers — local or replica
    — catch up with :meth:`since`.  The history is bounded in *entries*
    (``maxlen``) and implicitly in bytes (oversized digests are stored
    as ``None`` sentinels by the caller), so a subscriber further behind
    than the retained window gets ``None`` back and must fall back to
    the whole-namespace drop path.

    ``clear()`` exists for checkpoint restore: a reopened replica's
    bulk-applied state has no per-generation digests for the span the
    checkpoint collapsed, so the log must not answer for generations it
    cannot attribute."""

    def __init__(self, history: int):
        self._log: Deque[Tuple[int, Optional[frozenset]]] = deque(
            maxlen=max(1, int(history))
        )

    def publish(self, generation: int, digest: Optional[frozenset]) -> None:
        self._log.append((int(generation), digest))

    def since(
        self, generation: int, current: int
    ) -> Optional[List[frozenset]]:
        """Digests of every generation in ``(generation, current]`` —
        oldest first — or ``None`` when the bounded history no longer
        covers that span (or a covered digest was an oversized
        sentinel)."""
        missing = int(current) - int(generation)
        if missing <= 0:
            return []
        out = [d for g, d in self._log if g > generation]
        if len(out) != missing or any(d is None for d in out):
            return None
        return out

    def clear(self) -> None:
        self._log.clear()

    def __iter__(self):
        return iter(self._log)

    def __len__(self) -> int:
        return len(self._log)


@dataclasses.dataclass
class Segment:
    start: int        # first cluster id
    nclusters: int    # physically contiguous length
    used: int         # payload bytes stored in this segment

    @property
    def ids(self) -> range:
        return range(self.start, self.start + self.nclusters)


@dataclasses.dataclass
class Stream:
    sid: int
    group: int
    tagged: bool = False
    state: str = EM
    data: bytearray = dataclasses.field(default_factory=bytearray)
    # EM/SR0 hold everything in `data`; cluster states split `data` into
    # segment payloads + tail (FL or SR) bytes, tracked by byte counts.
    segments: List[Segment] = dataclasses.field(default_factory=list)
    part_cluster: int = -1
    part_size: int = 0
    fl_bytes: int = 0        # bytes currently in the FL tail cluster
    has_fl: bool = False
    sr_bytes: int = 0        # bytes currently in the SR record
    has_sr: bool = False
    chain_limit: int = 0     # per-stream CH limit (5.7.3 jitter)
    last_doc: int = 0        # delta-encoding continuation point
    n_keys: int = 1          # number of keys sharing this stream (TAG)

    @property
    def total_bytes(self) -> int:
        return len(self.data)

    def segment_bytes(self) -> int:
        return sum(s.used for s in self.segments)


class StreamManager:
    """Owns every stream; drives the lifecycle; charges all index I/O."""

    def __init__(
        self,
        cfg: StrategyConfig,
        device: BlockDevice,
        n_groups: int,
        name: str = "index",
        fl_area_clusters: int = 8192,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.device = device
        self.n_groups = max(1, int(n_groups))
        self.name = name
        self.alloc = ExtentAllocator()
        self.streams: Dict[int, Stream] = {}
        self._next_sid = 0
        self._rng = np.random.RandomState(seed)

        # FL area budget (whole area is bulk loaded/saved per phase, grouped
        # by key group so each phase touches only its own FL clusters).
        self.fl_area_clusters = int(fl_area_clusters) if cfg.use_fl else 0
        self._fl_used_clusters = 0
        self._fl_streams_by_group: Dict[int, List[int]] = {}

        # SR bookkeeping (5.8): RAM budget per phase; SR file per group.
        self._sr_streams_by_group: Dict[int, List[int]] = {}
        self._sr_group_bytes: Dict[int, int] = {}

        # PART clusters are shared: per (group, part_size) open clusters
        # with free slots.  {(group, size): [(cluster_id, [free slots])]}
        self._part_open: Dict[Tuple[int, int], List[Tuple[int, List[int]]]] = {}
        self._part_members: Dict[int, int] = {}  # cluster -> live part count

        # phase (C1) state
        self._phase_group: Optional[int] = None
        self._resident: Dict[int, set] = {}   # sid -> resident cluster ids
        self._dirty: Dict[int, set] = {}      # sid -> dirty cluster ids
        self._part_resident: set = set()      # shared PART clusters read/written
        self._part_dirty: set = set()

        # census of lifecycle transitions (for the Fig. 8 benchmark)
        self.transitions: Dict[Tuple[str, str], int] = {}

    # ------------------------------------------------------------ utilities --
    @property
    def cluster_size(self) -> int:
        return self.cfg.cluster_size

    @property
    def cluster_cap(self) -> int:
        return self.cfg.cluster_size - LINK_BYTES

    def seg_cap(self, seg: Segment) -> int:
        return seg.nclusters * self.cluster_size - LINK_BYTES

    def new_stream(self, group: int, tagged: bool = False) -> int:
        sid = self._next_sid
        self._next_sid += 1
        st = Stream(sid=sid, group=group % self.n_groups, tagged=tagged)
        lim = self.cfg.chain_limit
        if self.cfg.chain_limit_jitter:
            lim -= int(self._rng.randint(0, self.cfg.chain_limit_jitter + 1))
        st.chain_limit = max(2, lim)
        self.streams[sid] = st
        return sid

    def _note(self, a: str, b: str) -> None:
        self.transitions[(a, b)] = self.transitions.get((a, b), 0) + 1

    # --------------------------------------------------------------- phases --
    def begin_phase(self, group: int) -> None:
        assert self._phase_group is None, "phase already open"
        self._phase_group = group % self.n_groups
        self._resident = {}
        self._dirty = {}
        self._part_resident = set()
        self._part_dirty = set()
        # FL bulk load: the whole FL area of this group, whole clusters (5.5).
        fl_sids = self._fl_streams_by_group.get(self._phase_group, [])
        if fl_sids:
            self.device.read_sequential(len(fl_sids) * self.cluster_size)  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
        # SR file load: only actual block bytes, sequential (5.8).
        sr_bytes = self._sr_group_bytes.get(self._phase_group, 0)
        if sr_bytes:
            self.device.read_sequential(_blocks(sr_bytes, self.cfg.sr_block))  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint

    def end_phase(self) -> None:
        assert self._phase_group is not None, "no open phase"
        group = self._phase_group
        # flush dirty cached clusters; contiguous runs are single ops
        for sid, ids in self._dirty.items():
            if ids:
                self.device.write_clusters(ids)  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
        if self._part_dirty:
            self.device.write_clusters(self._part_dirty)  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
        # FL bulk save: whole clusters, even half-empty ones (the FL waste)
        fl_sids = self._fl_streams_by_group.get(group, [])
        if fl_sids:
            self.device.write_sequential(len(fl_sids) * self.cluster_size)  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
        # SR file save: actual block bytes
        sr_bytes = self._sr_group_bytes.get(group, 0)
        if sr_bytes:
            self.device.write_sequential(_blocks(sr_bytes, self.cfg.sr_block))  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
        self.device.flush()  # DS buffer boundary
        self._phase_group = None
        self._resident = {}
        self._dirty = {}
        self._part_resident = set()
        self._part_dirty = set()

    # residency helpers ------------------------------------------------------
    def _res(self, sid: int) -> set:
        return self._resident.setdefault(sid, set())

    def _mark_dirty(self, sid: int, ids: Iterable[int]) -> None:
        ids = set(ids)
        self._res(sid).update(ids)
        self._dirty.setdefault(sid, set()).update(ids)
        self._enforce_quota(sid)

    def _enforce_quota(self, sid: int) -> None:
        """C1: a stream may keep at most `cache_clusters_per_stream` clusters
        resident; overflow is flushed immediately (oldest = lowest ids of
        non-tail segments first)."""
        quota = self.cfg.cache_clusters_per_stream
        res = self._res(sid)
        if len(res) <= quota:
            return
        st = self.streams[sid]
        # candidate flush order: clusters of non-tail segments, then tail
        ordered: List[int] = []
        for seg in st.segments[:-1]:
            ordered.extend(c for c in seg.ids if c in res)
        if st.segments:
            ordered.extend(c for c in st.segments[-1].ids if c in res)
        extra = [c for c in res if c not in set(ordered)]
        ordered.extend(sorted(extra))
        to_flush = ordered[: len(res) - quota]
        dirty = self._dirty.get(sid, set())
        flush_dirty = [c for c in to_flush if c in dirty]
        if flush_dirty:
            self.device.write_clusters(flush_dirty)  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
            dirty.difference_update(flush_dirty)
        res.difference_update(to_flush)

    def _ensure_resident(self, sid: int, ids: Iterable[int]) -> None:
        """Read the given clusters unless already resident (charges reads)."""
        ids = set(ids)
        res = self._res(sid)
        missing = ids - res
        if missing:
            self.device.read_clusters(missing)  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
            res.update(missing)
            self._enforce_quota(sid)

    # ------------------------------------------------------------- appends --
    def append_stream(self, sid: int, chunk: bytes) -> None:
        """Append an encoded posting chunk to a stream (within a phase)."""
        assert self._phase_group is not None, "appends happen inside a phase"
        st = self.streams[sid]
        assert st.group == self._phase_group, (
            f"stream {sid} of group {st.group} touched in phase "
            f"{self._phase_group} — C1 grouping violated"
        )
        if not chunk:
            return
        st.data += chunk
        n = len(chunk)
        cfg = self.cfg

        if st.state == EM:
            if cfg.use_em and st.total_bytes <= cfg.em_limit:
                return  # still embedded; dictionary traffic covers it
            self._leave_em(st)
        if st.state == SR0:
            self._grow_sr0(st)
            return
        if st.state == PART:
            self._grow_part(st)
            return
        if st.state in (CH, S):
            self._append_tail(st, n)
            return
        raise AssertionError(st.state)

    # --- EM exit --------------------------------------------------------------
    def _leave_em(self, st: Stream) -> None:
        cfg = self.cfg
        if cfg.use_sr and self._sr_admit(st):
            self._note(EM, SR0)
            st.state = SR0
            self._grow_sr0(st)
        elif cfg.use_part and st.total_bytes <= cfg.cluster_size // 2:
            self._note(EM, PART)
            st.state = PART
            self._part_place(st, st.total_bytes)
        else:
            self._note(EM, CH if cfg.use_ch else S)
            st.state = CH if cfg.use_ch else S
            self._tail_init(st)
            self._append_tail(st, 0)

    # --- SR -------------------------------------------------------------------
    def _sr_admit(self, st: Stream) -> bool:
        """SR RAM budget check (5.8): SR applies only to a subset of streams."""
        g = st.group
        if st.has_sr:
            return True
        used = self._sr_group_bytes.get(g, 0)
        budget = self.cfg.sr_memory_limit // self.n_groups
        if used + self.cfg.sr_block > budget:
            return False
        st.has_sr = True
        self._sr_streams_by_group.setdefault(g, []).append(st.sid)
        return True

    def _sr_account(self, st: Stream, new_bytes: int) -> None:
        g = st.group
        self._sr_group_bytes[g] = (
            self._sr_group_bytes.get(g, 0) - st.sr_bytes + new_bytes
        )
        st.sr_bytes = new_bytes

    def _grow_sr0(self, st: Stream) -> None:
        """SR0: everything lives in the SR record until it exceeds a cluster."""
        cfg = self.cfg
        if st.total_bytes <= cfg.cluster_size:
            self._sr_account(st, st.total_bytes)
            return
        # SR record overflows a cluster: move to CH/S, keep SR as tail (Fig. 8)
        nxt = CH if cfg.use_ch else S
        self._note(SR0, nxt)
        st.state = nxt
        self._tail_init(st)
        self._append_tail(st, 0)

    # --- PART -------------------------------------------------------------------
    def _part_place(self, st: Stream, need: int) -> None:
        """Place `need` bytes into the smallest sufficient part (5.3)."""
        for size in self.cfg.part_sizes():
            if need <= size - 2:  # 2 bytes of per-part metadata
                self._part_assign(st, size)
                return
        # larger than the biggest part: promote out of PART
        self._part_promote_out(st)

    def _part_assign(self, st: Stream, size: int) -> None:
        group = st.group
        key = (group, size)
        open_list = self._part_open.setdefault(key, [])
        if not open_list:
            cid = self.alloc.alloc(1)
            slots = list(range(self.cfg.cluster_size // size))
            open_list.append((cid, slots))
            # a brand-new PART cluster is resident+dirty this phase
            self._part_resident.add(cid)
        cid, slots = open_list[0]
        if cid not in self._part_resident:
            # shared cluster written in an earlier phase: read-modify-write
            self.device.read_clusters([cid])  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
            self._part_resident.add(cid)
        slots.pop()
        if not slots:
            open_list.pop(0)
        self._part_dirty.add(cid)
        self._part_members[cid] = self._part_members.get(cid, 0) + 1
        st.part_cluster = cid
        st.part_size = size

    def _part_release(self, st: Stream) -> None:
        cid = st.part_cluster
        if cid < 0:
            return
        self._part_members[cid] = self._part_members.get(cid, 1) - 1
        size = st.part_size
        # return the slot for reuse
        open_list = self._part_open.setdefault((st.group, size), [])
        for i, (c, slots) in enumerate(open_list):
            if c == cid:
                slots.append(0)
                break
        else:
            open_list.append((cid, [0]))
        if self._part_members.get(cid, 0) <= 0:
            self._part_members.pop(cid, None)
        st.part_cluster = -1
        st.part_size = 0

    def _grow_part(self, st: Stream) -> None:
        need = st.total_bytes
        if need <= st.part_size - 2:
            # still fits; the cluster must be in RAM to modify it
            cid = st.part_cluster
            if cid not in self._part_resident:
                self.device.read_clusters([cid])  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
                self._part_resident.add(cid)
            self._part_dirty.add(cid)
            return
        # outgrew the part: move to a larger part or out of PART (5.3)
        if need <= self.cfg.cluster_size // 2:
            # data must be in RAM for the move
            cid = st.part_cluster
            if cid not in self._part_resident:
                self.device.read_clusters([cid])  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
                self._part_resident.add(cid)
            self._part_release(st)
            self._part_place(st, need)
        else:
            self._part_promote_out(st)

    def _part_promote_out(self, st: Stream) -> None:
        """PART → CH/S: the stream gets real clusters (Fig. 8)."""
        cid = st.part_cluster
        if cid >= 0 and cid not in self._part_resident:
            self.device.read_clusters([cid])  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
            self._part_resident.add(cid)
        self._part_release(st)
        nxt = CH if self.cfg.use_ch else S
        self._note(PART, nxt)
        st.state = nxt
        self._tail_init(st)
        self._append_tail(st, 0)

    # --- tail buffers (FL / SR) --------------------------------------------------
    def _tail_init(self, st: Stream) -> None:
        """Give a fresh CH/S stream its tail accumulator."""
        cfg = self.cfg
        if cfg.use_sr and self._sr_admit(st):
            pass  # SR tail
        elif cfg.use_fl and not cfg.use_sr and not st.has_fl:
            if self._fl_used_clusters < self.fl_area_clusters:
                st.has_fl = True
                self._fl_used_clusters += 1
                self._fl_streams_by_group.setdefault(st.group, []).append(st.sid)

    def _tail_capacity(self, st: Stream) -> int:
        if st.has_sr:
            return self.cluster_cap  # SR record is limited by cluster size
        if st.has_fl:
            return self.cluster_cap
        return self.cluster_cap  # direct tail: partial last cluster

    def _append_tail(self, st: Stream, _n: int) -> None:
        """Drain stream bytes not yet in segments into tail + full clusters."""
        cfg = self.cfg
        while True:
            pending = st.total_bytes - st.segment_bytes()
            tail_cap = self._tail_capacity(st)
            if st.has_sr:
                if pending <= tail_cap:
                    self._sr_account(st, pending)
                    return
                # SR overflow: emit exactly one FULL cluster into the stream
                self._emit_full_cluster(st)
                self._sr_account(st, st.total_bytes - st.segment_bytes())
            elif st.has_fl:
                if pending <= tail_cap:
                    st.fl_bytes = pending
                    return
                self._emit_full_cluster(st)
                st.fl_bytes = st.total_bytes - st.segment_bytes()
            else:
                # direct append into the last cluster of the last segment
                if not self._emit_direct(st):
                    return

    def _emit_full_cluster(self, st: Stream) -> None:
        """One full cluster of data leaves the tail buffer into the chain or
        the last segment.  Under SR this is the paper's key invariant: the
        cluster is complete, so it is never read back (5.8)."""
        if st.state == CH:
            self._chain_add_cluster(st)
        else:
            self._segment_add_bytes(st, self.cluster_cap, full_only=True)

    # --- CH: bounded backward-linked chain (5.7) ----------------------------------
    def _chain_add_cluster(self, st: Stream) -> None:
        cfg = self.cfg
        res = self._res(st.sid)
        # coalesce resident tail segments with the new cluster (5.7.2):
        # collect trailing segments that are fully resident
        merged: List[Segment] = []
        for seg in reversed(st.segments):
            if all(c in res for c in seg.ids):
                merged.append(seg)
            else:
                break
        merged.reverse()
        if len(merged) >= max(1, cfg.ch_min_merge_segments - 1):
            moved_bytes = sum(s.used for s in merged)
            need = moved_bytes + self.cluster_cap
            ncl = _ceil_div(need + LINK_BYTES, self.cluster_size)
            # respect the cache quota: never build a resident segment bigger
            # than the stream's quota
            if ncl <= cfg.cache_clusters_per_stream:
                old_ids = [c for s in merged for c in s.ids]
                new = Segment(self.alloc.alloc(ncl), ncl, need)
                for s in merged:
                    st.segments.remove(s)
                st.segments.append(new)
                # free + recycle old clusters (5.7.1 step 4); drop residency
                if old_ids:
                    runs = _id_runs(sorted(old_ids))
                    for s0, l0 in runs:
                        self.alloc.free(s0, l0)
                    res.difference_update(old_ids)
                    d = self._dirty.get(st.sid, set())
                    d.difference_update(old_ids)
                self._mark_dirty(st.sid, new.ids)
                self._chain_check_limit(st)
                return
        # no coalescing possible: append a single-cluster segment
        seg = Segment(self.alloc.alloc(1), 1, self.cluster_cap)
        st.segments.append(seg)
        self._mark_dirty(st.sid, seg.ids)
        self._chain_check_limit(st)

    def _chain_check_limit(self, st: Stream) -> None:
        """5.7.3: chain length is counted in segments; convert to S at limit."""
        if len(st.segments) > st.chain_limit:
            self._convert_chain_to_segment(st)

    def _convert_chain_to_segment(self, st: Stream) -> None:
        """CH → S (5.7.1): read the chain, write one big segment, recycle."""
        res = self._res(st.sid)
        non_resident = []
        for seg in st.segments:
            missing = [c for c in seg.ids if c not in res]
            non_resident.extend(missing)
        if non_resident:
            self.device.read_clusters(non_resident)  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
        total = st.segment_bytes()
        ncl = _pow2_at_least(_ceil_div(total + LINK_BYTES, self.cluster_size))
        old_ids = [c for seg in st.segments for c in seg.ids]
        new = Segment(self.alloc.alloc(ncl), ncl, total)
        st.segments = [new]
        for s0, l0 in _id_runs(sorted(old_ids)):
            self.alloc.free(s0, l0)
        res.difference_update(old_ids)
        d = self._dirty.get(st.sid, set())
        d.difference_update(old_ids)
        if new.nclusters <= self.cfg.cache_clusters_per_stream:
            self._mark_dirty(st.sid, new.ids)
        else:
            self.device.write_clusters(new.ids)  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
        self._note(CH, S)
        st.state = S

    # --- S: power-of-two segments (5.4) -------------------------------------------
    def _segment_add_bytes(self, st: Stream, nbytes: int, full_only: bool = False) -> None:
        """Add `nbytes` of payload to the S-stream's last segment, growing by
        doubling up to seg_max, then by linking max-size segments."""
        cfg = self.cfg
        remaining = nbytes
        while remaining > 0:
            if not st.segments:
                st.segments.append(Segment(self.alloc.alloc(1), 1, 0))
                self._mark_dirty(st.sid, st.segments[-1].ids)
            last = st.segments[-1]
            room = self.seg_cap(last) - last.used
            if room > 0:
                take = min(room, remaining)
                # clusters being written must be resident (they are new or
                # bulk-covered by FL/SR; a partial tail written in an earlier
                # phase must be read back: read-modify-write)
                first_c = last.start + last.used // self.cluster_size
                last_c = last.start + (last.used + take - 1) // self.cluster_size
                partial_tail = (last.used % self.cluster_size) != 0
                if partial_tail and not (st.has_sr or st.has_fl):
                    self._ensure_resident(st.sid, [first_c])
                last.used += take
                remaining -= take
                self._mark_dirty(st.sid, range(first_c, last_c + 1))
                continue
            # last segment full: grow
            if last.nclusters < cfg.seg_max:
                self._segment_double(st)
            else:
                st.segments.append(
                    Segment(self.alloc.alloc(cfg.seg_max), cfg.seg_max, 0)
                )
                self._mark_dirty(st.sid, [])  # allocation only

    def _segment_double(self, st: Stream) -> None:
        """Allocate 2x segment, move the data into its first half (5.4)."""
        last = st.segments[-1]
        res = self._res(st.sid)
        missing = [c for c in last.ids if c not in res]
        if missing:
            self.device.read_clusters(missing)  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
        new_len = min(max(1, last.nclusters * 2), self.cfg.seg_max)
        if new_len <= last.nclusters:
            new_len = last.nclusters * 2  # seg_max not power-aligned; allow
        new = Segment(self.alloc.alloc(new_len), new_len, last.used)
        st.segments[-1] = new
        self.alloc.free(last.start, last.nclusters)
        res.difference_update(last.ids)
        d = self._dirty.get(st.sid, set())
        d.difference_update(last.ids)
        used_clusters = _ceil_div(new.used, self.cluster_size) or 1
        if new_len <= self.cfg.cache_clusters_per_stream:
            self._mark_dirty(st.sid, range(new.start, new.start + used_clusters))
        else:
            self.device.write_clusters(range(new.start, new.start + used_clusters))  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint

    def _emit_direct(self, st: Stream) -> bool:
        """No tail buffer: append pending bytes straight into segments.
        Returns False when nothing is pending."""
        pending = st.total_bytes - st.segment_bytes()
        if pending <= 0:
            return False
        if st.state == CH:
            # chains without SR: fill the tail cluster of the last segment
            # (read-modify-write if it was flushed in an earlier phase)
            last = st.segments[-1] if st.segments else None
            if last is not None and last.used < self.seg_cap(last):
                tail_c = last.start + last.used // self.cluster_size
                if last.used % self.cluster_size:
                    self._ensure_resident(st.sid, [tail_c])
                take = min(self.seg_cap(last) - last.used, pending)
                end_c = last.start + (last.used + take - 1) // self.cluster_size
                last.used += take
                self._mark_dirty(st.sid, range(tail_c, end_c + 1))
            else:
                take = min(self.cluster_cap, pending)
                if take < pending:
                    self._chain_add_cluster(st)  # full cluster
                else:
                    seg = Segment(self.alloc.alloc(1), 1, take)
                    st.segments.append(seg)
                    self._mark_dirty(st.sid, seg.ids)
                    self._chain_check_limit(st)
            return st.total_bytes - st.segment_bytes() > 0
        self._segment_add_bytes(st, pending)
        return False

    # ------------------------------------------------------------- reading --
    def read_stream(self, sid: int, device: Optional[BlockDevice] = None) -> bytes:
        """Read a stream's full posting data, charging search I/O:
        one op per physically contiguous segment, one per PART cluster,
        one small read for the SR record, one for the FL cluster.

        ``device`` lets readers charge their own accounting device (the
        reader/writer split in ``repro_torch.search.reader``); the default is
        the manager's build device."""
        dev = device if device is not None else self.device
        st = self.streams[sid]
        if st.state == EM:
            return bytes(st.data)  # dictionary-resident: no extra device op
        if st.state == SR0:
            dev.read_small(_blocks(st.sr_bytes, self.cfg.sr_block))  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
            return bytes(st.data)
        if st.state == PART:
            dev.read_clusters([st.part_cluster])  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
            return bytes(st.data)
        # CH / S
        for seg in st.segments:
            dev.read_clusters(seg.ids)  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
        if st.has_sr and st.sr_bytes:
            dev.read_small(_blocks(st.sr_bytes, self.cfg.sr_block))  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
        if st.has_fl and st.fl_bytes:
            dev.read_sequential(self.cluster_size)  # FL cluster: one op  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
        return bytes(st.data)

    def stream_snapshot(self, sid: int) -> bytes:
        """Open-time copy of a stream's logical payload, for
        snapshot-consistent lazy cursors.

        Charges NO device I/O: the cursor's storage units carry the
        open-time charge closures, and this copy is what those units
        decode from.  Pinning the bytes at open matters for streams whose
        payload is not append-only — TAG bucket streams are rewritten in
        place when a member is extracted (5.6), so a cursor drained after
        a mid-update extraction would otherwise decode the rewritten
        bucket (its own tag slot possibly retired) instead of the
        snapshot it was opened against.  Dedicated (OWN) streams only
        ever append, so their cursors pin layout by slicing fixed byte
        ranges and need no copy."""
        return bytes(self.streams[sid].data)

    def stream_read_units(
        self, sid: int, chunk_clusters: int = 0
    ) -> List[Tuple[int, int, "Callable[[BlockDevice], None]"]]:
        """Payload-ordered storage units of one stream, for lazy cursors.

        Returns ``[(payload_bytes, charge_bytes, charge), ...]`` covering
        the stream's byte payload in order: segments first (the stream's
        oldest bytes), then the SR record and FL cluster tails.  ``charge``
        performs exactly the device accounting a read of that unit costs
        and ``charge_bytes`` is the read bytes it will add — reading every
        unit charges the same bytes as :meth:`read_stream`, so a caller
        that stops early saves exactly the remaining units' bytes.
        ``chunk_clusters > 0`` splits contiguous segments into ranges of
        at most that many clusters so a cursor can stop mid-segment.
        """
        st = self.streams[sid]
        units: List[Tuple[int, int, "Callable[[BlockDevice], None]"]] = []
        if st.total_bytes == 0:
            return units
        if st.state == EM:
            # dictionary-resident: the entry read already covered the bytes
            units.append((st.total_bytes, 0, lambda dev: None))
            return units
        if st.state == SR0:
            nb = _blocks(st.sr_bytes, self.cfg.sr_block)
            units.append(
                (st.total_bytes, nb, lambda dev, nb=nb: dev.read_small(nb))  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
            )
            return units
        if st.state == PART:
            cid = st.part_cluster
            units.append((
                st.total_bytes, self.cluster_size,
                lambda dev, cid=cid: dev.read_clusters([cid]),  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
            ))
            return units
        # CH / S: payload = segment bytes (in list order) + SR/FL tail
        covered = (
            st.segment_bytes()
            + (st.sr_bytes if st.has_sr else 0)
            + (st.fl_bytes if st.has_fl else 0)
        )
        if covered != st.total_bytes:
            # unknown layout (defensive): one unit with read_stream charges
            def charge_all(dev, st=st):
                for seg in st.segments:
                    dev.read_clusters(seg.ids)  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
                if st.has_sr and st.sr_bytes:
                    dev.read_small(_blocks(st.sr_bytes, self.cfg.sr_block))  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
                if st.has_fl and st.fl_bytes:
                    dev.read_sequential(self.cluster_size)  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint

            nb = sum(s.nclusters for s in st.segments) * self.cluster_size
            if st.has_sr and st.sr_bytes:
                nb += _blocks(st.sr_bytes, self.cfg.sr_block)
            if st.has_fl and st.fl_bytes:
                nb += self.cluster_size
            units.append((st.total_bytes, nb, charge_all))
            return units
        cs = self.cluster_size
        for seg in st.segments:
            if seg.used <= 0:
                continue
            if chunk_clusters and seg.nclusters > chunk_clusters:
                off = 0
                c0 = 0
                while c0 < seg.nclusters and off < seg.used:
                    c1 = min(seg.nclusters, c0 + chunk_clusters)
                    hi = min(seg.used, c1 * cs)
                    if hi >= seg.used:
                        # the payload ends inside this chunk: absorb the
                        # segment's trailing allocated clusters so a
                        # drained cursor charges exactly what a whole-
                        # segment read_clusters(seg.ids) charges
                        c1 = seg.nclusters
                    ids = range(seg.start + c0, seg.start + c1)
                    units.append((
                        hi - off, len(ids) * cs,
                        lambda dev, ids=ids: dev.read_clusters(ids),  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
                    ))
                    off = hi
                    c0 = c1
            else:
                units.append((
                    seg.used, seg.nclusters * cs,
                    lambda dev, ids=seg.ids: dev.read_clusters(ids),  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
                ))
        if st.has_sr and st.sr_bytes:
            nb = _blocks(st.sr_bytes, self.cfg.sr_block)
            units.append(
                (st.sr_bytes, nb, lambda dev, nb=nb: dev.read_small(nb))  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
            )
        if st.has_fl and st.fl_bytes:
            units.append((
                st.fl_bytes, cs,
                lambda dev: dev.read_sequential(self.cluster_size),  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
            ))
        return units

    def read_ops_estimate(self, sid: int) -> int:
        """Number of device operations a search of this stream costs."""
        st = self.streams[sid]
        if st.state == EM:
            return 0
        if st.state in (SR0, PART):
            return 1
        ops = len(st.segments)
        if st.has_sr and st.sr_bytes:
            ops += 1
        if st.has_fl and st.fl_bytes:
            ops += 1
        return ops

    # ------------------------------------------------------- compaction --
    def compact_stream(self, sid: int) -> bool:
        """Fold one CH/S stream's scattered storage into a single tight
        contiguous EM-tier segment (the background-compaction primitive:
        small update parts accumulated across many phases become one
        large external-memory run).

        Runs BETWEEN phases (maintenance, not indexing): charges a read
        of the stream's current layout — exactly what :meth:`read_stream`
        charges — plus one contiguous segment write, both on the build
        device.  The stream's logical payload is untouched, so open
        cursors keep draining their open-time snapshot (their charge
        closures price the open-time layout) and decoded posting lists
        stay valid; only the physical layout changes.  SR/FL tail
        membership is released: the folded stream is a finished run with
        no accumulator (later appends take the direct path, like any
        stream past the tail budgets).

        Returns ``False`` — charging and changing NOTHING — when the
        stream is not CH/S, is empty, already sits in one tight segment,
        or folding would make reads MORE expensive (an SR/FL tail is
        charged at sub-cluster granularity; folding a short stream whose
        bytes mostly live in its tail rounds that up to whole clusters —
        the accumulator is already the cheap layout, which is the point
        of the paper's tail constructions): a no-op compaction cycle
        must be a real no-op.
        """
        assert self._phase_group is None, "compaction runs between phases"
        st = self.streams[sid]
        if st.state not in (CH, S) or st.total_bytes <= 0:
            return False
        total = st.total_bytes
        need = _ceil_div(total + LINK_BYTES, self.cluster_size)
        allocated = sum(s.nclusters for s in st.segments)
        multi_unit = (
            len(st.segments) > 1
            or (st.has_sr and st.sr_bytes > 0)
            or (st.has_fl and st.fl_bytes > 0)
        )
        if not multi_unit and allocated <= need:
            return False
        cur_charge = allocated * self.cluster_size
        if st.has_sr and st.sr_bytes:
            cur_charge += _blocks(st.sr_bytes, self.cfg.sr_block)
        if st.has_fl and st.fl_bytes:
            cur_charge += self.cluster_size
        if need * self.cluster_size > cur_charge:
            return False
        # maintenance read of the whole current layout (segments + tails)
        self.read_stream(sid)
        # release the SR/FL tail: the compact run carries no accumulator
        if st.has_sr:
            self._sr_account(st, 0)
            group_sids = self._sr_streams_by_group.get(st.group, [])
            if sid in group_sids:
                group_sids.remove(sid)
            st.has_sr = False
        if st.has_fl:
            fl_sids = self._fl_streams_by_group.get(st.group, [])
            if sid in fl_sids:
                fl_sids.remove(sid)
                self._fl_used_clusters -= 1
            st.has_fl = False
            st.fl_bytes = 0
        old_ids = [c for seg in st.segments for c in seg.ids]
        new = Segment(self.alloc.alloc(need), need, total)
        self.device.write_clusters(new.ids)  # repro-lint: allow(charge-accounting) port copy of the repro/core/stream.py chokepoint
        st.segments = [new]
        for s0, l0 in _id_runs(sorted(old_ids)):
            self.alloc.free(s0, l0)
        if st.state != S:
            self._note(st.state, S)
            st.state = S
        return True

    # ----------------------------------------------------- TAG maintenance --
    def rewrite_stream(self, sid: int, new_data: bytes, last_doc: int) -> None:
        """Replace a stream's contents (TAG extraction, 5.6).  The stream is
        rebuilt in place: old clusters freed, data re-emitted through the
        current lifecycle rules."""
        st = self.streams[sid]
        old_ids = [c for seg in st.segments for c in seg.ids]
        if old_ids:
            for s0, l0 in _id_runs(sorted(old_ids)):
                self.alloc.free(s0, l0)
            res = self._res(st.sid)
            res.difference_update(old_ids)
            d = self._dirty.get(st.sid, set())
            d.difference_update(old_ids)
        if st.state == PART:
            self._part_release(st)
        if st.has_sr:
            self._sr_account(st, 0)
        st.segments = []
        st.fl_bytes = 0
        st.data = bytearray()
        st.state = EM
        st.last_doc = last_doc
        if new_data:
            self.append_stream(sid, bytes(new_data))

    # ------------------------------------------------------------- reports --
    def state_census(self) -> Dict[str, int]:
        census = {s: 0 for s in ALL_STATES}
        for st in self.streams.values():
            census[st.state] += 1
        return census

    def storage_clusters(self) -> int:
        return self.alloc.capacity_high_water + self._fl_used_clusters


# ------------------------------------------------------------------ helpers --
def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _blocks(nbytes: int, block: int) -> int:
    """Bytes rounded up to SR block granularity."""
    return _ceil_div(max(0, nbytes), block) * block


def _id_runs(sorted_ids: List[int]) -> List[Tuple[int, int]]:
    runs: List[Tuple[int, int]] = []
    start = prev = None
    for cid in sorted_ids:
        if start is None:
            start = prev = cid
            continue
        if cid == prev + 1:
            prev = cid
            continue
        runs.append((start, prev - start + 1))
        start = prev = cid
    if start is not None:
        runs.append((start, prev - start + 1))
    return runs
