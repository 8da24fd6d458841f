"""The segmented membership kernel's design and its path, on the CPU.

``csrc/sorted_member_mask.cu`` cannot run here, so a numpy emulation of
it stands beside it: the merge route's tile co-ranks (the partition
pass's 4-lane search over segment starts, then over keys; none for a
launch of one tile), the staged a and b ranges with the one b past the
range, the per-thread co-ranks in shared memory, the serial merge with a
first on ties and segment walks, the 16-byte write-out, and the search
route's per-segment warp windows.  It is held
to the numpy oracle ``intersect_sorted_ref``, segment by segment, on
seeded and ``hypothesis`` cases; with the tie rule reversed, or without
the extra b element, it fails that check.

Then the port's plain version (``sorted_member_mask_segments_plain``)
against the reference's ``intersect_sorted`` (the Pallas kernel in
interpret mode) and its oracle, ``cuda_join_many`` against the
reference's ``pallas_window_join`` pair for pair, and ``search_batch``
under ``backend="cuda"`` against the reference's ``pallas`` backend at 1,
2 and 4 shards.  Integer arithmetic throughout: every output must be
bit-identical."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks.common import (
    build_index_set as ref_build_index_set,
    build_sharded_index_set as ref_build_sharded_index_set,
    make_world as ref_make_world,
)
from repro.kernels.intersect.ops import intersect_sorted as ref_intersect_sorted
from repro.kernels.intersect.ref import intersect_sorted_ref as ref_oracle
from repro.search import Query as RefQuery
from repro.search import SearchService as RefService
from repro.search.join import pallas_window_join
from tests._hypothesis_compat import given, settings, strategies as st
from tests.oracles import class_pools, core_queries, mixed_queries

from repro_torch.convert import world_from_arrays
from repro_torch.data import world as port_world
from repro_torch.kernels.intersect.kernel import (
    MERGE_ITEMS,
    SEARCH_RATIO,
    member_route,
    segment_tags,
    sorted_member_mask,
    sorted_member_mask_segments,
    sorted_member_mask_segments_plain,
)
from repro_torch.kernels.intersect.ref import intersect_sorted_ref
from repro_torch.search import Query as PortQuery
from repro_torch.search import SearchService as PortService
from repro_torch.search import join as port_join
from repro_torch.search.join import cuda_join_many, cuda_window_join


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the card's edge case (ties at tile and segment edges), shared with
# chip_smoke.py so the emulation checks the very segments the card runs
tie_edges = _chip_smoke().member_edges

POISON = np.iinfo(np.int64).min     # what an unstaged shared-memory word reads
UNSET = -1                          # an output byte no thread wrote


# ---------------------------------------------------------- the emulation --
EDGE_LANES = 4     # lanes that search one tile edge in the partition pass


def group_search(lo, hi, pred, lanes=EDGE_LANES):
    """The kernel's ``group_search``: ``lanes`` probes a round, a ballot,
    the first true lane; ``pred`` is taken as true at ``hi``."""
    while lo < hi:
        step = (hi - lo + lanes - 1) // lanes
        ballot = [x >= hi or pred(x) for x in (lo + g * step
                                              for g in range(lanes))]
        f = ballot.index(True) if any(ballot) else lanes
        if f == 0:
            hi = lo
        else:
            if f < lanes:
                hi = min(hi, lo + f * step)
            lo = lo + (f - 1) * step + 1
    return lo


def tile_co_rank(a, a_off, b, b_off, d, a_first=True):
    """``member_partition_kernel`` for one edge: the segment of diagonal
    ``d`` and the a index at which its merge stands (j = d - i)."""
    S = a_off.size - 1
    if d >= a.size + b.size:
        return S - 1, a.size
    s = group_search(1, S, lambda x: a_off[x] + b_off[x] > d) - 1
    lo = max(a_off[s], d - b_off[s + 1])
    hi = min(a_off[s + 1], d - b_off[s])
    if a_first:
        i = group_search(lo, hi, lambda x: a[x] > b[d - 1 - x])
    else:
        i = group_search(lo, hi, lambda x: a[x] >= b[d - 1 - x])
    return int(s), int(i)


class Staged:
    """A block's shared memory: a[A0:A1] and b[B0:Bx] at the kernel's
    offsets (each start aligned down to 16 bytes, pointers ``a_mis`` and
    ``b_mis`` words past a 16-byte boundary).  A read outside the staged
    ranges is an error (``strict``) or reads ``POISON``."""

    def __init__(self, a, b, A0, A1, B0, Bx, a_mis, b_mis, strict):
        a_head = (a_mis + A0) % 2
        a_words = a_head + (A1 - A0) if A1 > A0 else 0
        a_words += a_words % 2
        b_head = (b_mis + B0) % 2
        b_words = b_head + (Bx - B0) if Bx > B0 else 0
        b_words += b_words % 2
        self.keys = np.full(a_words + b_words + 8, POISON, np.int64)
        self.a_at = a_head - A0
        self.b_at = a_words + b_head - B0
        self.keys[A0 + self.a_at:A1 + self.a_at] = a[A0:A1]
        if Bx > B0:
            self.keys[B0 + self.b_at:Bx + self.b_at] = b[B0:Bx]
        self.ranges = ((A0, A1), (B0, Bx))
        self.strict = strict

    def _read(self, idx, side, at):
        lo, hi = self.ranges[side]
        if not lo <= idx < hi:
            assert not self.strict, ("unstaged read", "ab"[side], idx, lo, hi)
            return POISON
        return int(self.keys[idx + at])

    def a(self, i):
        return self._read(i, 0, self.a_at)

    def b(self, j):
        return self._read(j, 1, self.b_at)


def merge_route(a, a_off, b, b_off, threads=256, items=MERGE_ITEMS,
                a_first=True, extra=True, mis=(0, 0, 0), trace=None):
    """``member_merge_kernel`` over the whole grid.  Returns the output
    bytes (``UNSET`` where no thread wrote).  ``a_first=False`` reverses
    the tie rule; ``extra=False`` stages no b past the range; ``mis``
    puts a, b and out that many elements past 16-byte boundaries;
    ``trace`` collects each tile's (d0, d1, s0, s1, A0, A1, B0, B1)."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    n, m = a.size, b.size
    total, tile = n + m, threads * items
    out = np.full(n + 32, UNSET, np.int64)     # byte addresses out + mis[2]
    for blk in range(-(-total // tile) if n else 0):
        d0, d1 = blk * tile, min(blk * tile + tile, total)
        if total <= tile:   # one tile: no partition pass, all segments
            (s0, A0), (s1, A1) = (0, 0), (a_off.size - 2, n)
        else:
            s0, A0 = tile_co_rank(a, a_off, b, b_off, d0, a_first)
            s1, A1 = tile_co_rank(a, a_off, b, b_off, d1, a_first)
        B0, B1 = d0 - A0, d1 - A1
        Bx = min(B1 + 1, m) if extra else B1
        if trace is not None:
            trace.append((d0, d1, s0, s1, A0, A1, B0, B1))
        sm = Staged(a, b, A0, A1, B0, Bx, mis[0], mis[1],
                    strict=extra and a_first)
        o_head = (mis[2] + A0) % 16
        hit = np.full(tile + 32, UNSET, np.int64)
        for t in range(threads):
            dt = d0 + t * items
            if dt >= d1:
                break
            s, hi = s0, s1
            while s < hi:
                mid = s + (hi - s + 1) // 2
                if a_off[mid] + b_off[mid] <= dt:
                    s = mid
                else:
                    hi = mid - 1
            a_end, b_end = int(a_off[s + 1]), int(b_off[s + 1])
            # tile-local: a[A0 + x], b[B0 + y], diagonal t = x + y
            t0 = dt - d0
            lo = max(a_off[s], dt - b_end, A0, dt - B1) - A0
            hi = min(a_end, dt - b_off[s], A1, dt - B0) - A0
            while lo < hi:
                mid = (lo + hi) >> 1
                ka, kb = sm.a(A0 + mid), sm.b(B0 + t0 - 1 - mid)
                if ka > kb if a_first else ka >= kb:
                    hi = mid
                else:
                    lo = mid + 1

            def limits(a_end, b_end):
                return (min(a_end, A1) - A0, min(b_end, Bx) - B0,
                        min(a_end + b_end - d0, d1 - d0))

            a_lim, b_lim, seg_end = limits(a_end, b_end)
            x, y = int(lo), int(t0 - lo)
            for t in range(t0, min(t0 + items, d1 - d0)):
                while t == seg_end:
                    s += 1
                    a_lim, b_lim, seg_end = limits(int(a_off[s + 1]),
                                                   int(b_off[s + 1]))
                has_b = y < b_lim
                take_a = x < a_lim
                if take_a and has_b:
                    ka, kb = sm.a(A0 + x), sm.b(B0 + y)
                    take_a = ka <= kb if a_first else ka < kb
                if take_a:
                    assert not sm.strict or hit[o_head + x] == UNSET, x
                    hit[o_head + x] = int(has_b and sm.b(B0 + y) == sm.a(A0 + x))
                    x += 1
                else:
                    y += 1
        # the write-out: 16-byte chunks from out + A0 aligned down
        o0, o1 = mis[2] + A0, mis[2] + A1
        base = o0 - o0 % 16
        for c in range((o1 - base + 15) // 16):
            g = base + 16 * c
            if g >= o0 and g + 16 <= o1:
                out[g:g + 16] = hit[16 * c:16 * c + 16]
            else:
                for k in range(16):
                    if o0 <= g + k < o1:
                        out[g + k] = hit[16 * c + k]
    return out[mis[2]:mis[2] + n]


def lower_bound(b, lo, hi, x):
    while lo < hi:
        mid = lo + (hi - lo) // 2
        if b[mid] < x:
            lo = mid + 1
        else:
            hi = mid
    return lo


def search_route(a, a_off, b, b_off, windows=None):
    """``member_search_kernel``: one lane a key; the lanes of a warp that
    share a segment take their window of b from their first and last key.
    ``windows`` collects each lane group's (segment, window size)."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    n, S = a.size, a_off.size - 1
    out = np.full(n, UNSET, np.int64)
    for w in range(-(-n // 32)):
        ks = [min(32 * w + lane, n - 1) for lane in range(32)]
        segs = []
        for k in ks:
            s, hi = 0, S - 1
            while s < hi:
                mid = s + (hi - s + 1) // 2
                if a_off[mid] <= k:
                    s = mid
                else:
                    hi = mid - 1
            segs.append(s)
        edge = {}
        for lane, s in enumerate(segs):
            group = [x for x, t in enumerate(segs) if t == s]
            if lane in (group[0], group[-1]):
                edge[lane] = lower_bound(b, b_off[s], b_off[s + 1], a[ks[lane]])
        for lane, s in enumerate(segs):
            group = [x for x, t in enumerate(segs) if t == s]
            w_lo, w_hi = edge[group[0]], edge[group[-1]]
            if windows is not None and lane == group[0]:
                windows.append((s, w_hi - w_lo))
            x = a[ks[lane]]
            pos = lower_bound(b, w_lo, w_hi, x)
            # the window holds the key's lower bound in its whole segment
            assert pos == lower_bound(b, b_off[s], b_off[s + 1], x)
            i = 32 * w + lane
            if i < n:
                out[i] = int(pos < b_off[s + 1] and b[pos] == x)
    return out


# ------------------------------------------------------------------ cases --
def oracle(a, a_off, b, b_off):
    """``intersect_sorted_ref`` segment by segment."""
    parts = [intersect_sorted_ref(a[a_off[s]:a_off[s + 1]],
                                  b[b_off[s]:b_off[s + 1]])
             for s in range(a_off.size - 1)]
    return (np.concatenate(parts) if parts else np.zeros(0, bool)).astype(bool)


def segments(rng, shapes, hi=1 << 12, base=0, repeat=0.0):
    """One segment per (n, m) of ``shapes``: ``a`` sorted, with runs of a
    repeated key where ``repeat`` > 0 (geometric, mean 1 / (1 - repeat)),
    ``b`` sorted and distinct, keys drawn from ``base + [0, hi)``."""
    a_parts, b_parts = [], []
    for n, m in shapes:
        if repeat > 0 and n:
            runs = rng.geometric(1 - repeat, n)
            keys = np.sort(rng.choice(hi, n, replace=True))
            a_s = np.repeat(keys, runs)[:n]
        else:
            a_s = np.sort(rng.randint(0, hi, n))
        b_s = np.sort(rng.choice(hi, min(m, hi), replace=False))
        a_parts.append(a_s + base)
        b_parts.append(b_s + base)
    a_off = np.concatenate([[0], np.cumsum([p.size for p in a_parts])])
    b_off = np.concatenate([[0], np.cumsum([p.size for p in b_parts])])
    cat = (lambda ps: np.concatenate(ps).astype(np.int64) if ps
           else np.zeros(0, np.int64))
    return cat(a_parts), a_off.astype(np.int64), cat(b_parts), \
        b_off.astype(np.int64)


def check(a, a_off, b, b_off, **kw):
    want = oracle(a, a_off, b, b_off).astype(np.int64)
    got = merge_route(a, a_off, b, b_off, **kw)
    assert np.array_equal(got, want), np.flatnonzero(got != want)[:10]
    assert np.array_equal(search_route(a, a_off, b, b_off), want)


SEEDED = {
    "balanced": [(300, 280)],
    "repeats": [(500, 200)],
    "skew_b": [(7, 2000)],
    "skew_a": [(1500, 9)],
    "empty_sides": [(0, 40), (30, 0), (0, 0), (25, 25), (0, 0), (1, 1)],
    "many_small": [(int(k % 7), int(k % 5)) for k in range(60)],
}


@pytest.mark.parametrize("name", sorted(SEEDED))
@pytest.mark.parametrize("threads,items", [(4, 4), (8, 8), (256, 16)])
def test_emulation_matches_oracle_seeded(name, threads, items):
    rng = np.random.RandomState(len(name) * 31 + threads)
    a, a_off, b, b_off = segments(rng, SEEDED[name], hi=1 << 11,
                                  repeat=0.75 if name == "repeats" else 0.0)
    check(a, a_off, b, b_off, threads=threads, items=items)


@pytest.mark.parametrize("mis", [(0, 0, 0), (1, 0, 3), (0, 1, 15), (1, 1, 8)])
@pytest.mark.parametrize("threads,items", [(4, 4), (2, 8)])
def test_ties_at_tile_and_segment_edges(threads, items, mis):
    """A tie sits on every tile edge, and segment boundaries fall inside
    tiles; any alignment of a, b and out."""
    tile = threads * items
    a, a_off, b, b_off = tie_edges(tile, base=(1 << 40) + 7)
    trace = []
    want = oracle(a, a_off, b, b_off).astype(np.int64)
    got = merge_route(a, a_off, b, b_off, threads=threads, items=items,
                      mis=mis, trace=trace)
    assert np.array_equal(got, want)
    # the extra b was needed: some tile's last a has its head at b[B1],
    # equal to it, in its own segment
    assert needs_extra(a, a_off, b, b_off, trace)
    assert any(t[2] != t[3] for t in trace)      # tiles straddle segments
    assert np.array_equal(search_route(a, a_off, b, b_off), want)


def needs_extra(a, a_off, b, b_off, tile_trace):
    """The tiles whose last a has its head at b[B1], equal to it and in
    its own segment: there only the staged b past the range decides."""
    out = []
    for _, _, _, _, A0, A1, _, B1 in tile_trace:
        if A1 == A0 or B1 >= b.size:
            continue
        seg = np.searchsorted(a_off, A1 - 1, "right") - 1
        if b_off[seg] <= B1 < b_off[seg + 1] and a[A1 - 1] == b[B1]:
            out.append(A1)
    return out


@pytest.mark.parametrize("items", [8, MERGE_ITEMS, 16])
def test_card_edge_case_meets_every_edge(items):
    """``chip_smoke.py``'s edge case at the kernel's own tiles (256
    threads x 15) and at the two tiles ``scripts/member_sweep.py`` times
    beside them (x 8 and x 16): tile edges on ties that only the extra b
    decides, tiles that straddle segments, and the emulation right on all
    of it."""
    a, a_off, b, b_off = tie_edges(256 * MERGE_ITEMS, base=(1 << 40) + 7)
    trace = []
    got = merge_route(a, a_off, b, b_off, threads=256, items=items,
                      trace=trace)
    assert np.array_equal(got, oracle(a, a_off, b, b_off).astype(np.int64))
    assert needs_extra(a, a_off, b, b_off, trace)
    assert any(t[2] != t[3] for t in trace)


@pytest.mark.parametrize("variant", ["ties_b_first", "no_extra_b"])
def test_broken_variants_fail_the_check(variant):
    """The tie rule and the staged element past the range are both
    needed: either change gives a wrong mask on the tie cases."""
    threads, items = 4, 4
    a, a_off, b, b_off = tie_edges(threads * items)
    want = oracle(a, a_off, b, b_off).astype(np.int64)
    kw = ({"a_first": False} if variant == "ties_b_first"
          else {"extra": False})
    got = merge_route(a, a_off, b, b_off, threads=threads, items=items, **kw)
    assert not np.array_equal(got, want)
    # and the true design passes the same check
    assert np.array_equal(merge_route(a, a_off, b, b_off, threads=threads,
                                      items=items), want)


def test_tile_co_ranks_are_the_merge_order():
    """Each tile's co-rank (segment, i, j = d - i) is where a sequential
    merge of the segments, a first on ties, stands at that diagonal."""
    rng = np.random.RandomState(5)
    a, a_off, b, b_off = segments(rng, [(40, 30), (0, 9), (17, 0), (0, 0),
                                        (55, 60)], hi=64, repeat=0.5)
    order = []          # the a index consumed so far, at each diagonal
    for s in range(a_off.size - 1):
        i, j = a_off[s], b_off[s]
        while i < a_off[s + 1] or j < b_off[s + 1]:
            order.append((s, i))
            if i < a_off[s + 1] and (j >= b_off[s + 1] or a[i] <= b[j]):
                i += 1
            else:
                j += 1
    for d, (s, i) in enumerate(order):
        assert tile_co_rank(a, a_off, b, b_off, d) == (s, i)


def test_thread_co_ranks_lie_in_the_staged_ranges():
    """Every per-thread co-rank search and merge step reads only staged
    words (``strict`` staging asserts on any other read)."""
    rng = np.random.RandomState(9)
    a, a_off, b, b_off = segments(rng, [(70, 50), (3, 90), (90, 3)], hi=256,
                                  repeat=0.6)
    for threads, items in [(1, 1), (3, 5), (8, 2)]:
        check(a, a_off, b, b_off, threads=threads, items=items)


def test_search_route_windows():
    """The search route's windows: one per lane group of a segment, each
    holding its keys' lower bounds (asserted inside), far smaller than
    the segment's b where b is much the longer."""
    rng = np.random.RandomState(11)
    a, a_off, b, b_off = segments(rng, [(64, 4000), (5, 3000), (40, 0)],
                                  hi=1 << 13)
    windows = []
    got = search_route(a, a_off, b, b_off, windows)
    assert np.array_equal(got, oracle(a, a_off, b, b_off).astype(np.int64))
    assert {s for s, _ in windows} == {0, 1, 2}
    assert max(size for s, size in windows if s == 0) < 4000 // 2


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 40), st.integers(0, 40),
                          st.booleans()), min_size=1, max_size=8),
       st.integers(0, 2 ** 31), st.sampled_from([(2, 2), (4, 4), (3, 8)]))
def test_emulation_matches_oracle_hypothesis(shapes, seed, tiling):
    """Any segments (repeated keys, empty sides, skew either way) and
    small tiles, so every tile edge and segment straddle is met."""
    rng = np.random.RandomState(seed % (2 ** 31))
    repeat = 0.6 if shapes[0][2] else 0.0
    a, a_off, b, b_off = segments(rng, [(n, m) for n, m, _ in shapes],
                                  hi=48, repeat=repeat)
    check(a, a_off, b, b_off, threads=tiling[0], items=tiling[1])


def test_member_route_threshold():
    """The search route from ``SEARCH_RATIO`` keys of b for each key of
    a; the merge route below it, for an empty a and for no segments."""
    for n in (1, 1 << 14, 1 << 20):
        assert member_route(n, SEARCH_RATIO * n, 1) == "search"
        assert member_route(n, SEARCH_RATIO * n - 1, 1) == "merge"
        assert member_route(n, SEARCH_RATIO * n, 4096) == "search"
    assert member_route(1 << 24, 1 << 24, 1) == "merge"
    assert member_route(1 << 14, 1 << 24, 1) == "search"
    assert member_route(1 << 24, 1 << 14, 1) == "merge"
    assert member_route(0, 100, 1) == "merge"
    assert member_route(5, 10_000, 0) == "merge"


# ------------------------------------------------- the port's plain version --
@pytest.mark.parametrize("shapes", [
    [(100, 200)], [(1000, 50), (8, 8)], [(2000, 3000), (0, 5), (7, 0)],
    [(64, 64)] * 5,
])
def test_plain_matches_reference_per_segment(shapes):
    """``sorted_member_mask_segments_plain`` and the wrapper on CPU
    tensors against the reference's Pallas ``intersect_sorted``
    (interpret mode) and ``intersect_sorted_ref``, segment by segment."""
    rng = np.random.RandomState(sum(n + m for n, m in shapes))
    a, a_off, b, b_off = segments(rng, shapes, hi=10_000)
    a_t, b_t = torch.from_numpy(a), torch.from_numpy(b)
    got = sorted_member_mask_segments_plain(a_t, a_off, b_t, b_off).numpy()
    assert np.array_equal(
        sorted_member_mask_segments(a_t, a_off, b_t, b_off).numpy(), got)
    for s in range(a_off.size - 1):
        a_s = a[a_off[s]:a_off[s + 1]]
        b_s = b[b_off[s]:b_off[s + 1]]
        seg = got[a_off[s]:a_off[s + 1]]
        assert np.array_equal(seg, intersect_sorted_ref(a_s, b_s))
        if a_s.size and b_s.size:
            assert np.array_equal(seg, ref_oracle(a_s, b_s))
            ref = np.asarray(ref_intersect_sorted(a_s.astype(np.int32),
                                                  b_s.astype(np.int32)))
            assert np.array_equal(seg, ref)


def test_plain_handles_repeats_and_keys_past_2_40():
    rng = np.random.RandomState(4)
    a, a_off, b, b_off = segments(rng, [(300, 100), (50, 400)], hi=500,
                                  base=(1 << 40) + 1, repeat=0.75)
    got = sorted_member_mask_segments_plain(
        torch.from_numpy(a), a_off, torch.from_numpy(b), b_off).numpy()
    assert np.array_equal(got, oracle(a, a_off, b, b_off))
    # one segment: the one-pair call agrees
    one = sorted_member_mask(torch.from_numpy(a[:300]),
                             torch.from_numpy(b[:100])).numpy()
    assert np.array_equal(one, got[:300])


def test_segment_tags_isin_equals_membership():
    """``torch.isin`` over segment tags (``chip_smoke.py``'s library
    yardstick) equals the membership mask: a key meets only its own
    segment's b."""
    a, a_off, b, b_off = tie_edges(16)
    ta, tb = segment_tags(torch.from_numpy(a), a_off, torch.from_numpy(b),
                          b_off)
    assert torch.all(ta[1:] >= ta[:-1]) and torch.all(tb[1:] > tb[:-1])
    assert np.array_equal(torch.isin(ta, tb).numpy(),
                          oracle(a, a_off, b, b_off))


@pytest.mark.parametrize("bad", [
    ("a_off", [1, 10]), ("a_off", [0, 9]), ("a_off", [0, 11, 10]),
    ("b_off", [0, 5]), ("a_off", [0.0, 10.0]), ("b_off", [0, 3, 20, 20]),
])
def test_offsets_are_checked(bad):
    a = torch.arange(10, dtype=torch.int64)
    b = torch.arange(0, 40, 2, dtype=torch.int64)
    offs = {"a_off": np.array([0, 10], np.int64),
            "b_off": np.array([0, 20], np.int64)}
    offs[bad[0]] = np.array(bad[1])
    with pytest.raises(ValueError):
        sorted_member_mask_segments(a, offs["a_off"], b, offs["b_off"])


# ------------------------------------------------------------ the join path --
def _rows(rng, n, base, n_docs=30):
    docs = np.sort(rng.randint(0, n_docs, n)) + base
    pos = rng.randint(0, 400, n)
    rows = np.stack([docs, pos], 1).astype(np.int64)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


@pytest.fixture
def prefilters(monkeypatch):
    """Counts the membership prefilters ``cuda_join_many`` runs (a launch
    each on the card)."""
    calls = []
    real = port_join.sorted_member_mask_segments

    def counted(a, a_off, b, b_off):
        calls.append(len(a_off) - 1)
        return real(a, a_off, b, b_off)

    monkeypatch.setattr(port_join, "sorted_member_mask_segments", counted)
    return calls


def test_cuda_join_many_matches_pallas_pair_for_pair(prefilters):
    """A round of pairs from a small world, empty pairs and pairs with no
    common doc among them, joined in one prefilter: each equals the
    reference's ``pallas_window_join``."""
    rng = np.random.RandomState(21)
    pairs = []
    for k in range(30):
        base = 100 * (k % 3)
        a = _rows(rng, int(rng.randint(0, 80)), base)
        b = _rows(rng, int(rng.randint(0, 80)),
                  base + (1000 if k % 7 == 0 else 0))
        pairs.append((a, b, int(rng.randint(1, 6))))
    pairs.append((np.zeros((0, 2), np.int64), _rows(rng, 5, 0), 3))
    pairs.append((_rows(rng, 5, 0), np.zeros((0, 2), np.int64), 3))
    got = cuda_join_many(pairs, device="cpu")
    live = sum(1 for a, b, _ in pairs if a.size and b.size)
    assert prefilters == [live]     # one prefilter, a segment a live pair
    for (a, b, w), g in zip(pairs, got):
        assert np.array_equal(g, pallas_window_join(a, b, w))
        assert np.array_equal(cuda_window_join(a, b, w, device="cpu"), g)
    # a round without a non-empty pair runs no prefilter
    del prefilters[:]
    empty = [(np.zeros((0, 2), np.int64), np.zeros((0, 2), np.int64), 3)]
    assert cuda_join_many(empty, device="cpu")[0].shape == (0, 2)
    assert prefilters == []


def _port_world(ref):
    return world_from_arrays(dataclasses.asdict(ref.lexicon), ref.parts,
                             ref.doc_starts)


def _queries(world):
    pools = class_pools(world.lexicon)
    base = core_queries(world.parts[0][0], pools) + [
        RefQuery(tuple(q)) for q in mixed_queries(world.lexicon, n=16)]
    return base + [dataclasses.replace(q, top_k=5, rank="prox")
                   for q in base[::3]]


def _io(sub):
    per = (sub.search_io_per_shard() if hasattr(sub, "search_io_per_shard")
           else [sub.search_io()])
    return [{k: dataclasses.asdict(v) for k, v in shard.items()}
            for shard in per]


def _strip(trace):
    if isinstance(trace, dict):
        return {k: _strip(v) for k, v in trace.items()
                if k not in ("shard_fetch_s", "query_s", "busy_s")}
    return trace


@pytest.fixture(scope="module")
def small_world():
    ref = ref_make_world(0.02, seed=3)
    return ref, _port_world(ref)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_search_batch_cuda_matches_pallas(small_world, n_shards, prefilters,
                                          monkeypatch):
    """``search_batch`` under ``cuda`` (device="cpu": the plain version
    behind the round prefilter) against the reference's ``pallas``:
    results, ``last_trace`` and per-device ``IOStats`` equal; each join
    round with a non-empty pair, as the service forms it, is one
    prefilter over all of them."""
    ref_w, port_w = small_world
    kw = {"build_ordinary_all": True}
    if n_shards == 1:
        ref_sub = ref_build_index_set(ref_w, "set2", **kw)
        port_sub = port_world.build_index_set(port_w, "set2", **kw)
    else:
        ref_sub = ref_build_sharded_index_set(ref_w, "set2", n_shards, **kw)
        port_sub = port_world.build_sharded_index_set(port_w, "set2",
                                                      n_shards, **kw)
    queries = _queries(ref_w)
    ref_svc = RefService(ref_sub, window=3, backend="pallas")
    port_svc = PortService(port_sub, window=3, backend="cuda", device="cpu")
    rounds = []     # the live pairs of each round the service forms
    join_many = PortService._join_many

    def formed(svc, pairs):
        live = sum(1 for a, b, _ in pairs if a.size and b.size)
        if live:
            rounds.append(live)
        return join_many(svc, pairs)

    monkeypatch.setattr(PortService, "_join_many", formed)
    for _ in range(2):      # cold, then warm
        io0, pio0 = _io(ref_sub), _io(port_sub)
        ref = ref_svc.search_batch(queries)
        del rounds[:], prefilters[:]
        got = port_svc.search_batch([
            PortQuery(q.words, q.window, phrase=q.phrase, top_k=q.top_k,
                      rank=q.rank) for q in queries])
        assert rounds and prefilters == rounds
        for r, g in zip(ref, got):
            assert r.route == g.route
            assert np.array_equal(r.docs, g.docs)
            assert np.array_equal(r.witnesses, g.witnesses)
            assert (r.scores is None) == (g.scores is None)
            if r.scores is not None:
                assert np.array_equal(r.scores, g.scores)
        assert len(ref) == len(got)
        assert _strip(ref_svc.last_trace) == _strip(port_svc.last_trace)
        assert [{k: {f: v[f] - io0[s][k][f] for f in v}
                 for k, v in shard.items()}
                for s, shard in enumerate(_io(ref_sub))] == \
            [{k: {f: v[f] - pio0[s][k][f] for f in v}
              for k, v in shard.items()}
             for s, shard in enumerate(_io(port_sub))]


# --------------------------------------------------- the card's inputs --
def test_chip_smoke_member_inputs_and_bound():
    """``chip_smoke.py``'s membership inputs are what the kernel takes
    (each segment of a sorted, of b sorted and distinct, offsets from 0 to
    N and M; posting docs in runs of mean about 4; the threshold cases'
    keys one for each 32 of b), and its bound is the source's: 0.0851 ms
    at 2^24 in 2^24, the search's least work where b is much the
    longer."""
    cs = _chip_smoke()
    rng = np.random.RandomState(2)
    a, a_off, b, b_off = cs.member_segments([(3000, 2000), (0, 7), (9, 0)],
                                            rng, repeat_mean=4.0)
    assert a_off[0] == 0 and a_off[-1] == a.size == 3009
    assert b_off[0] == 0 and b_off[-1] == b.size == 2007
    for s in range(3):
        a_s = a[a_off[s]:a_off[s + 1]]
        b_s = b[b_off[s]:b_off[s + 1]]
        assert np.all(np.diff(a_s) >= 0) and np.all(np.diff(b_s) > 0)
    runs = np.diff(np.flatnonzero(np.diff(a[:3000], prepend=-1,
                                          append=a[2999] + 1)))
    assert 3.0 < runs.mean() < 5.0
    # the threshold cases: one key for each 32 of b, sorted, half in b
    keys = cs.member_ratio_keys(b[:2000], 32, rng)
    assert keys.size == 2000 // 32 and np.all(np.diff(keys) >= 0)
    assert 0.2 < np.isin(keys, b).mean() < 0.8
    bound_ms, by = cs.member_bound(1 << 24, 1 << 24, 1)
    assert by == "bytes" and abs(bound_ms - 0.0851) < 1e-4
    small_a, _ = cs.member_bound(1 << 14, 1 << 24, 1)
    assert small_a == pytest.approx((9 + 32) * (1 << 14) * 1e3 / 3.35e12
                                    + 32e3 / 3.35e12)
