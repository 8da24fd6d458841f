"""The program's own spans in a profiled stretch: each kernel charged to
the ``repro::`` span of the port (``repro_torch.obs.span``) that issued
it, and the device's idle time inside the program's steps.

It reads the same raw events as :func:`bench.lib.trace.reduce`:

  * a kernel (or copy, or fill) is charged to the innermost ``repro::``
    span open on the host thread of the CUDA runtime call that launched
    it (``direct``);
  * a launch inside a backward op (an autograd node, an op that names
    its forward thread) and in no span opened inside that op is charged
    through the op's ``(fwd_thread_id, sequence_nr)`` to its forward op,
    and so to the innermost span around that (``linked``): the backward
    of a norm is the norm's, wherever autograd runs it.  A checkpointed
    block's recompute runs inside a backward op: its own spans take its
    kernels directly, and the rest go by the link;
  * a kernel with neither is ``uncovered``;
  * ``step_idle_s`` is the device's idle time inside the outermost spans
    of the stretch's own thread (a training step, a serving forward):
    the idle the program causes, not the benchmark's wait between
    steps.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from bench.lib.trace import RUNTIME_PREFIX, STRETCH, _union

# the port's span prefix (repro_torch.obs.PREFIX), not imported: the
# benchmark also runs on a port without spans
PREFIX = "repro::"
TOP = 12   # op names kept a span; the rest summed under OTHER
OTHER = "(other ops)"
BACKWARD = "bwd "   # before the op name of a kernel charged by the link


class _Nested:
    """One thread's intervals, which nest as a call stack's do: the
    innermost one around a time."""

    def __init__(self, items: List[Tuple[int, int, object]]):
        self.items = sorted(items, key=lambda x: (x[0], -x[1]))
        self.starts = [a for a, _, _ in self.items]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (a, _, _) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] < a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: int):
        """The innermost interval around ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][1] < t:
            i = self.parent[i]
        return None if i < 0 else self.items[i]

    def outermost(self) -> List[Tuple[int, int, object]]:
        return [x for x, p in zip(self.items, self.parent) if p < 0]


def _by_thread(events) -> Dict[int, _Nested]:
    per = defaultdict(list)
    for e in events:
        per[e.start_thread_id()].append(
            (e.start_ns(), e.start_ns() + e.duration_ns(), e))
    return defaultdict(lambda: _Nested([]),
                       {t: _Nested(v) for t, v in per.items()})


def _overlap(a: int, b: int, busy: List[Tuple[int, int]],
             starts: List[int]) -> int:
    """How much of ``[a, b]`` the sorted, disjoint ``busy`` covers."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    got = 0
    while i < len(busy) and busy[i][0] < b:
        got += max(0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return got


def reduce(events: list) -> dict:
    """``spans`` (each span name's ``calls``, ``direct_s``, ``linked_s``
    and its device seconds by launching op, ``ops``), ``covered_s``,
    ``uncovered_s`` and ``uncovered_ops``, ``steps`` (the outermost spans
    on the stretch's thread), ``step_s`` (their host time) and
    ``step_idle_s``."""
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    cpu = [e for e in events if e.device_type() == CPU]
    dev = [e for e in events if e.device_type() == CUDA
           and not e.is_user_annotation()]
    launch, op_name, forward = {}, {}, {}
    spans, backward = [], []
    for e in cpu:
        name = e.name()
        if name.startswith(RUNTIME_PREFIX):
            launch[e.correlation_id()] = e
            continue
        op_name.setdefault(e.correlation_id(), name)
        if name.startswith(PREFIX):
            spans.append(e)
        elif e.fwd_thread_id() > 0:
            backward.append(e)
        elif e.sequence_nr() >= 0:
            # the op that made autograd node (thread, seq) started last
            # of those that read seq: any before it made no node
            key = (e.start_thread_id(), e.sequence_nr())
            if key not in forward or forward[key].start_ns() < e.start_ns():
                forward[key] = e
    span_at, backward_at = _by_thread(spans), _by_thread(backward)

    calls = defaultdict(int)
    for e in spans:
        calls[e.name()] += 1
    direct, linked = defaultdict(int), defaultdict(int)
    ops: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    uncovered = defaultdict(int)
    for k in dev:
        ns = k.duration_ns()
        op = op_name.get(k.linked_correlation_id(), k.name())[:80]
        rt = launch.get(k.correlation_id())
        if rt is None:
            uncovered[op] += ns
            continue
        tid, t = rt.start_thread_id(), rt.start_ns()
        s, b = span_at[tid].at(t), backward_at[tid].at(t)
        owner = None
        if b is not None and (s is None or s[0] < b[0]):
            fwd = forward.get((b[2].fwd_thread_id(), b[2].sequence_nr()))
            if fwd is not None:
                owner = span_at[fwd.start_thread_id()].at(fwd.start_ns())
            if owner is not None:
                name = owner[2].name()
                linked[name] += ns
                ops[name][BACKWARD + op] += ns
                continue
        if s is None:
            uncovered[op] += ns
            continue
        name = s[2].name()
        direct[name] += ns
        ops[name][op] += ns

    def top(d: Dict[str, int]) -> List[list]:
        ranked = sorted(d.items(), key=lambda kv: -kv[1])
        out = [[k, v / 1e9] for k, v in ranked[:TOP]]
        rest = sum(v for _, v in ranked[TOP:])
        return out + ([[OTHER, rest / 1e9]] if rest else [])

    out = {"spans": {name: {"calls": calls[name],
                            "direct_s": direct[name] / 1e9,
                            "linked_s": linked[name] / 1e9,
                            "ops": top(ops[name])} for name in calls},
           "covered_s": (sum(direct.values()) + sum(linked.values())) / 1e9,
           "uncovered_s": sum(uncovered.values()) / 1e9,
           "uncovered_ops": top(uncovered)}
    out.update(_steps(cpu, dev, span_at))
    return out


def _steps(cpu, dev, span_at) -> dict:
    """The outermost spans on the stretch's thread, their host time and
    the device's idle time inside them, within the stretch."""
    (st,) = [e for e in cpu if e.name() == STRETCH]
    s0, s1 = st.start_ns(), st.start_ns() + st.duration_ns()
    busy = _union([(max(e.start_ns(), s0),
                    min(e.start_ns() + e.duration_ns(), s1))
                   for e in dev if e.start_ns() + e.duration_ns() > s0
                   and e.start_ns() < s1])
    starts = [a for a, _ in busy]
    steps = [(max(a, s0), min(b, s1))
             for a, b, _ in span_at[st.start_thread_id()].outermost()
             if b > s0 and a < s1]
    host = sum(b - a for a, b in steps)
    idle = host - sum(_overlap(a, b, busy, starts) for a, b in steps)
    return {"steps": len(steps), "step_s": host / 1e9,
            "step_idle_s": idle / 1e9}
