"""A bounded stretch of steps under ``torch.profiler``, reduced to what
the per-layer metrics and the breakdown read.

The reduction reads the profiler's raw events (no ``key_averages``,
which takes tens of seconds on a granite step):

  * the stretch is the host interval of the ``bench::stretch`` range;
    the device is busy where any kernel, copy or fill runs, the union of
    their intervals within it;
  * a kernel belongs to a span (a profiler op, or a range the benchmark
    puts around a call) when the CUDA runtime call that launched it ran
    inside that op on the same host thread; launches through the port's
    ``ctypes`` library are linked the same way;
  * ``device_ops`` sums kernel time by the op that launched each kernel;
    ``idle_gaps`` sums the device's idle time by the innermost host event
    running at each gap's middle.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Callable, Dict, List, Sequence, Tuple

import torch

STRETCH = "bench::stretch"
TOP = 10
GAP_SCAN = 20_000      # host events looked back through for a gap's name
RUNTIME_PREFIX = "cu"  # cudaLaunchKernel, cuLaunchKernelEx, cudaMemsetAsync


@contextlib.contextmanager
def ranges(patches: Sequence[Tuple[object, str, str]]):
    """Each ``(module, attribute, label)`` function wrapped in a
    profiler range named ``label`` while the block runs."""
    from torch.profiler import record_function

    saved = []
    for mod, attr, label in patches:
        fn = getattr(mod, attr)

        def wrapped(*args, _fn=fn, _label=label, **kw):
            with record_function(_label):
                return _fn(*args, **kw)
        saved.append((mod, attr, fn))
        setattr(mod, attr, wrapped)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def profile(step: Callable[[], None], n: int, patches) -> list:
    """The raw events of ``n`` calls of ``step`` (the stretch, which ends
    in a synchronize by ``step``'s own last call) under the profiler,
    with the ``patches`` ranges and the stretch range.  One call before
    the stretch runs under the profiler and is thrown away: it takes the
    profiler's start-up."""
    from torch.profiler import ProfilerActivity, record_function, schedule
    from torch.profiler import profile as torch_profile

    got = []
    with ranges(patches), torch_profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: got.extend(
                p.profiler.kineto_results.events())) as prof:
        step()
        prof.step()
        with record_function(STRETCH):
            for _ in range(n):
                step()
        prof.step()
    return got


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events: list, spans: Dict[str, str]) -> dict:
    """``busy_s``, ``window_s``, each span's device seconds
    (``span_s``) and op count (``span_calls``), ``device_ops`` and
    ``idle_gaps``."""
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    cpu = [e for e in events if e.device_type() == CPU]
    dev = [e for e in events if e.device_type() == CUDA
           and not e.is_user_annotation()]
    (st,) = [e for e in cpu if e.name() == STRETCH]
    s0, s1 = st.start_ns(), st.start_ns() + st.duration_ns()
    busy = _union([(max(e.start_ns(), s0),
                    min(e.start_ns() + e.duration_ns(), s1))
                   for e in dev if e.start_ns() + e.duration_ns() > s0
                   and e.start_ns() < s1])
    busy_ns = sum(b - a for a, b in busy)

    launch, op_name = {}, {}
    for e in cpu:
        if e.name().startswith(RUNTIME_PREFIX):
            launch[e.correlation_id()] = e
        else:
            op_name.setdefault(e.correlation_id(), e.name())
    by_label: Dict[str, Dict[int, List[Tuple[int, int]]]] = {}
    span_calls = {}
    for label, name in spans.items():
        per_thread = defaultdict(list)
        for e in cpu:
            if e.name() == name:
                per_thread[e.start_thread_id()].append(
                    (e.start_ns(), e.start_ns() + e.duration_ns()))
        by_label[label] = {t: sorted(v) for t, v in per_thread.items()}
        span_calls[label] = sum(len(v) for v in per_thread.values())

    def inside(intervals, t):
        i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
        return i >= 0 and intervals[i][0] <= t <= intervals[i][1]

    span_ns = dict.fromkeys(spans, 0)
    ops = defaultdict(int)
    for k in dev:
        ops[op_name.get(k.linked_correlation_id(), k.name())[:80]] += \
            k.duration_ns()
        rt = launch.get(k.correlation_id())
        if rt is None:
            continue
        for label, per_thread in by_label.items():
            if inside(per_thread.get(rt.start_thread_id(), ()), rt.start_ns()):
                span_ns[label] += k.duration_ns()

    gaps = [(a1, b0) for (_, a1), (b0, _) in zip(busy, busy[1:])]
    if busy:
        gaps = [(s0, busy[0][0])] + gaps + [(busy[-1][1], s1)]
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:200]
    host = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in cpu if e.name() != STRETCH))
    starts = [h[0] for h in host]
    idle = defaultdict(int)
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "host: between ops"
        for j in range(i, max(i - GAP_SCAN, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2][:80]
                break
        idle[name] += b - a

    def top(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"busy_s": busy_ns / 1e9, "window_s": (s1 - s0) / 1e9,
            "span_s": {k: v / 1e9 for k, v in span_ns.items()},
            "span_calls": span_calls,
            "device_ops": top(ops), "idle_gaps": top(idle)}
