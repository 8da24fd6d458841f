"""What a per-layer metric reads from the program's own spans, in
percent: a span's work over its bound, a span's share of the busy time,
and the idle time inside the program's steps.  They read
``run.trace["program"]`` (:func:`bench.lib.spans.reduce`), and each
returns None where the run has nothing to read: an untraced run, or a
program without the span."""

from __future__ import annotations

from typing import Optional

from bench.lib.hw import bound_s


def _program(run) -> Optional[dict]:
    return None if run.trace is None else run.trace.get("program")


def _span(run, name: str) -> Optional[dict]:
    program = _program(run)
    return None if program is None else program["spans"].get(name)


def roofline(run, name: str, count: str) -> Optional[float]:
    """The bytes of every call of span ``name`` (``run.counts[count]``
    a call) over the bandwidth, over the device time of the kernels
    launched inside the span itself (its backward left out)."""
    s = _span(run, name)
    if s is None or count not in run.counts or s["direct_s"] <= 0:
        return None
    return 100.0 * s["calls"] * bound_s({}, run.counts[count]) / s["direct_s"]


def share(run, name: str) -> Optional[float]:
    """Span ``name``'s device time, its linked backward included, over
    the traced stretch's busy time."""
    s = _span(run, name)
    if s is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (s["direct_s"] + s["linked_s"]) / run.trace["busy_s"]


def step_idle(run) -> Optional[float]:
    """The device's idle time inside the program's steps over the traced
    stretch."""
    program = _program(run)
    if program is None or not program["steps"] or run.trace["window_s"] <= 0:
        return None
    return 100.0 * program["step_idle_s"] / run.trace["window_s"]
