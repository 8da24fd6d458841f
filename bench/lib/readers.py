"""What the per-layer metric files share: shares of a bound, in
percent, from a run's counts, reduced trace and step time.  Each
returns None where the run has nothing to read."""

from __future__ import annotations

from typing import Optional

from bench.lib.hw import bound_s


def _share(bound: float, seconds: float) -> Optional[float]:
    return None if seconds <= 0 else 100.0 * bound / seconds


def step_mfu(run, with_bytes: bool) -> Optional[float]:
    """The step's counted bound (its FLOPs over each dtype's peak, and
    with ``with_bytes`` its bytes over the bandwidth, the larger) over
    the window's mean step time."""
    c = run.counts
    if with_bytes and "step_bytes" not in c:
        return None
    return _share(bound_s(c["flops"], c["step_bytes"] if with_bytes else 0),
                  run.step_s)


def span_roofline(run, label: str, nbytes_per_call: float,
                  flops_per_call: float = 0.0,
                  dtype: str = "bf16") -> Optional[float]:
    """The bound of every call of a span in the traced stretch over the
    device time of the kernels it launched."""
    if run.trace is None or label not in run.trace["span_s"]:
        return None
    calls = run.trace["span_calls"][label]
    if calls == 0:
        return None
    bound = calls * bound_s({dtype: flops_per_call}, nbytes_per_call)
    return _share(bound, run.trace["span_s"][label])


def adamw(run) -> Optional[float]:
    return span_roofline(run, "adamw", run.counts["adamw_bytes"])


def flash(run, label: str) -> Optional[float]:
    if label not in run.counts:
        return None
    flops, nbytes = run.counts[label]
    return span_roofline(run, label, nbytes, flops)


def bag(run) -> Optional[float]:
    if "bag_forward_bytes" not in run.counts:
        return None
    return span_roofline(run, "bag_forward", run.counts["bag_forward_bytes"])


def idle(run) -> Optional[float]:
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])

