"""The reduction of the program's own spans (``bench/lib/spans.py``) on
hand-built event lists, and on a tiny traced run of each cell on the
CPU; and the arithmetic that metrics read from it
(``bench/lib/span_readers.py``)."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench.lib import harness, span_readers, spans
from bench.lib import trace as tracing

ROOT = Path(__file__).resolve().parents[2]
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    """One raw profiler event, as much of it as the reductions read."""

    def __init__(self, name, t0, t1, tid=1, dev=CPU, corr=0, linked=0,
                 seq=-1, fwd=0):
        self._name, self._t0, self._dur, self._tid = name, t0, t1 - t0, tid
        self._dev, self._corr, self._linked = dev, corr, linked
        self._seq, self._fwd = seq, fwd

    def name(self):
        return self._name

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._dur

    def start_thread_id(self):
        return self._tid

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def sequence_nr(self):
        return self._seq

    def fwd_thread_id(self):
        return self._fwd


def kernel(t0, t1, corr, op_corr):
    return Ev("kernel", t0, t1, tid=7, dev=CUDA, corr=corr, linked=op_corr)


def launch(t, corr, tid=1):
    return Ev("cudaLaunchKernel", t, t + 5, tid=tid, corr=corr)


def step(*events):
    """A stretch on thread 1 holding one ``repro::train.step``."""
    return [Ev(tracing.STRETCH, 0, 10_000, corr=999),
            Ev("repro::train.step", 100, 9_000, corr=1), *events]


def ops(entry):
    return {k: round(v * 1e9) for k, v in entry["ops"]}


def test_a_kernel_goes_to_the_innermost_span_on_its_launching_thread():
    got = spans.reduce(step(
        Ev("repro::lm.norm", 1_000, 2_000, corr=2),
        Ev("aten::mul", 1_100, 1_900, corr=3, seq=5),
        launch(1_200, 100), kernel(1_500, 1_800, 100, 3),
        # launched in the step, outside the norm
        Ev("aten::mm", 3_000, 3_500, corr=4, seq=6),
        launch(3_100, 101), kernel(3_200, 3_700, 101, 4),
        # thread 2 has no span open, though thread 1's norm is
        Ev("aten::add", 1_300, 1_400, tid=2, corr=5),
        launch(1_310, 102, tid=2), kernel(2_000, 2_100, 102, 5)))
    norm = got["spans"]["repro::lm.norm"]
    st = got["spans"]["repro::train.step"]
    assert (norm["calls"], norm["direct_s"], norm["linked_s"]) == (1, 3e-7, 0)
    assert ops(norm) == {"aten::mul": 300}
    assert (st["direct_s"], ops(st)) == (5e-7, {"aten::mm": 500})
    assert got["uncovered_s"] == 1e-7
    assert got["uncovered_ops"] == [["aten::add", 1e-7]]
    assert got["covered_s"] == pytest.approx(8e-7)


def test_a_backward_kernel_goes_to_its_forward_ops_span():
    got = spans.reduce(step(
        Ev("repro::lm.norm", 1_000, 2_000, corr=2),
        # seq 8 read by a view before the op that made node 8 (the mul)
        Ev("aten::view", 900, 950, corr=3, seq=8),
        Ev("aten::mul", 1_100, 1_900, corr=4, seq=8),
        Ev("aten::mm", 2_500, 2_900, corr=5, seq=9),
        # autograd's thread: the mul's backward, then the mm's, inside
        # which a recompute opens its own norm
        Ev("MulBackward0", 5_000, 5_500, tid=2, corr=6, seq=8, fwd=1),
        Ev("aten::mul", 5_100, 5_400, tid=2, corr=7),
        launch(5_200, 100, tid=2), kernel(5_300, 5_700, 100, 7),
        Ev("MmBackward0", 6_000, 7_000, tid=2, corr=8, seq=9, fwd=1),
        Ev("repro::lm.norm", 6_100, 6_400, tid=2, corr=9),
        Ev("aten::mul", 6_150, 6_350, tid=2, corr=10, seq=0),
        launch(6_200, 101, tid=2), kernel(6_300, 6_500, 101, 10),
        Ev("aten::mm", 6_500, 6_900, tid=2, corr=11),
        launch(6_600, 102, tid=2), kernel(6_700, 7_300, 102, 11)))
    norm = got["spans"]["repro::lm.norm"]
    st = got["spans"]["repro::train.step"]
    assert norm["calls"] == 2
    assert (norm["direct_s"], norm["linked_s"]) == (2e-7, 4e-7)
    assert ops(norm) == {"bwd aten::mul": 400, "aten::mul": 200}
    assert (st["direct_s"], st["linked_s"]) == (0, 6e-7)
    assert ops(st) == {"bwd aten::mm": 600}
    assert got["uncovered_s"] == 0


def test_a_backward_inside_an_outer_span_still_takes_the_link():
    """Where autograd runs on the caller's thread (the CPU), the step's
    span is open around the backward: the link is the more precise."""
    got = spans.reduce(step(
        Ev("repro::lm.rope", 1_000, 2_000, corr=2),
        Ev("aten::cat", 1_100, 1_900, corr=3, seq=4),
        Ev("CatBackward0", 5_000, 5_500, corr=4, seq=4, fwd=1),
        Ev("aten::slice", 5_100, 5_400, corr=5),
        launch(5_200, 100), kernel(5_300, 5_400, 100, 5)))
    assert got["spans"]["repro::lm.rope"]["linked_s"] == 1e-7
    assert got["spans"]["repro::train.step"]["direct_s"] == 0


def test_time_no_span_covers():
    got = spans.reduce(step(
        # launched before the step opens
        Ev("aten::zero_", 20, 60, corr=2),
        launch(30, 100), kernel(40, 90, 100, 2),
        # a backward whose forward op is outside the stretch's events
        Ev("AddBackward0", 9_500, 9_800, tid=2, corr=3, seq=99, fwd=1),
        Ev("aten::add", 9_510, 9_790, tid=2, corr=4),
        launch(9_520, 101, tid=2), kernel(9_600, 9_700, 101, 4),
        # a kernel whose launch the trace lacks
        kernel(9_100, 9_200, 102, 0)))
    assert got["covered_s"] == 0
    assert got["uncovered_s"] == pytest.approx(2.5e-7)
    assert dict(got["uncovered_ops"]) == pytest.approx(
        {"aten::zero_": 5e-8, "aten::add": 1e-7, "kernel": 1e-7})


def test_step_idle_is_the_idle_inside_the_outermost_spans_of_the_stretch():
    events = step(
        launch(200, 100), kernel(50, 1_100, 100, 0),       # 100-1,100 busy
        launch(300, 101), kernel(2_000, 3_000, 101, 0),    # 1,000 busy
        launch(400, 102), kernel(2_500, 3_500, 102, 0),    # overlaps: 500
        launch(500, 103), kernel(8_900, 9_500, 103, 0),    # 100 inside
        # a span outermost on another thread is no step
        Ev("repro::lm.norm", 9_200, 9_900, tid=2, corr=9))
    got = spans.reduce(events)
    assert (got["steps"], got["step_s"]) == (1, 8.9e-6)
    busy_inside = 1_000 + 1_500 + 100
    assert got["step_idle_s"] == pytest.approx((8_900 - busy_inside) / 1e9)
    # a second step later in the stretch adds its own idle
    events += [Ev("repro::train.step", 9_600, 9_800, corr=10)]
    got = spans.reduce(events)
    assert got["steps"] == 2
    assert got["step_idle_s"] == pytest.approx((9_100 - busy_inside) / 1e9)


def test_ops_past_the_top_are_summed():
    events = [Ev("repro::lm.cast", 1_000, 8_000, corr=2)]
    for i in range(spans.TOP + 3):
        events += [Ev(f"aten::op{i}", 1_000 + 100 * i, 1_050 + 100 * i,
                      corr=10 + i),
                   launch(1_010 + 100 * i, 100 + i),
                   kernel(1_020 + 100 * i, 1_030 + 100 * i + i, 100 + i,
                          10 + i)]
    got = ops(spans.reduce(step(*events))["spans"]["repro::lm.cast"])
    assert len(got) == spans.TOP + 1
    assert got[spans.OTHER] == sum(10 + i for i in range(3))
    assert sum(got.values()) == sum(10 + i for i in range(spans.TOP + 3))


def _run(program, counts=None, busy=2.0, window=4.0):
    return SimpleNamespace(counts=counts or {}, step_s=1.0, trace=None
                           if program is None else {
                               "busy_s": busy, "window_s": window,
                               "program": program})


def test_the_readers_arithmetic():
    from bench.lib.hw import HBM_BYTES_PER_S
    program = {"spans": {
        "repro::optimizer": {"calls": 4, "direct_s": 0.5, "linked_s": 0,
                             "ops": []},
        "repro::lm.norm": {"calls": 9, "direct_s": 0.1, "linked_s": 0.3,
                           "ops": []}},
        "steps": 4, "step_idle_s": 0.2}
    run = _run(program, {"adamw_bytes": HBM_BYTES_PER_S / 100})
    assert span_readers.roofline(run, "repro::optimizer", "adamw_bytes") \
        == pytest.approx(100 * 4 * 0.01 / 0.5)
    assert span_readers.share(run, "repro::lm.norm") == pytest.approx(20)
    assert span_readers.step_idle(run) == pytest.approx(5)
    # nothing to read: untraced, no such span, no such count, no steps
    assert span_readers.share(_run(None), "repro::lm.norm") is None
    assert span_readers.share(run, "repro::lm.rope") is None
    assert span_readers.roofline(run, "repro::optimizer", "x") is None
    assert span_readers.step_idle(_run({**program, "steps": 0})) is None
    # a traced run that lacks the program's reduction reads nothing
    assert span_readers.step_idle(SimpleNamespace(
        counts={}, step_s=1.0, trace={"busy_s": 1, "window_s": 1})) is None


def _traced(workload, root):
    """A tiny traced run of ``workload`` on the CPU, its stretch also
    reduced by ``spans.reduce``; the run's ``program`` and mix."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import span_report
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    got = span_report.traced_cell(workload, 2 ** 31 + 17, 0.1,
                                  device="cpu", root=root)
    return got, harness.cell_spec(workload, root)["mix"]


CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_cell_records_the_programs_spans(workload, tiny_root):
    got, mix = _traced(workload, tiny_root)
    n = mix["trace_steps"]
    program = got["program"]
    calls = {k: v["calls"] for k, v in program["spans"].items()}
    assert program["steps"] == n
    assert 0 < program["step_s"] <= got["traced_step_s"] * n
    # no kernel on the CPU: the host's whole step is the device's idle
    assert program["step_idle_s"] == program["step_s"]
    assert program["covered_s"] == program["uncovered_s"] == 0
    if mix["driver"] == "serve":
        assert calls == {"repro::dlrm.forward": n, "repro::lookup": n}
    elif "seq" not in mix:
        assert calls == {"repro::train.step": n, "repro::optimizer": n,
                         "repro::dlrm.forward": n, "repro::lookup": n}
    else:
        assert calls["repro::train.step"] == calls["repro::optimizer"] == n
        assert calls["repro::lm.loss"] == n * mix["microbatches"]
    assert got["program_metrics"]["step_idle"] > 0
    json.dumps(got)
