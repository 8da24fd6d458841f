"""The port's spans (``repro_torch.obs``) on the CPU: nothing with no
profiler, a ``repro::`` range a use under one, the LM's spans once per
use per microbatch, forward and recompute, and a step's values the same
either way."""

import contextlib

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs.registry import get_bundle, get_training
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves
from torch_threads import one_torch_thread  # noqa: F401

MICRO = 2


def test_no_profiler_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range made with no profiler: {name}")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    off = obs.span("optimizer")
    assert isinstance(off, contextlib.nullcontext)
    assert obs.span("lm.norm") is off
    with off, obs.span("lm.cast"):
        pass


def test_a_span_is_a_named_range_while_a_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = obs.span("lm.rope")
        with on:
            torch.ones(3).mul_(2)
    assert not isinstance(on, contextlib.nullcontext)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("repro::lm.rope") == 1
    assert obs.span("lm.rope") is obs.span("optimizer")


def _granite(profiled: bool = False):
    """Two ``Trainer`` steps of the REDUCED granite bundle, two
    microbatches a step, the second under a profiler where
    ``profiled``; the trainer and the second step's events."""
    b = get_bundle("granite-3-2b", reduced=True)
    params = b.init(torch.Generator().manual_seed(3))
    tr = Trainer(b.loss_fn(), params, TrainerConfig(
        opt=OptConfig(lr=3e-3), microbatches=MICRO, log_every=1),
        device="cpu")
    tokens = torch.randint(0, b.config.vocab, (4, 65),
                           generator=torch.Generator().manual_seed(4),
                           dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def batches(cursor):
        return batch
    tr.fit(batches, 1)
    if not profiled:
        tr.fit(batches, 2)
        return b.config, tr, None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.fit(batches, 2)
    return b.config, tr, prof.profiler.kineto_results.events()


def _dlrm(profiled: bool):
    tr = get_training("dlrm-mlperf", reduced=True)
    cfg, B = tr.config, 64
    g = torch.Generator().manual_seed(5)
    params = tr.init(cfg, g, masters=True)
    batch = {"dense": torch.randn(B, cfg.n_dense, generator=g),
             "sparse": torch.stack([torch.randint(0, rows, (B,), generator=g)
                                    for rows in cfg.table_rows], 1),
             "label": torch.randint(0, 2, (B,), generator=g).float()}
    t = Trainer(tr.loss_fn(), params, TrainerConfig(log_every=1),
                device="cpu")
    t.fit(lambda c: batch, 1)
    if not profiled:
        t.fit(lambda c: batch, 2)
        return t, None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.fit(lambda c: batch, 2)
    return t, prof.profiler.kineto_results.events()


def _counts(events):
    out = {}
    for e in events:
        if e.name().startswith(obs.PREFIX):
            out[e.name()] = out.get(e.name(), 0) + 1
    return out


def test_an_lm_step_records_each_span_per_use_per_microbatch():
    cfg, _, events = _granite(profiled=True)
    L = cfg.n_layers
    assert cfg.remat != "none"     # each block runs again in the backward
    # forward and recompute: a block's three cast sites (Q/K/V's weights
    # one a weight, wo's, the MLP's three), two norms and one rope; the
    # embedding's and unembedding's casts, the final norm and the loss
    # once
    assert _counts(events) == {
        "repro::train.step": 1, "repro::optimizer": 1,
        "repro::lm.cast": MICRO * (2 + 2 * L * 7),
        "repro::lm.norm": MICRO * (1 + 2 * L * 2),
        "repro::lm.rope": MICRO * 2 * L,
        "repro::lm.loss": MICRO}


def test_a_dlrm_step_records_its_spans():
    _, events = _dlrm(profiled=True)
    assert _counts(events) == {"repro::train.step": 1,
                               "repro::optimizer": 1,
                               "repro::dlrm.forward": 1,
                               "repro::lookup": 1}


def test_a_norms_backward_links_to_its_forward_op_in_the_norm_span():
    """``rsqrt`` is the norm's alone: each of its backward ops names its
    forward op by ``(fwd_thread_id, sequence_nr)``, and that op, the last
    to read the sequence number on that thread, lies inside a
    ``repro::lm.norm`` range."""
    cfg, _, events = _granite(profiled=True)
    norms = [(e.start_thread_id(), e.start_ns(),
              e.start_ns() + e.duration_ns()) for e in events
             if e.name() == "repro::lm.norm"]
    last = {}
    for e in events:
        if e.fwd_thread_id() == 0 and e.sequence_nr() >= 0:
            key = (e.start_thread_id(), e.sequence_nr())
            if key not in last or last[key].start_ns() < e.start_ns():
                last[key] = e
    backward = [e for e in events if e.name() == "RsqrtBackward0"]
    # a norm a block twice and the final one, each microbatch
    assert len(backward) == MICRO * (2 * cfg.n_layers + 1)
    for b in backward:
        fwd = last[(b.fwd_thread_id(), b.sequence_nr())]
        assert fwd.name() == "aten::rsqrt"
        assert any(t == fwd.start_thread_id() and a <= fwd.start_ns() <= z
                   for t, a, z in norms)


def test_a_profiler_changes_no_value():
    for run in (lambda p: _granite(p)[1], lambda p: _dlrm(p)[0]):
        plain, traced = run(False), run(True)
        assert [h["loss"] for h in plain.history] == \
            [h["loss"] for h in traced.history]
        for a, b in zip(leaves(plain.params), leaves(traced.params)):
            assert torch.equal(a, b)
        for a, b in zip(leaves(plain.opt_state), leaves(traced.opt_state)):
            assert torch.equal(a, b)
