"""Spans at the port's layer boundaries, on the profiler's clock.

``with span("optimizer"):`` marks a stretch of the program as a
``torch.profiler`` range named ``repro::optimizer`` while a profiler
session records, and does nothing otherwise: tracing is on exactly when
a profiler is.  A range shares the profiler's clock, thread and nesting
with the ops and kernel launches inside it, so a reader of the trace
charges each kernel to the innermost span that issued it.  No span is
kept anywhere but in the profiler's own record.

With no profiler recording, :func:`span` returns one shared
``nullcontext`` and creates no ``RecordFunction``: a span then costs a
flag read and a ``with`` (under half a microsecond), where an idle
``record_function`` costs several.

The spans, each at a layer's boundary: ``train.step`` (a step of
``Trainer.fit``), ``optimizer`` (``adamw_update``), ``lookup`` (the
grouped bag, ``embedding_bags``), ``dlrm.forward``, and the LM's
``lm.cast`` (a master weight cast to the compute dtype), ``lm.norm``,
``lm.rope`` and ``lm.loss`` (the unembedding and the chunked loss).
Those inside a block that ``torch.utils.checkpoint`` recomputes run
again in the backward pass, on autograd's thread.
``bench/lib/spans.py`` charges each kernel of a profiled stretch to
them.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

PREFIX = "repro::"
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that is the profiler range ``repro::<name>`` while a
    profiler records, and a shared no-op context while none does."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(PREFIX + name)
