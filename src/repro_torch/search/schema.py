"""Central registry of every key ``SearchService.last_trace`` may carry.

The trace is the audit trail the paper's charge-accounting story hangs
off: ``check_trace_complete`` proves, after every ``search_batch``, that
each planned fetch was executed, skipped, deferred, or shared — never
silently dropped.  That proof only holds if the runtime checker and the
code writing the trace agree on the key set.  PR 7's bug class was
exactly a drift of this kind (a partition counter accumulated ``any(...)``
bools, so the "count" saturated at 1 and the partition still summed).

``TRACE_SCHEMA`` is the single source of truth, consumed from two sides:

* ``SearchService.check_trace_complete`` validates the *runtime* trace
  against it — an undeclared key, wherever it was written, raises
  ``TraceIncompleteError``;
* the static ``trace-schema`` lint pass (``repro.analysis``) validates
  every ``last_trace[...]`` write in the *source tree* against it, so a
  new key fails CI before any test drives the code path.

Adding a trace field is a two-line change: declare it here, write it in
the service.  Forgetting either half fails loudly on the other.
"""

from __future__ import annotations

from typing import Dict, FrozenSet

# Block name -> allowed keys.  "" is the top level of ``last_trace``;
# the other blocks are the nested dicts stored under the same-named
# top-level key ("topk", "cache", "replicas", "compactions").
TRACE_SCHEMA: Dict[str, FrozenSet[str]] = {
    "": frozenset({
        # scatter-fetch wave accounting (stage 2)
        "waves", "executed_waves", "skipped_waves",
        "lookups_planned", "lookups_fetched", "lookups_deferred",
        "prefetched_waves", "overlapped_finalizes", "shard_fetch_s",
        # batch-level pins and nested blocks
        "snapshot", "topk", "cache", "compactions", "replicas",
    }),
    "topk": frozenset({
        "queries", "ranked_queries",
        "early_terminated", "threshold_stops", "bound_stops",
        "fully_drained", "threshold_checks",
        "chunks_planned", "chunks_fetched", "chunks_skipped",
        "chunks_shared",
        "bytes_planned", "bytes_fetched", "bytes_skipped", "bytes_shared",
        "query_s", "pool_streams",
    }),
    "cache": frozenset({
        "hits", "misses", "evictions", "invalidations", "full_drops",
        "bytes_used", "pool_hits", "device_hits", "partial_admits",
    }),
    "replicas": frozenset({
        "n_replicas", "snapshot", "live", "failovers", "failovers_batch",
        "waves", "lookups", "cursors", "busy_s", "catch_ups",
    }),
    "compactions": frozenset({
        "compactions", "compacted_streams",
    }),
}

# Counters that participate in a completeness partition (LHS == sum of
# RHS members).  These MUST be incremented with integer expressions —
# a bool lands in the sum as 0/1 and the partition can still balance
# while the count is wrong (the PR 7 ``any(...)`` accumulation bug).
# The static trace-schema pass rejects bool-valued writes to these keys.
TRACE_COUNTERS: FrozenSet[str] = frozenset({
    "waves", "executed_waves", "skipped_waves",
    "lookups_planned", "lookups_fetched", "lookups_deferred",
    "queries", "early_terminated", "threshold_stops", "bound_stops",
    "fully_drained",
    "chunks_planned", "chunks_fetched", "chunks_skipped", "chunks_shared",
    "bytes_planned", "bytes_fetched", "bytes_skipped", "bytes_shared",
})


def validate_trace(trace: Dict[str, object]) -> str:
    """Return "" if every key in ``trace`` (top level and nested blocks)
    is declared in :data:`TRACE_SCHEMA`, else a human-readable message
    naming the first undeclared key.  Pure check — never raises — so the
    caller decides the failure type."""
    for key in trace:
        if key not in TRACE_SCHEMA[""]:
            return f"undeclared top-level trace key {key!r}"
        block = TRACE_SCHEMA.get(key)
        if block is None:
            continue
        sub = trace.get(key)
        if isinstance(sub, dict):
            for k in sub:
                if k not in block:
                    return f"undeclared trace key {k!r} in block {key!r}"
    return ""
