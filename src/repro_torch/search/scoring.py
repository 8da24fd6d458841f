"""Ranked-retrieval scoring for the streaming top-k executor.

The sequel paper (arXiv:2108.00410, "Relevance ranking for proximity
full-text search based on additional indexes with multi-component keys")
ranks documents by combining a *proximity* contribution — how tightly the
query words co-occur, which is exactly what the (w, v) and multi-component
key records encode — with a tf-style *occurrence* weight.  This module is
the single source of truth for that score on both executor paths:

  * ``score_docs``        — the numpy int64 reference,
  * ``score_docs_torch``  — the same arithmetic as int64 torch ops on the
    device, for the torch / cuda backends.

**Model.**  Each planned lookup occurrence (a *slot*) contributes
``w_slot * tf_sat(c_slot(doc))`` where ``c_slot(doc)`` is the number of
postings of the slot's key in that document and ``tf_sat`` saturates at
``TF_CAP``.  ``w_slot`` is the proximity weight of the route's record
distance ``d``: phrase / multi / stop-sequence records witness adjacent
words (``d = 1``), (w, v) records are precomputed at ``max_distance``,
ordinary-route slots get the query window.  All-integer arithmetic —
``PROX_SCALE // (1 + d)`` weights, integer counts, integer cap — makes
the score *exact*, so numpy / torch / cuda and every shard count produce
element-wise identical ranked heads (no float tolerance anywhere).

**Why counts are per-slot key postings** (not join-witness rows): the
streaming executor settles doc-id regions that contain *every* posting of
every slot for the settled docs, and the exhaustive oracle can recount
the same quantity from whole-list lookups — the two paths compute the
identical integer without sharing any code path.

**Why tf saturates.**  The saturation is what makes WAND-style pruning
possible at all: a slot's score contribution is bounded by
``w_slot * min(max_doc_count, TF_CAP)`` where ``max_doc_count`` (carried
on the dictionary entry and its cursors) is the key's largest per-doc
posting count.  Without the cap the upper bound would grow with the
largest document and the threshold test would almost never fire.

``head_order`` pins the deterministic result order shared by the
executor and the test oracles: ranked mode sorts (score desc, doc id
asc); doc-id mode keeps ascending doc ids.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.postings import max_doc_run
from repro_torch.device import DeviceLike, resolve_device, to_device

__all__ = [
    "PROX_SCALE",
    "TF_CAP",
    "ScoreSpec",
    "doc_counts",
    "head_order",
    "max_doc_run",
    "prox_weight",
    "score_docs",
    "score_docs_torch",
    "slot_upper_bound",
    "spec_for",
    "tf_sat",
]

# integer proximity scale: weight of distance d is PROX_SCALE // (1 + d),
# i.e. 12 / 8 / 6 / ... for d = 1, 2, 3, ...  (never below 1)
PROX_SCALE = 24

# tf saturation: per-slot occurrence counts beyond this add nothing.
# Kept small on purpose — it is the lever that lets the k-th settled
# score actually reach a cursor's upper bound (see module docstring).
TF_CAP = 4


def prox_weight(distance: int) -> int:
    """Integer proximity weight of a record distance (>= 1 always)."""
    return max(1, PROX_SCALE // (1 + max(1, int(distance))))


@dataclasses.dataclass(frozen=True)
class ScoreSpec:
    """Frozen per-query scoring recipe: one integer weight per lookup
    occurrence (slot), plus the shared tf saturation cap.  Attached to
    ``PlannedQuery`` by the planner when ``Query.rank`` is set."""

    weights: Tuple[int, ...]
    tf_cap: int = TF_CAP

    @property
    def max_score(self) -> int:
        """Largest score any document can reach under this spec."""
        return sum(w * self.tf_cap for w in self.weights)


def spec_for(
    route: str,
    n_slots: int,
    window: int,
    max_distance: int,
    phrase: bool = False,
) -> ScoreSpec:
    """Build the score spec for one planned query.

    Route strings are compared literally to avoid a circular import with
    the planner (which imports this module for the spec type).
    """
    if phrase or route in ("stopseq", "multi"):
        d = 1  # the records witness adjacent words
    elif route == "wv":
        d = int(max_distance)  # (w, v) records precomputed at max_distance
    else:
        d = int(window)
    return ScoreSpec(weights=(prox_weight(d),) * int(n_slots))


def tf_sat(counts: np.ndarray, cap: int = TF_CAP) -> np.ndarray:
    """Saturating term frequency: ``min(count, cap)``."""
    return np.minimum(counts, cap)


def slot_upper_bound(weight: int, max_doc_count: int, cap: int = TF_CAP) -> int:
    """Largest score contribution one slot can make to any document."""
    return int(weight) * min(int(max_doc_count), int(cap))


def doc_counts(docs: np.ndarray, posts: np.ndarray) -> np.ndarray:
    """Postings-per-doc of a doc-sorted (N, 2) array for each of ``docs``
    (ascending doc ids), via two binary searches — no join required."""
    if docs.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    col = posts[:, 0] if posts.shape[0] else np.zeros(0, dtype=np.int64)
    lo = np.searchsorted(col, docs, side="left")
    hi = np.searchsorted(col, docs, side="right")
    return (hi - lo).astype(np.int64)


def score_docs(slot_counts: Sequence[np.ndarray], spec: ScoreSpec) -> np.ndarray:
    """Numpy reference: sum of per-slot weighted saturated counts."""
    if not slot_counts:
        return np.zeros(0, dtype=np.int64)
    total = np.zeros(slot_counts[0].shape[0], dtype=np.int64)
    for w, c in zip(spec.weights, slot_counts):
        total += int(w) * tf_sat(np.asarray(c, dtype=np.int64), spec.tf_cap)
    return total


def score_docs_torch(
    slot_counts: Sequence[np.ndarray], spec: ScoreSpec,
    device: DeviceLike = None,
) -> np.ndarray:
    """Device form of :func:`score_docs` for the torch / cuda backends:
    the (S, N) count matrix is saturated, weighted and summed as int64
    torch ops on ``device``, so the result is bit-identical to the numpy
    reference."""
    if not slot_counts:
        return np.zeros(0, dtype=np.int64)
    if slot_counts[0].shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    dev = resolve_device(device)
    counts = to_device(np.stack([np.asarray(c) for c in slot_counts]), dev)
    weights = torch.tensor(spec.weights, dtype=torch.int64, device=dev)
    total = (weights[:, None] * counts.clamp(max=spec.tf_cap)).sum(dim=0)
    return total.cpu().numpy()


def head_order(
    docs: np.ndarray, scores: np.ndarray, k: int, ranked: bool
) -> np.ndarray:
    """Indices of the deterministic best-k head — THE shared tie rule.

    Ranked mode: score descending, doc id ascending within a tie (stable
    and total, so the head is unique and a k-prefix of the k+1 head).
    Doc-id mode: ascending doc ids (``docs`` comes from ``np.unique``).
    Both the streaming executor head and the exhaustive oracle head go
    through this one function, so they cannot disagree on tie order.
    """
    n = int(docs.shape[0])
    k = min(int(k), n)
    if not ranked:
        return np.arange(k)
    order = np.lexsort((docs, -np.asarray(scores, dtype=np.int64)))
    return order[:k]
