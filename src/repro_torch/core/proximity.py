"""Proximity full-text search over the additional indexes (paper section 6).

Query model: a list of word ids; the answer is the set of documents where
the queried words occur near each other (within ``window`` positions),
with the witness positions.

This module is the backward-compatible single-query surface.  The actual
query processor is the Reader → Planner → Executor stack in
:mod:`repro_torch.search` (see DESIGN_SEARCH.md): :class:`ProximityEngine` is a
thin wrapper that plans and executes each query through a
:class:`~repro_torch.search.service.SearchService`, and the join functions
(``numpy_window_join``, ``torch_window_join``, ...) are re-exported from
:mod:`repro_torch.search.join` for existing imports.

The planner mirrors the paper's three word classes:

  * two stop lemmas            → one ``stopseq`` lookup (the whole
    co-occurrence is precomputed in the index key),
  * FREQUENT lemma + any other → one extended ``(w, v)`` lookup,
  * otherwise                  → ordinary-index lookups + position join.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np

from repro_torch.core.lexicon import STOP
from repro_torch.core.text_index import IndexSetLike
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.search.join import (
    JOIN_BACKENDS,
    cuda_window_join,
    numpy_phrase_join,
    numpy_window_join,
    torch_window_join,
)
from repro_torch.search.plan import Query, QueryResult
from repro_torch.search.service import SearchService

__all__ = [
    "ProximityEngine",
    "QueryResult",
    "cuda_window_join",
    "numpy_phrase_join",
    "numpy_window_join",
    "torch_window_join",
]


class ProximityEngine:
    """Single-query facade over :class:`~repro_torch.search.SearchService`.

    ``join`` keeps the historical signature: a callable
    ``join(a, b, window)`` or one of the named backends; it is forwarded
    to the service as the join backend for the ordinary route.  The
    default is the service's, ``"cuda"``; ``device`` is where the device
    backends run (``None`` means the CUDA card, as for the service).
    """

    def __init__(self, index_set: IndexSetLike, window: int = 3,
                 join="cuda", cache_bytes: int = 8 << 20,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.idx = index_set
        self.lex = index_set.lexicon
        self.window = min(window, index_set.cfg.max_distance)
        self.join = join
        backend = {id(f): name for name, f in JOIN_BACKENDS.items()}.get(
            id(join), join
        )
        self._backend = backend
        self.service = SearchService(
            index_set, window=window, backend=backend, cache_bytes=cache_bytes,
            device=self.device,
        )

    def search(self, words: List[int]) -> QueryResult:
        """Proximity search via the additional indexes (the paper's path)."""
        assert 2 <= len(words) <= 3, "benchmark queries are 2-3 words"
        return self.service.search(words)

    def search_ordinary(self, words: List[int]) -> QueryResult:
        """Baseline: the same query through the ordinary-all index only.
        All-stop queries use phrase semantics (to match the stop-sequence
        index); everything else uses the proximity window."""
        assert "ordinary_all" in self.idx.indexes, (
            "build TextIndexSet with build_ordinary_all=True for the baseline"
        )
        lemmas, classes = self.lex.classify_words(
            np.asarray(words, dtype=np.int64)
        )
        phrase = all(int(c) == STOP for c in classes)
        if callable(self._backend):
            join = self._backend
        elif self._backend == "numpy":
            join = numpy_window_join
        else:
            join = functools.partial(JOIN_BACKENDS[self._backend],
                                     device=self.device)
        lists, lookups, scanned = [], [], 0
        for lemma in lemmas:
            lemma = int(lemma)
            posts = self.idx.lookup("ordinary_all", lemma)
            lists.append(posts)
            lookups.append(("ordinary_all", lemma))
            scanned += posts.shape[0]
        acc = lists[0]
        for k, nxt in enumerate(lists[1:], start=1):
            if phrase:
                acc = numpy_phrase_join(acc, nxt, k)
            else:
                acc = join(acc, nxt, self.window)
        # scores (match-occurrence counts) attach here too: QueryResult
        # equality requires both sides to carry them, so a facade result
        # must be comparable against the batched executor's
        docs, counts = np.unique(acc[:, 0], return_counts=True)
        return QueryResult(docs, acc, lookups, scanned, scores=counts)
