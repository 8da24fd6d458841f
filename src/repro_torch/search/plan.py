"""Typed query planning over the paper family's four lookup routes.

``plan_batch`` turns a batch of word-id queries into a
:class:`QueryPlan`: every query is classified (vectorized — ONE
lemmatize/classes pass over all words of the batch, replacing the old
per-word round trips) and routed down one of four paths:

  * ``ROUTE_STOPSEQ``  — all words are stop lemmas: the whole
    co-occurrence is precomputed under one stop-sequence key,
  * ``ROUTE_MULTI``    — a phrase query whose words are covered by one
    (or a small overlapping cover of) multi-component k-word keys
    (arXiv:1812.07640); the executor reconstructs the window matches
    from the NSW-style (doc, start-position) records alone,
  * ``ROUTE_WV``       — a FREQUENT lemma pairs with the other word
    through one extended (w, v) key,
  * ``ROUTE_ORDINARY`` — ordinary-index lookups + position join
    (window join, or staged phrase joins for phrase queries the
    multi index cannot cover).

The plan also carries the batch's key lookups grouped by
``(index, dictionary group)`` so the executor can fetch group-mates
together (one dictionary partition visit serves every query that needs
it) and deduplicate identical keys across the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.lexicon import FREQUENT, Lexicon, STOP
from repro_torch.data.corpus import PAIR_SHIFT, SEQ2_FLAG, SEQ_SHIFT
from repro_torch.search.scoring import ScoreSpec, spec_for

ROUTE_STOPSEQ = "stopseq"
ROUTE_MULTI = "multi"
ROUTE_WV = "wv"
ROUTE_ORDINARY = "ordinary"

ROUTES = (ROUTE_STOPSEQ, ROUTE_MULTI, ROUTE_WV, ROUTE_ORDINARY)

# proximity queries stay at the paper's 2-3 words; phrase queries may be
# longer — the multi route covers them with overlapping k-word keys
MAX_PHRASE_WORDS = 8


@dataclasses.dataclass(frozen=True)
class MultiKeySpec:
    """Planner view of the multi-component key index: tuple width ``k``,
    the key packing, and the phrase cover — all owned by the index itself
    (:meth:`~repro_torch.core.multi_key.MultiKeyIndex.cover_keys`)."""

    k: int
    pack: Callable[[Sequence[int]], int]
    name: str = "multi"
    cover: Optional[Callable[[Sequence[int]], List[int]]] = None

    def cover_keys(self, lemmas: Sequence[int]) -> List[int]:
        if self.cover is not None:
            if len(lemmas) < self.k:
                # the index's cover validates too; fail here so a bad
                # call can never surface later as a zero-lookup plan
                raise ValueError(
                    f"phrase of {len(lemmas)} lemmas cannot be covered "
                    f"by {self.k}-word keys"
                )
            return list(self.cover(lemmas))
        # fallback for specs built without a cover: the shared derivation
        from repro_torch.core.multi_key import phrase_cover_keys

        return phrase_cover_keys(self.pack, self.k, lemmas)


@dataclasses.dataclass(frozen=True)
class Query:
    """One query: word ids + an optional per-query window.

    ``phrase=True`` asks for ordered-contiguous semantics (word j at
    start+j) — the stop-sequence index's semantics extended to arbitrary
    words; ``window`` is ignored for phrase queries.  Proximity queries
    are 2-3 words; phrase queries may be up to ``MAX_PHRASE_WORDS``.

    ``top_k=N`` asks for the *best-k result mode*: only the N best
    matching documents with their witness postings and per-doc scores.
    The executor serves it through the streaming stage: per-key posting
    records are consumed in sorted (doc, start) order via lazy cursors
    and fetching stops once the top-k set is provably settled.  What
    "best" means is chosen by ``rank``:

      * ``rank=None`` (default) — doc-id order: the N lowest matching doc
        ids (the collection is indexed in arrival order, so the lowest
        ids are the canonical head); scores are match-occurrence counts.
        Element-wise identical to the exhaustive path's first N docs.
      * ``rank="prox"`` — score order: the N best documents under the
        proximity × saturating-tf score of ``repro_torch.search.scoring``,
        ties broken by ascending doc id, pruned WAND-style via per-key
        upper bounds.  Element-wise identical (docs, scores, tie order)
        to exhaustively scoring every match and stable-sorting.

    ``rank`` requires ``top_k`` — a ranked exhaustive result would just
    be a permutation the caller can apply themselves.
    """

    words: Tuple[int, ...]
    window: Optional[int] = None
    phrase: bool = False
    top_k: Optional[int] = None
    rank: Optional[str] = None

    def __post_init__(self):
        if self.phrase:
            if not 2 <= len(self.words) <= MAX_PHRASE_WORDS:
                raise ValueError(
                    f"phrase queries are 2-{MAX_PHRASE_WORDS} words, "
                    f"got {len(self.words)}"
                )
        elif not 2 <= len(self.words) <= 3:
            raise ValueError(f"queries are 2-3 words, got {len(self.words)}")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.rank is not None:
            if self.rank != "prox":
                raise ValueError(
                    f"rank must be None or 'prox', got {self.rank!r}"
                )
            if self.top_k is None:
                raise ValueError("rank= requires top_k= (best-k mode)")


@dataclasses.dataclass(frozen=True)
class KeyLookup:
    """One (index, key) posting fetch; ``group`` is the dictionary group."""

    index: str
    key: int
    group: int


@dataclasses.dataclass
class PlannedQuery:
    query: Query
    route: str
    lookups: List[KeyLookup]
    window: int
    # best-k result mode: set when the query asked for top_k — the
    # executor routes these lookups down the streaming (lazy cursor)
    # stage instead of the batch scatter-fetch waves
    top_k: Optional[int] = None
    # score-ordered best-k: rank mode + the frozen per-slot score recipe
    # (set iff the query asked for rank=; see repro_torch.search.scoring)
    rank: Optional[str] = None
    score_spec: Optional[ScoreSpec] = None


@dataclasses.dataclass
class QueryPlan:
    """Executable plan for a batch of queries."""

    queries: List[PlannedQuery]
    # all *unique* lookups of the batch, grouped by (index, dict group)
    grouped: Dict[Tuple[str, int], List[KeyLookup]]

    @property
    def n_unique_lookups(self) -> int:
        return sum(len(v) for v in self.grouped.values())

    def route_census(self) -> Dict[str, int]:
        census = {r: 0 for r in ROUTES}
        for pq in self.queries:
            census[pq.route] += 1
        return census


@dataclasses.dataclass
class QueryResult:
    docs: np.ndarray                 # matched doc ids (unique, sorted)
    witnesses: np.ndarray            # (N,2) witness postings
    lookups: List[Tuple[str, int]]   # (index, key) lookups performed
    postings_scanned: int            # total postings decoded
    route: Optional[str] = None      # which planner route produced this
    # per-doc score, aligned with ``docs``.  Exhaustive and doc-id top-k
    # results carry match-occurrence counts; ranked (rank="prox") results
    # carry the proximity × saturating-tf scores of the returned head,
    # with ``docs`` in (score desc, doc id asc) order.  Mandatory on
    # every executor path — a missing-scores side never compares equal
    # to a scored one.
    scores: Optional[np.ndarray] = None

    def __eq__(self, other) -> bool:  # element-wise identity for tests
        return (
            isinstance(other, QueryResult)
            and np.array_equal(self.docs, other.docs)
            and np.array_equal(self.witnesses, other.witnesses)
            and self.lookups == other.lookups
            and self.postings_scanned == other.postings_scanned
            # scores are part of the identity: both sides must agree on
            # HAVING them, then on every element.  (The old "either side
            # may omit" escape hatch let an executor that silently
            # dropped scores pass every oracle.)
            and (self.scores is None) == (other.scores is None)
            and (
                self.scores is None
                or np.array_equal(self.scores, other.scores)
            )
        )


def classify_batch(
    lexicon: Lexicon, queries: Sequence[Query]
) -> Tuple[np.ndarray, np.ndarray, List[slice]]:
    """One vectorized lemmatize+classify pass over all words of the batch.

    Returns (lemmas, classes) flat over the concatenated query words plus
    the per-query slice into them.
    """
    spans: List[slice] = []
    flat: List[int] = []
    for q in queries:
        spans.append(slice(len(flat), len(flat) + len(q.words)))
        flat.extend(q.words)
    words = np.asarray(flat, dtype=np.int64)
    if words.size == 0:
        return words, words, spans
    lemmas, classes = lexicon.classify_words(words)
    return lemmas, classes, spans


def _planned(
    query: Query,
    route: str,
    lookups: List[KeyLookup],
    window: int,
    max_distance: Optional[int],
) -> PlannedQuery:
    """Construct the planned query, attaching the frozen score spec when
    the query asked for ranked best-k (one weight per lookup slot)."""
    spec = None
    if query.rank is not None:
        spec = spec_for(
            route,
            len(lookups),
            window,
            max_distance if max_distance is not None else window,
            phrase=query.phrase,
        )
    return PlannedQuery(
        query, route, lookups, window,
        top_k=query.top_k, rank=query.rank, score_spec=spec,
    )


def plan_query(
    lemmas: np.ndarray,
    classes: np.ndarray,
    query: Query,
    lexicon: Lexicon,
    group_of,
    window: int,
    multi: Optional[MultiKeySpec] = None,
    max_distance: Optional[int] = None,
) -> PlannedQuery:
    """Route one classified query (mirrors the paper's decision order,
    with the multi-component route slotted between stopseq and (w, v))."""
    lem = [int(x) for x in lemmas]
    cls = [int(x) for x in classes]

    if all(c == STOP for c in cls) and len(lem) <= 3:
        if len(lem) == 2:
            key = int(SEQ2_FLAG | (lem[0] << SEQ_SHIFT) | lem[1])
        else:
            key = int(
                (lem[0] << (2 * SEQ_SHIFT)) | (lem[1] << SEQ_SHIFT) | lem[2]
            )
        lk = KeyLookup("stopseq", key, group_of("stopseq", key))
        return _planned(query, ROUTE_STOPSEQ, [lk], window, max_distance)

    if query.phrase and multi is not None and len(lem) >= multi.k:
        # cover the phrase with L-k+1 overlapping k-word keys (the cover
        # is owned by the index: key j's records sit at start+j); the
        # executor intersects them at their fixed start-position offsets
        lookups = [
            KeyLookup(multi.name, key, group_of(multi.name, key))
            for key in multi.cover_keys(lem)
        ]
        return _planned(query, ROUTE_MULTI, lookups, window, max_distance)

    freq_i = next((i for i, c in enumerate(cls) if c == FREQUENT), None)
    if (
        freq_i is not None
        and len(query.words) == 2
        and not query.phrase
        # (w, v) records are precomputed at max_distance and carry only
        # w's position, so a NARROWER window cannot be applied to them —
        # those queries take the ordinary route, which honors the window
        and (max_distance is None or window >= max_distance)
    ):
        # (w, v) records carry only w's position — enough for window
        # proximity, not for reconstructing a phrase match
        w = lem[freq_i]
        v = lem[1 - freq_i]
        key = int((w << PAIR_SHIFT) | v)
        name = "wv_kk" if v < lexicon.n_lemmas else "wv_ku"
        lk = KeyLookup(name, key, group_of(name, key))
        return _planned(query, ROUTE_WV, [lk], window, max_distance)

    lookups = []
    for lemma in lem:
        name = "unknown" if lemma >= lexicon.n_lemmas else "known"
        lookups.append(KeyLookup(name, lemma, group_of(name, lemma)))
    return _planned(query, ROUTE_ORDINARY, lookups, window, max_distance)


def plan_batch(
    queries: Sequence[Query],
    lexicon: Lexicon,
    group_of,
    default_window: int,
    multi: Optional[MultiKeySpec] = None,
    max_distance: Optional[int] = None,
) -> QueryPlan:
    """Plan a batch: classify all words at once, route each query, group
    the batch's unique lookups by (index, dictionary group)."""
    lemmas, classes, spans = classify_batch(lexicon, queries)
    planned = [
        plan_query(
            lemmas[span], classes[span], q, lexicon, group_of,
            q.window if q.window is not None else default_window,
            multi=multi, max_distance=max_distance,
        )
        for q, span in zip(queries, spans)
    ]
    grouped: Dict[Tuple[str, int], List[KeyLookup]] = {}
    seen = set()
    for pq in planned:
        for lk in pq.lookups:
            ident = (lk.index, lk.key)
            if ident in seen:
                continue
            seen.add(ident)
            grouped.setdefault((lk.index, lk.group), []).append(lk)
    return QueryPlan(planned, grouped)
