"""Synthetic three-class lexicon (paper section 6.2).

The paper divides all lemmas into stop words / frequently used / other,
backed by a Russian morphological analyser (~260k base forms).  We replace
the linguistics with a deterministic synthetic lexicon that has the same
*statistical* shape — the index strategies only ever see key statistics:

  * token word-ids are sampled Zipf(s) over a vocabulary of ``n_words``,
  * a word is *known* if the analyser dictionary contains it (we make the
    rare tail unknown: the word is its own lemma),
  * known words map to 1-2 lemmas (multi-lemma ambiguity),
  * lemmas are ranked by expected corpus frequency; the top ``n_stop``
    lemma ranks are stop lemmas, the next ``n_frequent`` are frequently
    used, the rest are "other" (6.2's three groups).

Everything is integer arrays so that posting extraction is vectorizable.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# word classes
STOP, FREQUENT, OTHER = 0, 1, 2


@dataclasses.dataclass
class Lexicon:
    n_words: int
    n_lemmas: int
    known_cutoff: int          # word ids >= cutoff are unknown words
    lemma1: np.ndarray         # (n_words,) primary lemma of each known word
    lemma2: np.ndarray         # (n_words,) secondary lemma or -1
    lemma_class: np.ndarray    # (n_lemmas,) STOP/FREQUENT/OTHER
    zipf_s: float
    word_probs: np.ndarray     # (n_words,) sampling distribution

    @property
    def n_stop(self) -> int:
        return int((self.lemma_class == STOP).sum())

    @property
    def n_frequent(self) -> int:
        return int((self.lemma_class == FREQUENT).sum())

    def is_known(self, word_ids: np.ndarray) -> np.ndarray:
        return word_ids < self.known_cutoff

    def lemmatize(self, word_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Primary and secondary lemma per token (-1: no secondary).

        Unknown words are their own lemma, offset into a separate id space
        (lemma id = n_lemmas + word_id) so ordinary-known and
        ordinary-unknown indexes have disjoint key universes.
        """
        known = self.is_known(word_ids)
        l1 = np.where(known, self.lemma1[word_ids], self.n_lemmas + word_ids)
        l2 = np.where(known, self.lemma2[word_ids], -1)
        return l1, l2

    def classes_of(self, lemma_ids: np.ndarray) -> np.ndarray:
        """Class per lemma id; unknown lemmas are always OTHER."""
        out = np.full(lemma_ids.shape, OTHER, dtype=np.int64)
        known = (lemma_ids >= 0) & (lemma_ids < self.n_lemmas)
        out[known] = self.lemma_class[lemma_ids[known]]
        return out

    def classify_words(self, word_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(primary lemma, class) per word in one vectorized pass — the
        query planner's batch classification (no per-word round trips)."""
        word_ids = np.asarray(word_ids, dtype=np.int64)
        l1, _ = self.lemmatize(word_ids)
        return l1, self.classes_of(l1)


def make_lexicon(
    n_words: int = 60_000,
    n_lemmas: int = 26_000,
    n_stop: int = 70,
    n_frequent: int = 1_000,
    unknown_fraction: float = 0.15,
    zipf_s: float = 1.07,
    seed: int = 1234,
) -> Lexicon:
    """Build the synthetic lexicon.  Defaults are the paper's shape scaled
    ~10x down (260k lemmas → 26k) to keep CI-scale corpora fast; the
    benchmark exposes the full-size variant behind ``--scale``."""
    rng = np.random.RandomState(seed)
    known_cutoff = int(n_words * (1.0 - unknown_fraction))

    # Zipf over words (rank = word id)
    ranks = np.arange(1, n_words + 1, dtype=np.float64)
    probs = ranks ** (-zipf_s)
    probs /= probs.sum()

    # known word -> primary lemma: several inflected forms share a lemma,
    # with frequent words having more forms (rich morphology of frequent
    # verbs/nouns).  Map by rank so frequency ordering is preserved.
    forms = 1 + (rng.poisson(1.2, size=known_cutoff))
    lemma_of_known = np.repeat(
        np.arange(len(forms)), forms
    )[:known_cutoff]
    lemma_of_known = np.minimum(lemma_of_known, n_lemmas - 1)
    lemma1 = np.full(n_words, -1, dtype=np.int64)
    lemma1[:known_cutoff] = lemma_of_known

    # multi-lemma ambiguity: ~12% of known words have a second lemma
    ambiguous = rng.rand(n_words) < 0.12
    ambiguous[known_cutoff:] = False
    lemma2 = np.full(n_words, -1, dtype=np.int64)
    lemma2[ambiguous] = rng.randint(0, n_lemmas, size=int(ambiguous.sum()))

    # expected lemma frequencies -> class thresholds
    lemma_freq = np.zeros(n_lemmas, dtype=np.float64)
    np.add.at(lemma_freq, lemma1[:known_cutoff], probs[:known_cutoff])
    sec = lemma2 >= 0
    np.add.at(lemma_freq, lemma2[sec], 0.3 * probs[sec])
    order = np.argsort(-lemma_freq)
    lemma_class = np.full(n_lemmas, OTHER, dtype=np.int64)
    lemma_class[order[:n_stop]] = STOP
    lemma_class[order[n_stop : n_stop + n_frequent]] = FREQUENT

    # stop lemmas are function words: keep them morphologically unambiguous
    # (no word has a stop lemma as a secondary reading, and stop-primary
    # words have no secondary lemma) — this keeps the stop-sequence index
    # and the ordinary index exactly consistent.
    sec = lemma2 >= 0
    bad = np.zeros(n_words, dtype=bool)
    bad[sec] = lemma_class[lemma2[sec]] == STOP
    primary_stop = np.zeros(n_words, dtype=bool)
    known_mask = lemma1 >= 0
    primary_stop[known_mask] = lemma_class[lemma1[known_mask]] == STOP
    lemma2[bad | primary_stop] = -1

    return Lexicon(
        n_words=n_words,
        n_lemmas=n_lemmas,
        known_cutoff=known_cutoff,
        lemma1=lemma1,
        lemma2=lemma2,
        lemma_class=lemma_class,
        zipf_s=zipf_s,
        word_probs=probs,
    )
