"""Multi-component (k-word) key index (arXiv:1812.07640 family).

The paper's additional indexes stop at two-component ``(w, v)`` keys;
the follow-up line of work shows that *multi-component* keys — one key
per tuple of k consecutive words — are what make multi-word proximity
and phrase search fast at scale.  :class:`MultiKeyIndex` indexes every
sliding ``(f1, …, fk)`` lemma tuple of the token stream (k configurable,
default 3) over the same easily updatable substrate as the single-word
case: keys live in a :class:`~repro_torch.core.dictionary.Dictionary`, posting
data moves through :class:`~repro_torch.core.stream.StreamManager` clusters,
and the storage tier of each key is chosen by its data size exactly like
the paper prescribes (EM for tiny lists, PART/S/CH for larger ones) —
all inherited from :class:`~repro_torch.core.inverted_index.InvertedIndex`
via the shared :class:`~repro_torch.core.strategies.StrategyConfig`.

Records are NSW-style ("next word") ``(doc, start_position)`` rows: a
posting at position ``p`` certifies the key's k lemmas occur at
``p, p+1, …, p+k-1`` of the document, so the executor can reconstruct
every component position of a window match from the start position
alone.  Ambiguous tokens contribute every lemma-reading combination of
the window (the same lemmatized-search convention as the extended
``(w, v)`` extraction), deduplicated per key.

Key packing is explicit and data driven: each component takes
``component_bits`` bits (enough for the lexicon's combined
known-lemma + unknown-word id universe) and the k components fold into
one int64, mirroring the stop-sequence key packing.  The packed integer
lives in its own index namespace ("multi"), and the posting cache
namespaces entries by index name, so a packed 2-word multi key can
never collide with a numerically equal extended ``(w, v)`` key.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.inverted_index import InvertedIndex
from repro_torch.core.lexicon import Lexicon
from repro_torch.data.corpus import group_by_key

# packed keys must stay positive int64
_MAX_PACKED_BITS = 62


def lemma_bits(lexicon: Lexicon) -> int:
    """Bits one key component needs: the lemma id universe is known
    lemmas plus offset unknown-word ids (``n_lemmas + word_id``)."""
    return int(lexicon.n_lemmas + lexicon.n_words - 1).bit_length()


def pack_components(components: Sequence[int], bits: int) -> int:
    """Fold k lemma ids into one int64 key (big end = first word)."""
    key = 0
    limit = 1 << bits
    for c in components:
        c = int(c)
        if not 0 <= c < limit:
            raise ValueError(f"component {c} out of range for {bits} bits")
        key = (key << bits) | c
    return key


def unpack_components(key: int, k: int, bits: int) -> Tuple[int, ...]:
    mask = (1 << bits) - 1
    out = [(key >> (bits * (k - 1 - j))) & mask for j in range(k)]
    return tuple(out)


def phrase_cover_keys(pack, k: int, lemmas: Sequence[int]) -> List[int]:
    """Overlapping k-word key cover of a phrase's lemma sequence — THE
    single derivation shared by :meth:`MultiKeyIndex.cover_keys` and the
    planner's :class:`~repro_torch.search.plan.MultiKeySpec` fallback, so the
    two can never drift.  Key ``j`` is the k-gram at word offset ``j``."""
    if len(lemmas) < k:
        raise ValueError(
            f"phrase of {len(lemmas)} lemmas cannot be covered by "
            f"{k}-word keys"
        )
    return [int(pack(lemmas[off : off + k]))
            for off in range(len(lemmas) - k + 1)]


def extract_multi_postings(
    lexicon: Lexicon,
    tokens: np.ndarray,
    offsets: np.ndarray,
    doc0: int,
    k: int,
    bits: int,
) -> Dict[int, np.ndarray]:
    """Sliding k-gram posting map for one collection part (vectorized).

    Every window of k consecutive tokens inside one document yields one
    posting per lemma-reading combination: slot j may read the token's
    primary or (when present) secondary lemma, so a phrase matches no
    matter which reading the query words lemmatize to.  Duplicate
    ``(key, doc, pos)`` rows (a token whose two readings coincide) are
    dropped so the multi route's witnesses are exact window matches.
    """
    if k * bits > _MAX_PACKED_BITS:
        raise ValueError(f"k={k} at {bits} bits/component overflows int64 keys")
    T = int(tokens.shape[0])
    if T < k:
        return {}
    n_docs = offsets.shape[0] - 1
    lens = np.diff(offsets)
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64) + doc0, lens)
    pos_of = np.arange(T, dtype=np.int64) - np.repeat(offsets[:-1], lens)
    l1, l2 = lexicon.lemmatize(tokens)

    starts = np.arange(T - k + 1, dtype=np.int64)
    in_doc = doc_of[starts] == doc_of[starts + k - 1]

    keys_acc, docs_acc, poss_acc = [], [], []
    for combo in range(1 << k):
        mask = in_doc.copy()
        key = np.zeros(T - k + 1, dtype=np.int64)
        for j in range(k):
            use_secondary = (combo >> j) & 1
            lem = l2[starts + j] if use_secondary else l1[starts + j]
            if use_secondary:
                mask &= lem >= 0
            key = (key << bits) | np.where(lem >= 0, lem, 0)
        if not mask.any():
            continue
        keys_acc.append(key[mask])
        docs_acc.append(doc_of[starts[mask]])
        poss_acc.append(pos_of[starts[mask]])
    if not keys_acc:
        return {}
    rows = np.stack(
        [np.concatenate(keys_acc), np.concatenate(docs_acc), np.concatenate(poss_acc)],
        axis=1,
    )
    rows = np.unique(rows, axis=0)
    return group_by_key(rows[:, 0], rows[:, 1], rows[:, 2])


class MultiKeyIndex(InvertedIndex):
    """Easily updatable index over packed k-word lemma-tuple keys.

    A thin specialisation of :class:`InvertedIndex`: key extraction and
    packing are multi-component aware, while the update protocol, the
    storage-tier choice per key (EM/PART/S/CH by data size) and the I/O
    accounting are exactly the single-word machinery.
    """

    def __init__(self, cfg, device, k: int = 3, component_bits: int = 17, **kw):
        if k < 2:
            raise ValueError(f"multi-component keys need k >= 2, got {k}")
        if k * component_bits > _MAX_PACKED_BITS:
            raise ValueError(
                f"k={k} components of {component_bits} bits do not fit an "
                f"int64 key ({k * component_bits} > {_MAX_PACKED_BITS})"
            )
        super().__init__(cfg, device, **kw)
        self.k = int(k)
        self.component_bits = int(component_bits)

    @classmethod
    def for_lexicon(cls, cfg, device, lexicon: Lexicon, k: int = 3, **kw):
        return cls(cfg, device, k=k, component_bits=lemma_bits(lexicon), **kw)

    # ---------------------------------------------------------------- keys --
    def pack(self, lemmas: Sequence[int]) -> int:
        if len(lemmas) != self.k:
            raise ValueError(f"expected {self.k} components, got {len(lemmas)}")
        return pack_components(lemmas, self.component_bits)

    def unpack(self, key: int) -> Tuple[int, ...]:
        return unpack_components(key, self.k, self.component_bits)

    def cover_keys(self, lemmas: Sequence[int]) -> List[int]:
        """Overlapping k-word key cover of a phrase's lemma sequence.

        Key ``j`` is the k-gram at word offset ``j``; its NSW-style
        records sit at ``start + j`` of every phrase match, which is how
        the executor (batch phrase chain and streaming top-k alike)
        reconstructs the match from start positions alone.  The records
        of every cover key are (doc, start)-sorted — the invariant the
        lazy cursor's settled-doc bound relies on.
        """
        return phrase_cover_keys(self.pack, self.k, lemmas)

    # ---------------------------------------------------------- extraction --
    def extract_part(
        self,
        lexicon: Lexicon,
        tokens: np.ndarray,
        offsets: np.ndarray,
        doc0: int,
    ) -> Dict[int, np.ndarray]:
        return extract_multi_postings(
            lexicon, tokens, offsets, doc0, self.k, self.component_bits
        )

    def add_text_part(
        self,
        lexicon: Lexicon,
        tokens: np.ndarray,
        offsets: np.ndarray,
        doc0: int,
    ) -> None:
        """Extract and index one collection part in a single call."""
        self.add_part(self.extract_part(lexicon, tokens, offsets, doc0))
