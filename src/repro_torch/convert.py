"""Carry data across from plain arrays.

The collection plays the part that weights play in a model port: the
tests pull a reference world apart into numpy arrays and rebuild it here,
so both packages index byte-identical data.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np

from repro_torch.core.lexicon import Lexicon
from repro_torch.data.world import World

_INT_FIELDS = ("n_words", "n_lemmas", "known_cutoff")
_ARRAY_FIELDS = ("lemma1", "lemma2", "lemma_class", "word_probs")


def world_from_arrays(
    lexicon_arrays: Mapping[str, object],
    parts: Sequence[Tuple[np.ndarray, np.ndarray]],
    doc_starts: Sequence[int],
) -> World:
    """The port's :class:`World` from a lexicon's fields (``n_words``,
    ``n_lemmas``, ``known_cutoff``, ``lemma1``, ``lemma2``,
    ``lemma_class``, ``zipf_s``, ``word_probs``) and per-part
    ``(tokens, offsets)`` arrays.  Arrays are copied."""
    missing = set(_INT_FIELDS + _ARRAY_FIELDS + ("zipf_s",)) - set(lexicon_arrays)
    if missing:
        raise ValueError(f"lexicon arrays lack {sorted(missing)}")
    lex = Lexicon(
        **{f: int(lexicon_arrays[f]) for f in _INT_FIELDS},
        **{f: np.array(lexicon_arrays[f]) for f in _ARRAY_FIELDS},
        zipf_s=float(lexicon_arrays["zipf_s"]),
    )
    if len(parts) != len(doc_starts):
        raise ValueError(
            f"{len(parts)} parts but {len(doc_starts)} doc starts"
        )
    return World(
        lexicon=lex,
        parts=[(np.array(t, dtype=np.int64), np.array(o, dtype=np.int64))
               for t, o in parts],
        doc_starts=[int(d) for d in doc_starts],
    )
