"""Synthetic corpus + vectorized posting extraction (paper sections 1, 6).

The paper indexes a 71.5 GB plain-text collection split into parts of
10-20 GB (section 2.2: "the size of each part is dependent on the amount
of available RAM").  We generate deterministic Zipf documents and extract
postings for the paper's five index types:

  1. ordinary index over known lemmas   (key: lemma id)
  2. ordinary index over unknown words  (key: n_lemmas + word id)
  3. extended (w, v), w and v known     (key: w * 2^32 + v; w is FREQUENT)
  4. extended (w, v), v unknown         (same packing)
  5. stop-lemma sequences               (key: l0*2^42 + l1*2^21 + l2 + FLAG)

Packing keys into int64 keeps extraction fully vectorized; the inverted
index treats keys as opaque hashables.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.lexicon import FREQUENT, Lexicon, OTHER, STOP

PAIR_SHIFT = 32          # (w, v) key packing
SEQ_SHIFT = 21           # stop-sequence key packing: 3 x 21 bits
SEQ2_FLAG = 1 << 62      # disambiguate 2-sequences from 3-sequences


def generate_part(
    lexicon: Lexicon,
    n_docs: int,
    avg_doc_len: int,
    doc0: int,
    seed: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """One collection part: (tokens, doc_offsets).  Doc ids are
    ``doc0 .. doc0+n_docs-1``; offsets have length n_docs+1."""
    rng = np.random.RandomState(seed)
    lens = np.maximum(8, rng.poisson(avg_doc_len, size=n_docs))
    total = int(lens.sum())
    tokens = rng.choice(lexicon.n_words, size=total, p=lexicon.word_probs)
    offsets = np.concatenate(([0], np.cumsum(lens)))
    return tokens.astype(np.int64), offsets.astype(np.int64)


def group_by_key(
    keys: np.ndarray, docs: np.ndarray, poss: np.ndarray
) -> Dict[int, np.ndarray]:
    """Group (key, doc, pos) rows into {key: (N,2) sorted postings}."""
    if keys.size == 0:
        return {}
    order = np.lexsort((poss, docs, keys))
    k = keys[order]
    dp = np.stack([docs[order], poss[order]], axis=1)
    uniq, starts = np.unique(k, return_index=True)
    chunks = np.split(dp, starts[1:])
    return {int(u): c for u, c in zip(uniq.tolist(), chunks)}


def extract_postings(
    lexicon: Lexicon,
    tokens: np.ndarray,
    offsets: np.ndarray,
    doc0: int,
    max_distance: int = 3,
) -> Dict[str, Dict[int, np.ndarray]]:
    """Extract the five posting maps for one part (vectorized)."""
    n_docs = offsets.shape[0] - 1
    lens = np.diff(offsets)
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64) + doc0, lens)
    pos_of = np.arange(tokens.shape[0], dtype=np.int64) - np.repeat(
        offsets[:-1], lens
    )
    l1, l2 = lexicon.lemmatize(tokens)
    cls1 = lexicon.classes_of(l1)
    known = lexicon.is_known(tokens)

    out: Dict[str, Dict[int, np.ndarray]] = {}

    # 1) ordinary known-lemma index: ALL known lemmas (paper 6.3: "keys are
    #    lemmas" — stop and frequent lemmas included; the additional indexes
    #    are the fast paths, not a replacement).  Secondary lemmas included.
    m = known
    keys = [l1[m]]
    docs = [doc_of[m]]
    poss = [pos_of[m]]
    m2 = l2 >= 0
    keys.append(l2[m2])
    docs.append(doc_of[m2])
    poss.append(pos_of[m2])
    out["known"] = group_by_key(
        np.concatenate(keys), np.concatenate(docs), np.concatenate(poss)
    )

    # 2) ordinary unknown-word index
    mu = ~known
    out["unknown"] = group_by_key(l1[mu], doc_of[mu], pos_of[mu])

    # 3+4) extended (w, v): w is a FREQUENT lemma reading of a token, v is a
    #    lemma reading of any token within max_distance.  Both lemma
    #    readings of ambiguous tokens are indexed (lemmatized search).
    cls2 = lexicon.classes_of(l2)
    c1 = np.nonzero(known & (cls1 == FREQUENT))[0]
    c2 = np.nonzero(known & (l2 >= 0) & (cls2 == FREQUENT))[0]
    centers = np.concatenate([c1, c2])
    w_lem = np.concatenate([l1[c1], l2[c2]])
    wk_keys: List[np.ndarray] = []
    wk_docs: List[np.ndarray] = []
    wk_poss: List[np.ndarray] = []
    wu_keys: List[np.ndarray] = []
    wu_docs: List[np.ndarray] = []
    wu_poss: List[np.ndarray] = []
    T = tokens.shape[0]
    for d in range(-max_distance, max_distance + 1):
        if d == 0 or centers.size == 0:
            continue
        j = centers + d
        ok = (j >= 0) & (j < T)
        i, jj, w0 = centers[ok], j[ok], w_lem[ok]
        same_doc = doc_of[i] == doc_of[jj]
        i, jj, w0 = i[same_doc], jj[same_doc], w0[same_doc]
        for vslot in (1, 2):
            if vslot == 1:
                vi, ji, wi = l1[jj], jj, w0
                ii = i
            else:
                has2 = l2[jj] >= 0
                vi, ji, wi = l2[jj][has2], jj[has2], w0[has2]
                ii = i[has2]
            if vi.size == 0:
                continue
            key = (wi << PAIR_SHIFT) | vi
            vk = known[ji]
            wk_keys.append(key[vk]); wk_docs.append(doc_of[ii][vk]); wk_poss.append(pos_of[ii][vk])
            vu = ~vk
            wu_keys.append(key[vu]); wu_docs.append(doc_of[ii][vu]); wu_poss.append(pos_of[ii][vu])
    out["wv_kk"] = group_by_key(
        np.concatenate(wk_keys) if wk_keys else np.zeros(0, np.int64),
        np.concatenate(wk_docs) if wk_docs else np.zeros(0, np.int64),
        np.concatenate(wk_poss) if wk_poss else np.zeros(0, np.int64),
    )
    out["wv_ku"] = group_by_key(
        np.concatenate(wu_keys) if wu_keys else np.zeros(0, np.int64),
        np.concatenate(wu_docs) if wu_docs else np.zeros(0, np.int64),
        np.concatenate(wu_poss) if wu_poss else np.zeros(0, np.int64),
    )

    # 5) stop-lemma sequences of length 2 and 3 (paper 6.3 index kind 3)
    stop = known & (cls1 == STOP)
    nxt_same = np.zeros(T, dtype=bool)
    if T > 1:
        nxt_same[:-1] = (doc_of[1:] == doc_of[:-1])
    p2 = np.nonzero(stop[:-1] & stop[1:] & nxt_same[:-1])[0] if T > 1 else np.zeros(0, np.int64)
    k2 = (SEQ2_FLAG | (l1[p2] << SEQ_SHIFT) | l1[p2 + 1]) if p2.size else np.zeros(0, np.int64)
    if T > 2:
        p3 = p2[(p2 + 2 < T)]
        p3 = p3[stop[p3 + 2] & nxt_same[p3 + 1]]
    else:
        p3 = np.zeros(0, np.int64)
    k3 = (
        (l1[p3] << (2 * SEQ_SHIFT)) | (l1[p3 + 1] << SEQ_SHIFT) | l1[p3 + 2]
    ) if p3.size else np.zeros(0, np.int64)
    out["stopseq"] = group_by_key(
        np.concatenate([k2, k3]),
        np.concatenate([doc_of[p2], doc_of[p3]]),
        np.concatenate([pos_of[p2], pos_of[p3]]),
    )

    # 6) ordinary-all (baseline for the search-speed experiment; NOT part of
    #    the paper's five measured indexes): every lemma reading of every
    #    token, so the baseline sees exactly what the additional indexes see.
    m2a = l2 >= 0
    out["ordinary_all"] = group_by_key(
        np.concatenate([l1, l2[m2a]]),
        np.concatenate([doc_of, doc_of[m2a]]),
        np.concatenate([pos_of, pos_of[m2a]]),
    )
    return out
