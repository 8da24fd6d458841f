"""Posting codec: (doc_id, position) records with varint delta encoding.

A posting is the paper's two-field record ``(ID, P)``: document identifier
and ordinal word position (section 1).  Posting lists are kept sorted by
``(doc_id, position)`` and encoded as byte streams:

  * doc_id is delta-encoded against the previous posting's doc_id,
  * position is delta-encoded within a document (and absolute when the
    doc_id changes),
  * TAG streams (section 5.6) prepend a per-posting local key tag varint.

Varints are LEB128 (7 bits per byte, high bit = continue).  The codec is
the single source of truth for *sizes*: every strategy decision in
``stream.py`` is driven by encoded byte counts, exactly as the paper's
strategies are driven by data sizes.

A vectorized (numpy) bulk encoder is provided because index construction
benchmarks push tens of millions of postings through this path.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

Posting = Tuple[int, int]  # (doc_id, position)


# ----------------------------------------------------------------- varint ---
def encode_varint(value: int, out: bytearray) -> None:
    assert value >= 0
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def decode_varint(buf: bytes, offset: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[offset]
        offset += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, offset
        shift += 7


def varint_size(value: int) -> int:
    if value < (1 << 7):
        return 1
    size = 1
    value >>= 7
    while value:
        size += 1
        value >>= 7
    return size


# ------------------------------------------------------- bulk numpy encode ---
def _varint_sizes(values: np.ndarray) -> np.ndarray:
    """Vectorized LEB128 encoded-size computation."""
    v = values.astype(np.uint64)
    sizes = np.ones(v.shape, dtype=np.int64)
    bound = np.uint64(1 << 7)
    while True:
        bigger = v >= bound
        if not bigger.any():
            return sizes
        sizes += bigger.astype(np.int64)
        if int(bound) >= (1 << 56):
            return sizes
        bound = np.uint64(int(bound) << 7)


def _bulk_varint_encode(values: np.ndarray) -> bytes:
    """Encode a flat array of non-negative ints as concatenated varints."""
    values = values.astype(np.uint64, copy=False)
    sizes = _varint_sizes(values)
    total = int(sizes.sum())
    out = np.empty(total, dtype=np.uint8)
    offsets = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    max_size = int(sizes.max()) if sizes.size else 1
    v = values.copy()
    for byte_i in range(max_size):
        active = sizes > byte_i
        if not active.any():
            break
        idx = offsets[active] + byte_i
        chunk = (v[active] & np.uint64(0x7F)).astype(np.uint8)
        more = sizes[active] > (byte_i + 1)
        chunk = chunk | (more.astype(np.uint8) << 7)
        out[idx] = chunk
        v[active] = v[active] >> np.uint64(7)
    return out.tobytes()


def _encode_small(arr, tags, prev_doc: int, zigzag: bool) -> bytes:
    """Scalar fast path: numpy per-call overhead dominates below ~32 rows."""
    out = bytearray()
    rows = arr.tolist()
    tag_list = None if tags is None else np.asarray(tags).tolist()
    pd = prev_doc
    pp = 0
    first = True
    for i, (doc, pos) in enumerate(rows):
        dd = doc - pd
        if not first and dd == 0:
            pv = pos - pp
        else:
            pv = pos
        if zigzag:
            dd = _zz(dd)
            pv = _zz(pv)
        else:
            assert dd >= 0 and pv >= 0, "postings must be sorted"
        if tag_list is not None:
            encode_varint(tag_list[i], out)
        encode_varint(dd, out)
        encode_varint(pv, out)
        pd, pp = doc, pos
        first = False
    return bytes(out)


def _zz(v: int) -> int:
    return (v << 1) if v >= 0 else ((-v) << 1) - 1


def _zigzag(v: np.ndarray) -> np.ndarray:
    return (v << 1) ^ (v >> 63)


def _unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def encode_postings(
    postings: Sequence[Posting] | np.ndarray,
    tags: Sequence[int] | np.ndarray | None = None,
    prev_doc: int = 0,
    zigzag: bool = False,
) -> bytes:
    """Encode a posting list batch; returns the byte stream.

    ``postings`` is an (N, 2) array-like of (doc_id, position).  If ``tags``
    is given (TAG strategy), each posting is prefixed with its local key tag.
    ``prev_doc`` is the delta continuation point: the last doc_id already
    stored in the stream this batch is appended to, so that concatenated
    batches decode as one list.  ``zigzag`` encodes signed deltas — required
    for TAG streams, where batches of different keys interleave doc ranges.
    """
    arr = np.asarray(postings, dtype=np.int64)
    if arr.size == 0:
        return b""
    assert arr.ndim == 2 and arr.shape[1] == 2
    if arr.shape[0] <= 32:
        return _encode_small(arr, tags, prev_doc, zigzag)
    doc = arr[:, 0]
    pos = arr[:, 1]
    doc_delta = np.empty_like(doc)
    doc_delta[0] = doc[0] - prev_doc
    doc_delta[1:] = doc[1:] - doc[:-1]
    same_doc = np.concatenate(([False], doc_delta[1:] == 0))
    pos_delta = np.where(
        same_doc, pos - np.concatenate(([0], pos[:-1])), pos
    )
    if zigzag:
        doc_delta = _zigzag(doc_delta)
        pos_delta = _zigzag(pos_delta)
    else:
        assert (doc_delta >= 0).all(), "postings must be sorted by doc_id"
        assert (pos_delta >= 0).all(), "positions must be sorted within a doc"
    if tags is None:
        flat = np.empty(arr.shape[0] * 2, dtype=np.int64)
        flat[0::2] = doc_delta
        flat[1::2] = pos_delta
    else:
        t = np.asarray(tags, dtype=np.int64)
        assert t.shape[0] == arr.shape[0]
        flat = np.empty(arr.shape[0] * 3, dtype=np.int64)
        flat[0::3] = t
        flat[1::3] = doc_delta
        flat[2::3] = pos_delta
    return _bulk_varint_encode(flat)


def decode_postings(
    data: bytes, tagged: bool = False, zigzag: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a byte stream back to ((N,2) postings, (N,) tags).

    Tags are all-zero when ``tagged`` is False.
    """
    docs: List[int] = []
    poss: List[int] = []
    tags: List[int] = []
    offset = 0
    prev_doc = 0
    prev_pos = 0
    n = len(data)
    while offset < n:
        if tagged:
            tag, offset = decode_varint(data, offset)
        else:
            tag = 0
        dd, offset = decode_varint(data, offset)
        pd, offset = decode_varint(data, offset)
        if zigzag:
            dd = _unzigzag(dd)
            pd = _unzigzag(pd)
        if docs and dd == 0:
            doc = prev_doc
            pos = prev_pos + pd
        else:
            doc = prev_doc + dd
            pos = pd
        docs.append(doc)
        poss.append(pos)
        tags.append(tag)
        prev_doc, prev_pos = doc, pos
    out = np.empty((len(docs), 2), dtype=np.int64)
    out[:, 0] = docs
    out[:, 1] = poss
    return out, np.asarray(tags, dtype=np.int64)


class PostingDecoder:
    """Incremental decoder over a posting byte stream fed in chunks.

    The lazy read path (``InvertedIndex.open_cursor``) fetches a stream's
    storage units one at a time; a unit boundary may split a varint or a
    whole record, so the decoder keeps the undecodable tail bytes and the
    delta-continuation state (previous doc/pos) between ``feed`` calls.
    Feeding the full stream in any chunking decodes exactly the rows
    ``decode_postings`` would return on the concatenated bytes.
    """

    def __init__(self, tagged: bool = False, zigzag: bool = False):
        self.tagged = tagged
        self.zigzag = zigzag
        self._rem = b""
        self._prev_doc = 0
        self._prev_pos = 0
        self._any = False

    @property
    def pending_bytes(self) -> int:
        """Tail bytes buffered until the next feed completes their record."""
        return len(self._rem)

    def state(self) -> Tuple[bytes, int, int, bool]:
        """The full carry: (tail bytes, prev_doc, prev_pos, any-decoded).

        With it a suspended stream resumes EXACTLY where it stopped:
        restoring the tuple into a fresh decoder (this class or the
        device-backed ``repro_torch.kernels.posting_decode.ops.DeviceDecoder``,
        which shares the format) and feeding the remaining bytes decodes
        the same rows as an uninterrupted drain — the contract behind
        partial-prefix cache admission (``ReaderCursor.settle``)."""
        return (self._rem, self._prev_doc, self._prev_pos, self._any)

    def set_state(self, state: Tuple[bytes, int, int, bool]) -> None:
        rem, prev_doc, prev_pos, any_ = state
        self._rem = bytes(rem)
        self._prev_doc = int(prev_doc)
        self._prev_pos = int(prev_pos)
        self._any = bool(any_)

    def feed(self, data: bytes) -> Tuple[np.ndarray, np.ndarray]:
        """Decode every complete record of ``rem + data``; buffer the rest."""
        buf = self._rem + bytes(data)
        docs: List[int] = []
        poss: List[int] = []
        tags: List[int] = []
        offset = 0
        n = len(buf)
        while offset < n:
            start = offset
            try:
                if self.tagged:
                    tag, offset = decode_varint(buf, offset)
                else:
                    tag = 0
                dd, offset = decode_varint(buf, offset)
                pd, offset = decode_varint(buf, offset)
            except IndexError:  # record truncated at the chunk boundary
                offset = start
                break
            if self.zigzag:
                dd = _unzigzag(dd)
                pd = _unzigzag(pd)
            if self._any and dd == 0:
                doc = self._prev_doc
                pos = self._prev_pos + pd
            else:
                doc = self._prev_doc + dd
                pos = pd
            docs.append(doc)
            poss.append(pos)
            tags.append(tag)
            self._prev_doc, self._prev_pos = doc, pos
            self._any = True
        self._rem = buf[offset:]
        out = np.empty((len(docs), 2), dtype=np.int64)
        out[:, 0] = docs
        out[:, 1] = poss
        return out, np.asarray(tags, dtype=np.int64)


def encoded_size(postings: Sequence[Posting] | np.ndarray,
                 tags: Sequence[int] | np.ndarray | None = None) -> int:
    return len(encode_postings(postings, tags))


def merge_sorted_postings(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Merge two (N,2) posting arrays sorted by (doc, pos)."""
    if a.size == 0:
        return b
    if b.size == 0:
        return a
    both = np.concatenate([a, b], axis=0)
    order = np.lexsort((both[:, 1], both[:, 0]))
    return both[order]


def max_doc_run(posts: np.ndarray) -> int:
    """Largest per-document posting count in a doc-sorted (N, 2) array.

    This is the per-part ingredient of ``Entry.max_doc_count`` — the
    WAND-style score upper-bound metadata the ranked streaming executor
    consumes (see ``repro_torch.search.scoring``).  Doc ids are globally
    increasing across parts, so the max over a key's lifetime is just the
    running max of this value over its per-part batches.
    """
    if posts.shape[0] == 0:
        return 0
    docs = posts[:, 0]
    change = np.flatnonzero(docs[1:] != docs[:-1])
    bounds = np.concatenate(([0], change + 1, [docs.shape[0]]))
    return int(np.diff(bounds).max())
