"""Oracle: byte-parallel LEB128 posting decode (vectorized numpy).

The scalar decoder (``repro_torch.core.postings.PostingDecoder``) walks the
byte stream varint by varint.  The data-parallel formulation below is
what the device kernels implement, and doubles as their exact oracle:

  1. terminator flags — a byte with the high bit CLEAR ends a varint,
     so a cumulative sum of the flags assigns every byte its value id;
  2. per-byte contributions — byte ``b`` at rank ``r`` inside its value
     contributes ``(b & 0x7f) << (7 * r)``;
  3. segmented sum — summing contributions by value id yields the
     decoded varints (contributions occupy disjoint bit ranges, so an
     add-reduction IS the bitwise assembly);
  4. delta expansion — untagged posting records are (doc_delta,
     pos_value) pairs: docs are a prefix sum of the deltas, positions a
     per-same-doc-run prefix sum (a segmented cumsum over the runs
     where the doc delta is zero).

Everything here is exact int64 host arithmetic; the device paths in
``ops.py`` reuse steps 1-3 with an int32 width gate and always run
step 4 on the host (bit-for-bit parity with the scalar decoder).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_EMPTY = np.zeros((0, 2), dtype=np.int64)

# a decoded (doc_delta, pos_value) record is two varints
_VALS_PER_RECORD = 2


def as_byte_array(data) -> np.ndarray:
    """Bytes-like → (n,) uint8 array without copying when possible."""
    if isinstance(data, np.ndarray) and data.dtype == np.uint8:
        return data
    return np.frombuffer(bytes(data), dtype=np.uint8)


def complete_prefix(buf: np.ndarray) -> int:
    """Byte length of the longest prefix holding only WHOLE records.

    A record is ``_VALS_PER_RECORD`` varints; the prefix ends after the
    last terminator that completes a record, so the remainder (a split
    varint or a dangling doc delta) is the tail the incremental decoder
    must buffer — the same boundary ``PostingDecoder.feed`` finds by
    catching the truncated-record IndexError.
    """
    buf = as_byte_array(buf)
    if buf.size == 0:
        return 0
    term_idx = np.flatnonzero((buf & 0x80) == 0)
    n_records = term_idx.size // _VALS_PER_RECORD
    if n_records == 0:
        return 0
    return int(term_idx[n_records * _VALS_PER_RECORD - 1]) + 1


def byte_prep(buf: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Steps 1-2 of the byte-parallel decode (shared by every backend).

    ``buf`` must end on a varint terminator (a ``complete_prefix``
    slice).  Returns ``(contrib, vid, n_vals)``: per-byte shifted
    payloads (int64), per-byte value ids (sorted, int64), and the
    number of varints.
    """
    buf = as_byte_array(buf)
    n = buf.size
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), 0)
    term = (buf & 0x80) == 0
    assert term[-1], "buffer must end on a varint terminator"
    # a value starts at byte 0 and right after every terminator
    new_val = np.empty(n, dtype=bool)
    new_val[0] = True
    new_val[1:] = term[:-1]
    vid = np.cumsum(new_val) - 1
    starts = np.flatnonzero(new_val)
    rank = np.arange(n, dtype=np.int64) - starts[vid]
    contrib = (buf & 0x7F).astype(np.int64) << (7 * rank)
    return contrib, vid.astype(np.int64), int(starts.size)


def unpack_varints_np(buf: np.ndarray) -> np.ndarray:
    """Step 3 on the host: decode a terminator-aligned buffer's varints."""
    contrib, vid, n_vals = byte_prep(buf)
    if n_vals == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.flatnonzero(np.diff(vid, prepend=-1))
    return np.add.reduceat(contrib, starts)


def expand_deltas(
    values: np.ndarray, prev_doc: int, prev_pos: int, started: bool
) -> Tuple[np.ndarray, Tuple[int, int, bool]]:
    """Step 4: (doc_delta, pos_value) varint pairs → (N,2) postings.

    Continuation-aware: ``(prev_doc, prev_pos, started)`` is the scalar
    decoder's carry state, so feeding a stream block by block through
    this expansion decodes exactly what one-shot decoding would.
    Returns the rows and the updated carry.
    """
    assert values.size % _VALS_PER_RECORD == 0
    n = values.size // _VALS_PER_RECORD
    if n == 0:
        return _EMPTY, (prev_doc, prev_pos, started)
    dd = values[0::2]
    pv = values[1::2]
    docs = prev_doc + np.cumsum(dd)
    # a record CONTINUES its doc's position run iff its doc delta is 0
    # and some record precedes it (the very first record of a stream is
    # absolute even when its delta is 0 — doc id 0's first posting)
    same = dd == 0
    if not started:
        same[0] = False
    # positions: absolute at each run head, cumulative within a run.
    # With cs = cumsum(pv), pos[i] = cs[i] - C[i] where C is constant
    # per run: cs[h] - pv[h] at a head h, and -prev_pos for the leading
    # continuation run (no head in this block).  Head values cs[h]-pv[h]
    # = cs[h-1] are nondecreasing and >= 0 >= -prev_pos, so a running
    # max forward-fills C exactly.
    cs = np.cumsum(pv)
    carry = np.where(~same, cs - pv, -np.int64(prev_pos))
    c = np.maximum.accumulate(carry)
    pos = cs - c
    out = np.empty((n, 2), dtype=np.int64)
    out[:, 0] = docs
    out[:, 1] = pos
    return out, (int(docs[-1]), int(pos[-1]), True)


def decode_block_ref(
    block: np.ndarray,
    prev_doc: int = 0,
    prev_pos: int = 0,
    started: bool = False,
) -> Tuple[np.ndarray, Tuple[int, int, bool]]:
    """Whole-record block → (N,2) postings + updated carry (numpy path)."""
    values = unpack_varints_np(block)
    return expand_deltas(values, prev_doc, prev_pos, started)
