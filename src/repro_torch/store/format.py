"""Binary primitives shared by the WAL and segment files.

Everything durable in :mod:`repro_torch.store` is built from four little
codecs, all little-endian, all length-prefixed so a reader can skip what
it does not understand:

  * the *key codec* — posting-map keys as stored by the extraction
    layer: almost always packed int64 (plain lemma ids, ``(w<<32)|v``
    word pairs, bit-packed stop sequences, multi-component k-gram
    packs), with str/bytes/tuple kept for generality;
  * the *array codec* — raw int64 numpy columns (token streams, offset
    tables);
  * the *run codec* — one key's posting list as a varint delta run
    (:func:`repro_torch.core.postings.encode_postings` with ``prev_doc=0``,
    i.e. self-contained);
  * the *maps codec* — one extracted part, ``{index name → {key →
    (N, 2) postings}}``, the exact shape ``apply_part_maps`` consumes.

Integrity is the caller's business: the WAL frames records with a CRC
header (:mod:`repro_torch.store.wal`) and segment files carry a whole-file CRC
trailer (:mod:`repro_torch.store.segments`); the codecs here assume their
input passed those checks.
"""

from __future__ import annotations

import struct
from typing import Dict, Hashable, Tuple

import numpy as np

KT_INT = 0
KT_STR = 1
KT_BYTES = 2
KT_TUPLE = 3

_KEY_INT = struct.Struct("<Bq")
_KEY_VAR = struct.Struct("<BH")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")


# ------------------------------------------------------------- key codec --
def encode_key(key: Hashable) -> bytes:
    if isinstance(key, (int, np.integer)):
        return _KEY_INT.pack(KT_INT, int(key))
    if isinstance(key, str):
        b = key.encode("utf-8")
        return _KEY_VAR.pack(KT_STR, len(b)) + b
    if isinstance(key, bytes):
        return _KEY_VAR.pack(KT_BYTES, len(key)) + key
    if isinstance(key, tuple):
        out = bytearray(_KEY_VAR.pack(KT_TUPLE, len(key)))
        for item in key:
            out += encode_key(item)
        return bytes(out)
    raise TypeError(f"unencodable key type {type(key).__name__}: {key!r}")


def decode_key(buf: bytes, off: int) -> Tuple[Hashable, int]:
    kt = buf[off]
    if kt == KT_INT:
        (_, v) = _KEY_INT.unpack_from(buf, off)
        return v, off + _KEY_INT.size
    (_, n) = _KEY_VAR.unpack_from(buf, off)
    off += _KEY_VAR.size
    if kt == KT_STR:
        return buf[off : off + n].decode("utf-8"), off + n
    if kt == KT_BYTES:
        return bytes(buf[off : off + n]), off + n
    if kt == KT_TUPLE:
        items = []
        for _ in range(n):
            item, off = decode_key(buf, off)
            items.append(item)
        return tuple(items), off
    raise ValueError(f"unknown key type tag {kt}")


# ----------------------------------------------------------- array codec --
def encode_array(arr: np.ndarray) -> bytes:
    a = np.ascontiguousarray(arr, dtype="<i8")
    return _U32.pack(a.shape[0]) + a.tobytes()


def decode_array(buf: bytes, off: int) -> Tuple[np.ndarray, int]:
    (n,) = _U32.unpack_from(buf, off)
    off += _U32.size
    end = off + 8 * n
    a = np.frombuffer(buf, dtype="<i8", count=n, offset=off).astype(np.int64)
    return a, end


# ------------------------------------------------------------- run codec --
def encode_run(postings: np.ndarray) -> bytes:
    """One key's posting list as a self-contained varint delta run."""
    from repro_torch.core.postings import encode_postings

    run = encode_postings(postings, prev_doc=0)
    return _U32.pack(len(run)) + run


def decode_run(buf: bytes, off: int) -> Tuple[np.ndarray, int]:
    from repro_torch.core.postings import decode_postings

    (n,) = _U32.unpack_from(buf, off)
    off += _U32.size
    posts, _ = decode_postings(bytes(buf[off : off + n]))
    return posts, off + n


# ------------------------------------------------------------ maps codec --
def encode_part_maps(maps: Dict[str, Dict[Hashable, np.ndarray]]) -> bytes:
    out = bytearray(_U16.pack(len(maps)))
    for name, by_key in maps.items():
        nb = name.encode("utf-8")
        out += struct.pack("<B", len(nb)) + nb
        out += _U32.pack(len(by_key))
        for key, arr in by_key.items():
            out += encode_key(key)
            out += encode_run(np.asarray(arr, dtype=np.int64))
    return bytes(out)


def decode_part_maps(buf: bytes) -> Dict[str, Dict[Hashable, np.ndarray]]:
    (n_indexes,) = _U16.unpack_from(buf, 0)
    off = _U16.size
    maps: Dict[str, Dict[Hashable, np.ndarray]] = {}
    for _ in range(n_indexes):
        ln = buf[off]
        off += 1
        name = bytes(buf[off : off + ln]).decode("utf-8")
        off += ln
        (n_keys,) = _U32.unpack_from(buf, off)
        off += _U32.size
        by_key: Dict[Hashable, np.ndarray] = {}
        for _ in range(n_keys):
            key, off = decode_key(buf, off)
            posts, off = decode_run(buf, off)
            by_key[key] = posts
        maps[name] = by_key
    return maps


# ----------------------------------------------------- part-tokens codec --
def encode_part_tokens(
    doc0: int, tokens: np.ndarray, offsets: np.ndarray
) -> bytes:
    return _I64.pack(int(doc0)) + encode_array(tokens) + encode_array(offsets)


def decode_part_tokens(buf: bytes) -> Tuple[int, np.ndarray, np.ndarray]:
    (doc0,) = _I64.unpack_from(buf, 0)
    tokens, off = decode_array(buf, _I64.size)
    offsets, _ = decode_array(buf, off)
    return doc0, tokens, offsets
