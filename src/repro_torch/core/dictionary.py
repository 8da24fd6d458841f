"""Key dictionary (paper section 1, component 2).

Maps a key to where its posting list lives.  Entry layouts mirror the
paper's descriptions:

  * EM entries hold the posting bytes inline ("the data of the posting list
    can be stored in the dictionary with the key", 5.2),
  * TAG entries reference a shared stream plus the key's local tag (5.6),
  * OWN entries reference a dedicated stream; the stream manager knows the
    first/last cluster numbers, FL cluster and SR record the paper lists.

Keys are arbitrary hashables canonicalised to bytes; group assignment
(C1 phases) is a stable CRC so runs are reproducible.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Hashable, List, Optional, Tuple

# entry kinds
K_EM = "em"
K_TAG = "tag"
K_OWN = "own"

ENTRY_FIXED_BYTES = 24  # key hash + location + sizes: dictionary traffic model


def key_bytes(key: Hashable) -> bytes:
    if isinstance(key, bytes):
        return key
    if isinstance(key, str):
        return key.encode("utf-8")
    if isinstance(key, int):
        return b"i" + key.to_bytes(8, "little", signed=True)
    if isinstance(key, tuple):
        return b"t" + b"|".join(key_bytes(k) for k in key)
    raise TypeError(f"unsupported key type: {type(key)}")


def stable_hash(key: Hashable) -> int:
    return zlib.crc32(key_bytes(key))


@dataclasses.dataclass
class Entry:
    kind: str = K_EM
    data: bytearray = dataclasses.field(default_factory=bytearray)  # EM only
    sid: int = -1
    tag: int = -1
    nbytes: int = 0      # this key's (untagged-equivalent) encoded bytes
    last_doc: int = 0
    npostings: int = 0
    # largest per-document posting count ever appended for this key — the
    # WAND-style score upper-bound metadata the ranked top-k executor
    # carries on cursors (doc ids only grow across parts, so the running
    # max over per-part batches is exact; see repro_torch.search.scoring)
    max_doc_count: int = 0


class Dictionary:
    """Key → Entry map with per-group partitions (C1 phases)."""

    def __init__(self, n_groups: int):
        self.n_groups = max(1, int(n_groups))
        self.entries: Dict[Hashable, Entry] = {}
        # TAG buckets: (group, bucket) -> stream id + member keys in tag order
        self.buckets: Dict[Tuple[int, int], int] = {}
        self.bucket_members: Dict[int, List[Hashable]] = {}

    def group_of(self, key: Hashable) -> int:
        return stable_hash(key) % self.n_groups

    def get(self, key: Hashable) -> Optional[Entry]:
        return self.entries.get(key)

    def get_or_create(self, key: Hashable) -> Entry:
        e = self.entries.get(key)
        if e is None:
            e = Entry()
            self.entries[key] = e
        return e

    def group_entry_bytes(self, group: int) -> int:
        """Dictionary partition size for one phase's sequential load/save."""
        total = 0
        for key, e in self.entries.items():
            if self.group_of(key) == group:
                total += ENTRY_FIXED_BYTES + len(key_bytes(key)) + len(e.data)
        return total

    def keys_in_group(self, group: int) -> List[Hashable]:
        return [k for k in self.entries if self.group_of(k) == group]
