"""Dispatch wrappers: backend-selected varint posting decode.

``unpack_varints`` decodes a terminator-aligned byte buffer on the chosen
backend; ``DeviceDecoder`` wraps it behind the exact ``feed``/state
surface of the host :class:`~repro_torch.core.postings.PostingDecoder`,
so the lazy cursor path can swap decoders without changing semantics;
``decode_member_prefilter`` is the fused decode→intersect entry point
(decode a chunk AND mask its rows against another list's doc ids).

Backends: ``numpy`` (the host oracle), ``torch`` (the host ``byte_prep``,
then the segment sum as ``index_add_`` on the device) and ``cuda`` (the
raw bytes go to the device and one ``varint_decode`` launch does steps
1-3; the host only counts the terminator bytes, to size the output).  The
device values are int64, so every varint width decodes on the device and
every chunk a ``cuda`` decoder is fed goes through the kernel; there is
neither a width gate nor a size threshold.  The delta expansion stays
exact host int64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.kernels.intersect.kernel import (
    sorted_member_mask,
    sorted_member_mask_plain,
)
from repro_torch.kernels.posting_decode.kernel import (
    varint_decode,
    varint_segment_sum_plain,
)
from repro_torch.kernels.posting_decode.ref import (
    as_byte_array,
    byte_prep,
    complete_prefix,
    expand_deltas,
    unpack_varints_np,
)

DECODE_BACKENDS = ("numpy", "torch", "cuda")


def _check_backend(backend: str) -> None:
    if backend not in DECODE_BACKENDS:
        raise ValueError(
            f"unknown decode backend {backend!r}; expected one of "
            f"{DECODE_BACKENDS}"
        )


def unpack_varints(buf, backend: str = "cuda",
                   device: DeviceLike = None) -> np.ndarray:
    """Decode a terminator-aligned byte buffer's varints as (N,) int64.

    ``backend`` picks where the decode runs: under ``cuda`` the raw bytes
    go to the device, under ``torch`` the host's byte prep does."""
    _check_backend(backend)
    buf = as_byte_array(buf)
    if backend == "numpy" or buf.size == 0:
        return unpack_varints_np(buf)
    dev = resolve_device(device)
    if backend == "cuda":
        if buf[-1] >= 0x80:
            raise ValueError("buffer must end on a varint terminator")
        n_vals = int(np.count_nonzero(buf < 0x80))
        values = varint_decode(to_device(buf, dev, dtype=np.uint8), n_vals)
    else:
        contrib, vid, n_vals = byte_prep(buf)
        values = varint_segment_sum_plain(
            to_device(vid, dev), to_device(contrib, dev), n_vals)
    return values.cpu().numpy()


class DeviceDecoder:
    """Incremental posting decoder with a device-resident varint unpack.

    Drop-in for :class:`repro_torch.core.postings.PostingDecoder` on the
    untagged streams the lazy (K_OWN) cursor path feeds: same ``feed``
    contract (decode every complete record of ``rem + data``, buffer the
    tail), same ``state()``/``set_state()`` carry tuple — a stream may be
    suspended under one decoder and resumed under the other.  The delta
    expansion stays exact host int64; only the varint unpack runs on
    ``device``.
    """

    def __init__(self, backend: str = "cuda", device: DeviceLike = None):
        _check_backend(backend)
        self.backend = backend
        self.device = resolve_device(device)
        self._rem = b""
        self._prev_doc = 0
        self._prev_pos = 0
        self._any = False

    @property
    def pending_bytes(self) -> int:
        return len(self._rem)

    def feed(self, data) -> Tuple[np.ndarray, np.ndarray]:
        buf = self._rem + bytes(data)
        cut = complete_prefix(np.frombuffer(buf, dtype=np.uint8))
        values = unpack_varints(buf[:cut], backend=self.backend,
                                device=self.device)
        posts, (pd, pp, st) = expand_deltas(
            values, self._prev_doc, self._prev_pos, self._any
        )
        self._rem = buf[cut:]
        self._prev_doc, self._prev_pos, self._any = pd, pp, st
        return posts, np.zeros(posts.shape[0], dtype=np.int64)

    # carry tuple shared with PostingDecoder (see its state/set_state)
    def state(self) -> Tuple[bytes, int, int, bool]:
        return (self._rem, self._prev_doc, self._prev_pos, self._any)

    def set_state(self, state: Tuple[bytes, int, int, bool]) -> None:
        rem, prev_doc, prev_pos, any_ = state
        self._rem = bytes(rem)
        self._prev_doc = int(prev_doc)
        self._prev_pos = int(prev_pos)
        self._any = bool(any_)


def decode_member_prefilter(
    data,
    other_docs: np.ndarray,
    backend: str = "cuda",
    state: Tuple[bytes, int, int, bool] = (b"", 0, 0, False),
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray, Tuple[bytes, int, int, bool]]:
    """Fused decode→intersect: decode a posting chunk and mask its rows
    whose doc id occurs in ``other_docs``.

    ``state`` is the decoder carry (``DeviceDecoder.state()`` tuple) so
    chunked streams fuse too.  Returns ``(posts, member_mask,
    new_state)``.  Under ``cuda`` both steps run the hand kernels, under
    ``torch`` their plain versions on the device, under ``numpy`` the
    host searchsorted test."""
    _check_backend(backend)
    dec = DeviceDecoder(backend=backend, device=device)
    dec.set_state(state)
    posts, _ = dec.feed(data)
    docs = posts[:, 0]
    other = np.unique(np.asarray(other_docs, dtype=np.int64))
    if other.size == 0 or docs.size == 0:
        mask = np.zeros(docs.shape, dtype=bool)
    elif backend == "numpy":
        idx = np.clip(np.searchsorted(other, docs), 0, other.size - 1)
        mask = other[idx] == docs
    else:
        member = (sorted_member_mask if backend == "cuda"
                  else sorted_member_mask_plain)
        mask = member(to_device(docs, dec.device),
                      to_device(other, dec.device)).cpu().numpy()
    return posts, np.asarray(mask, dtype=bool), dec.state()


# ------------------------------------------------- device-resident rows ---
def to_device_rows(posts: np.ndarray,
                   device: DeviceLike = None) -> Optional[torch.Tensor]:
    """(N,2) int64 postings → int32 device buffer, or None when any value
    exceeds int32.  The tier stays int32 although the device has int64:
    the posting cache charges a buffer at its ``nbytes``, and int32 rows
    keep ``bytes_used`` and the eviction order equal to the reference's."""
    if posts.size and int(posts.max()) >= np.iinfo(np.int32).max:
        return None
    return to_device(posts, resolve_device(device), dtype=np.int32)


def from_device_rows(buf: torch.Tensor) -> np.ndarray:
    """Device buffer → immutable (N,2) int64 host rows (the cursor ABI)."""
    rows = buf.cpu().numpy().astype(np.int64)
    rows.flags.writeable = False
    return rows
