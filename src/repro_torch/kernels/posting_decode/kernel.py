"""Varint decode: the CUDA kernel's wrapper and its plain version.

``varint_decode`` takes the raw bytes of a terminator-aligned LEB128
stream and returns its values: steps 1-3 of the byte-parallel decode (see
``ref.py``) in one launch of ``csrc/varint_decode.cu``, which ports the
Pallas ``varint_unpack_kernel`` together with the host's byte prep; the
source says how and what bounds it.  ``varint_segment_sum_plain`` is step
3 alone (``index_add_`` of prepared payloads by value id): the plain
version's last step and the ``torch`` decode backend's sum.

Everything is int64: a varint of up to 10 bytes decodes exactly, so the
port has no width gate.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.costs import varint_cost
from repro_torch.kernels.cuda_lib import CudaKernel, check_operand

VARINT_DECODE = CudaKernel(
    "varint_decode",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_void_p],
    source="src/repro_torch/csrc/varint_decode.cu",
    replaces="src/repro/kernels/posting_decode/kernel.py:52",
)

TILE_BYTES = 4096   # stream bytes of one block (kTile in the source)


def varint_segment_sum_plain(
    vid: torch.Tensor, contrib: torch.Tensor, n_values: int
) -> torch.Tensor:
    """Step 3 in PyTorch: ``index_add_`` of the payloads by value id."""
    out = torch.zeros(n_values, dtype=torch.int64, device=vid.device)
    return out.index_add_(0, vid, contrib)


def varint_decode_plain(buf: torch.Tensor, n_values: int) -> torch.Tensor:
    """Plain PyTorch version: terminator flags, value ids (a cumsum),
    ranks and shifted payloads as ``ref.byte_prep`` forms them, then
    :func:`varint_segment_sum_plain`.  Bytes after the last terminator,
    and ids at or past ``n_values``, add nothing."""
    b = buf.to(torch.int64)
    n = b.numel()
    term = b < 0x80
    new_val = torch.ones(n, dtype=torch.bool, device=buf.device)
    new_val[1:] = term[:-1]
    vid = torch.cumsum(new_val, 0) - 1
    starts = torch.nonzero(new_val).squeeze(1)
    rank = torch.arange(n, device=buf.device) - starts[vid]
    contrib = (b & 0x7F) << (7 * rank)
    keep = vid < n_values
    return varint_segment_sum_plain(vid[keep], contrib[keep], n_values)


def varint_decode(buf: torch.Tensor, n_values: int) -> torch.Tensor:
    """(n_values,) int64 values of the LEB128 stream ``buf``.

    ``buf`` is a 1-d contiguous uint8 tensor whose varints are 1 to 10
    bytes long, and ``n_values`` its count of terminator bytes (bytes
    below 0x80).  A smaller ``n_values`` keeps the first values; a larger
    one leaves the ids past the stream's last value 0, in the kernel as in
    the plain version.  CUDA tensors go through the kernel; CPU tensors
    through :func:`varint_decode_plain`."""
    check_operand(buf, "buf", torch.uint8)
    n_values = int(n_values)
    n = buf.numel()
    if not 0 <= n_values <= n:
        raise ValueError(f"n_values must lie in [0, {n}], got {n_values}")
    dev = buf.device
    if dev.type == "cpu":
        return varint_decode_plain(buf, n_values)
    out = torch.empty(n_values, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    if VARINT_DECODE.charged((buf,), lambda: varint_cost(n, n_values)):
        return out
    tiles = -(-n // TILE_BYTES)
    # the look-back's status words and ticket, zeroed by the C entry
    scratch = torch.empty(tiles + 1, dtype=torch.int64, device=dev) \
        if tiles > 1 else None
    VARINT_DECODE.launch(dev, (n, n_values), buf.data_ptr(), n,
                         out.data_ptr(), n_values,
                         None if scratch is None else scratch.data_ptr())
    return out
