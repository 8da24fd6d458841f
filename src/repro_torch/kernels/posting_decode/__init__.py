"""Device-resident varint posting decode (+ fused decode→intersect).

``repro_torch.core.postings.PostingDecoder`` is the host-side incremental
decoder the lazy cursors feed chunk by chunk.  This package is its device
counterpart, mirroring ``repro_torch.kernels.intersect``:

  ref.py    — vectorized numpy oracle: the byte-parallel formulation of
              the LEB128 record decode (terminator cumsum → per-byte value
              ids/ranks → segmented payload sum → delta expansion)
  kernel.py — the ``varint_segment_sum`` CUDA kernel's wrapper and its
              plain PyTorch version (``index_add_``)
  ops.py    — backend dispatch (numpy | torch | cuda), the cursor-
              compatible :class:`DeviceDecoder`, the fused
              :func:`decode_member_prefilter` entry point, and the int32
              device-row tier converters
"""
