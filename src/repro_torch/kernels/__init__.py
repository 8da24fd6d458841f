"""Hand-written Hopper kernels of the search path.

Each kernel directory mirrors ``repro.kernels``:

  ref.py    — numpy oracle of what the kernel computes
  kernel.py — the wrapper of the CUDA kernel (``csrc/*.cu``) and, in the
              same module, its plain PyTorch version; the wrapper takes the
              plain version only for CPU tensors and launches the kernel
              (or raises) for CUDA tensors
  ops.py    — host-callable dispatch used by the search stack

Kernels:
  posting_decode — ``varint_segment_sum``: step 3 of the byte-parallel
                   LEB128 decode, a warp-segmented sum into int64 slots
  intersect      — ``sorted_member_mask``: doc-id membership of one sorted
                   list in another, one binary search per element

``cuda_lib`` builds ``csrc/`` into one shared library at first use and
binds its C entry points through ctypes.
"""
