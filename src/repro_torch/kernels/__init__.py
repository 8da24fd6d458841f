"""Hand-written Hopper kernels of the search, LM serving, recsys and
training paths.

Each kernel directory mirrors ``repro.kernels``:

  ref.py    — the search kernels' numpy oracles; for the other kernels,
              the plain PyTorch version of what the kernel computes
  kernel.py — the wrapper of the CUDA kernel (``csrc/*.cu``), beside the
              search kernels' plain PyTorch versions; the wrapper takes
              the plain version only for CPU tensors and launches the
              kernel (or raises) for CUDA tensors
  ops.py    — the dispatch the port's callers import

Kernels:
  posting_decode  — ``varint_decode``: raw LEB128 bytes to int64 values
                    in one launch (flags, a block scan with a decoupled
                    look-back across blocks for the value ids, assembly)
  intersect       — ``sorted_member_mask``: doc-id membership of sorted
                    lists in sorted lists, many segments a launch; a
                    merge path (a partition pass, then tiles staged by
                    bulk copies) or, where b is much the longer, a
                    windowed search, chosen by ``member_route``
  flash_attention — causal online-softmax attention of LM prefill, two
                    CUDA routes chosen by ``flash_route``: bf16 at D 64
                    or 128 on the tensor cores (``wgmma`` fed by TMA,
                    ``csrc/flash_attention_wgmma.cu``), anything else on
                    split-TF32 ``wgmma`` (``csrc/flash_attention.cu``)
  paged_attention — one-token attention over a paged KV pool (LM decode)
  embedding_bag   — fixed-size weighted bags of table rows, summed in
                    f32 (DLRM's 26 lookups)
  adamw           — one leaf's whole AdamW update in one pass (every
                    trainer step); it ports no Pallas kernel (the
                    reference's AdamW is jnp arithmetic that XLA fuses),
                    and its plain version lies beside the wrapper in
                    ``kernel.py``

``cuda_lib`` builds ``csrc/`` into one shared library at first use and
binds its C entry points through ctypes.
"""
