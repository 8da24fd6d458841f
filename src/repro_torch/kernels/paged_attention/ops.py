"""Dispatch: paged decode attention through the paged kernel.

The port's ``paged_attention`` (defined beside its kernel in
``kernel.py``) keeps the contract of
``repro.kernels.paged_attention.ops.paged_attention``: q (B, H, D), pools
(n_pages, page, D), ``block_table`` (B, max_pages) and ``lengths`` (B,).
"""

from repro_torch.kernels.paged_attention.kernel import paged_attention  # noqa: F401
