"""Dispatch: (B, H, S, D) attention through the flash kernel.

The port's ``flash_attention`` (defined beside its kernel in ``kernel.py``)
keeps the JAX wrapper's contract (``repro.kernels.flash_attention.ops``)
and widens it in two ways: K/V may have fewer heads than q (GQA, head
``h`` reads KV head ``h // G``), and S need not be a multiple of any tile.
There are no block-size arguments: the CUDA kernel's tiles are fixed.
"""

from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    flash_attention,
    flash_attention_differentiable,
)
