"""PyTorch and CUDA port of the easily updatable full-text index stack.

The package mirrors ``repro``'s layout so each module's counterpart is
found by path: ``core/`` (the index substrate, its own copy), ``data/``
(corpus generation and the benchmark worlds), ``search/`` (plan,
scatter-fetch, joins, streaming top-k) and ``kernels/`` (the two main-path
kernels, hand-written CUDA for Hopper under ``csrc/``).  It imports
``torch`` and numpy and nothing of JAX or of ``repro``.

Entry points take ``device=``; ``None`` means the CUDA card and raises
when there is none (see :mod:`repro_torch.device`).
"""
