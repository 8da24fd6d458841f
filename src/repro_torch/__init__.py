"""PyTorch and CUDA port of the easily updatable full-text index stack.

The package mirrors ``repro``'s layout so each module's counterpart is
found by path: ``core/`` (the index substrate, its own copy), ``data/``
(corpus generation and the benchmark worlds), ``search/`` (plan,
scatter-fetch, joins, streaming top-k, the replica read fabric),
``store/`` (the durable store: write-ahead log, checkpoint segments,
recovery and read replicas; its on-disk format is the reference's),
``nn/``, ``models/``, ``serve/``, ``configs/`` and ``launch/`` (dense LM
serving over the paged-KV substrate, and recsys serving), ``sparse/``
(embedding lookups and ragged bags) and ``kernels/`` (the five kernels of
those paths, hand-written CUDA for Hopper under ``csrc/``).  It imports
``torch`` and numpy and nothing of JAX or of ``repro``.

Entry points take ``device=``; ``None`` means the CUDA card and raises
when there is none (see :mod:`repro_torch.device`).
"""
