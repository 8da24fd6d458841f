"""Dispatch: the fixed-size EmbeddingBag through the embedding-bag kernel.

The port's ``embedding_bag_fixed`` (defined beside its kernel in
``kernel.py``) keeps the contract of
``repro.kernels.embedding_bag.ops.embedding_bag_fixed``: table (V, D),
ids and weights (B, K), output (B, D) in the table's dtype.
``embedding_bags`` takes T such tables in one launch (DLRM's lookups).
"""

from repro_torch.kernels.embedding_bag.kernel import (  # noqa: F401
    embedding_bag_fixed,
    embedding_bags,
)
