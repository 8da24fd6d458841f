from repro_torch.sparse.embedding import (  # noqa: F401
    embedding_bag,
    embedding_lookup,
    segment_softmax,
)
