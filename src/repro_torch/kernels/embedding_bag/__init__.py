from repro_torch.kernels.embedding_bag.ops import (  # noqa: F401
    embedding_bag_fixed,
    embedding_bags,
)
from repro_torch.kernels.embedding_bag.ref import (  # noqa: F401
    embedding_bag_fixed_plain,
    embedding_bags_plain,
)
