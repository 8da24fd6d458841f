from repro_torch.kernels.embedding_bag.ops import embedding_bag_fixed  # noqa: F401
from repro_torch.kernels.embedding_bag.ref import embedding_bag_fixed_plain  # noqa: F401
