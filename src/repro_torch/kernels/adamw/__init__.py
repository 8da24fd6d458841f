from repro_torch.kernels.adamw.kernel import (  # noqa: F401
    ADAMW,
    adamw_leaf,
    adamw_leaf_plain,
)
