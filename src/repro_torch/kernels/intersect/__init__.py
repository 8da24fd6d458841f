from repro_torch.kernels.intersect.ops import (  # noqa: F401
    doc_member_mask,
    intersect_sorted,
)
from repro_torch.kernels.intersect.ref import intersect_sorted_ref  # noqa: F401
