"""Host-callable dispatch of the sorted membership kernel."""

from __future__ import annotations

import numpy as np

from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.kernels.intersect.kernel import sorted_member_mask


def intersect_sorted(a, b, device: DeviceLike = None) -> np.ndarray:
    """Host mask[i] = a[i] in b for sorted integer arrays (``b`` without
    duplicates), computed on ``device``."""
    dev = resolve_device(device)
    mask = sorted_member_mask(to_device(np.asarray(a), dev),
                              to_device(np.asarray(b), dev))
    return mask.cpu().numpy()


def doc_member_mask(
    a_docs: np.ndarray, b_docs: np.ndarray, device: DeviceLike = None
) -> np.ndarray:
    """Host mask[i] = a_docs[i] occurs in b_docs, via the membership kernel.

    The doc-level prefilter of one pair, the counterpart of the
    reference's ``doc_member_mask`` (the ``cuda`` window join prefilters
    a whole round of pairs in one launch:
    :func:`repro_torch.search.join.cuda_join_many`).  ``a_docs`` must be
    sorted; ``b_docs`` is deduplicated here.  Keys are int64 on the
    device, so every doc id fits: there is no host fallback."""
    if a_docs.size == 0 or b_docs.size == 0:
        return np.zeros(a_docs.shape, dtype=bool)
    return intersect_sorted(a_docs, np.unique(b_docs), device=device)
