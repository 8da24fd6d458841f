"""Oracle: sorted posting intersection membership (numpy)."""

from __future__ import annotations

import numpy as np


def intersect_sorted_ref(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """mask[i] = a[i] in b, for sorted int arrays (searchsorted oracle)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if b.size == 0:
        return np.zeros(a.shape, dtype=bool)
    idx = np.clip(np.searchsorted(b, a), 0, b.shape[0] - 1)
    return b[idx] == a
