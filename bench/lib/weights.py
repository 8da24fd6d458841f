"""Weights drawn on the device from the run's seed, leaf by leaf, so
that the reference can draw any leaf again without the program's copy.

A leaf spec is ``(name, shape, init)`` with ``init`` one of
``("normal", std)``, ``("ones",)`` or ``("zeros",)``; each normal leaf
is one ``randn`` on its own generator.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from bench.lib.seeds import generator

WEIGHTS = 4   # stream number of lib.seeds.derive
CHUNK_ROWS = 1 << 22   # rows drawn at a time for a leaf held below f32

Spec = Tuple[str, Tuple[int, ...], tuple]


def draw_leaf(spec: Spec, index: int, seed: int, device,
              dtype=torch.float32) -> torch.Tensor:
    """Leaf ``index`` of a run's weights in ``dtype``: drawn in f32 (a
    leaf held in a lower dtype ``CHUNK_ROWS`` rows at a time, so no f32
    copy of a whole table exists) and rounded."""
    name, shape, init = spec
    if init[0] == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init[0] == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = generator(seed, WEIGHTS, index, device=device)
    if dtype == torch.float32:
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return t.mul_(init[1])
    out = torch.empty(shape, dtype=dtype, device=device)
    for rows in out.split(CHUNK_ROWS):
        rows.copy_(torch.randn(rows.shape, generator=gen, dtype=torch.float32,
                               device=device).mul_(init[1]))
    return out


def draw(specs: Sequence[Spec], seed: int, device,
         dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Every leaf of ``specs`` in ``dtype``, by name."""
    return {s[0]: draw_leaf(s, i, seed, device, dtype)
            for i, s in enumerate(specs)}


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """``{"a/b": x}`` as ``{"a": {"b": x}}``."""
    out: dict = {}
    for name, leaf in flat.items():
        *parents, last = name.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The inverse of :func:`nest`."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(flat(tree[k], f"{prefix}/{k}" if prefix else k))
    return out

