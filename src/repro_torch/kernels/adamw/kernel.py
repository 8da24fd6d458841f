"""One leaf's AdamW update: the CUDA kernel's wrapper and its plain
version.

``adamw_leaf`` takes :func:`adamw_leaf_plain` for CPU tensors and
launches ``csrc/adamw.cu`` for CUDA ones (or raises): one pass over the
leaf that reads p, g, mu and nu once and writes p, mu and nu once, where
the plain version's eager ops sweep it about six times as often.  Both
compute the same f32 operations in the same order, so the kernel's p, mu
and nu equal the plain version's bit for bit; the source says how and
what bounds it.  The reference's AdamW (``repro.train.optim``) is jnp
arithmetic that XLA fuses, with no Pallas kernel behind it: the kernel
replaces none.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.costs import adamw_cost
from repro_torch.kernels.cuda_lib import (
    FLOAT_CODES,
    CudaKernel,
    check_device,
)

_P, _L, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
ADAMW = CudaKernel(
    "adamw",
    [_P] * 7 + [_L] + [_P] * 4 + [_F] * 6 + [ctypes.c_int],
    source="src/repro_torch/csrc/adamw.cu",
    replaces="none: the reference's AdamW is jnp arithmetic that XLA fuses",
)

Leaf = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def adamw_leaf_plain(p, g, mu, nu, scale, lr, bc1, bc2, *, b1: float,
                     b2: float, eps: float, weight_decay: float,
                     donate: bool) -> Leaf:
    """``(p, mu, nu)`` after one AdamW update of a leaf, in eager
    PyTorch: ``g`` scaled by the clip, the moments, the bias-corrected
    step plus the decay, times ``lr``, taken from ``p``; each Python
    float rounded once to f32 where an op meets it, as the reference's
    jnp arithmetic does.  With ``donate`` p, mu and nu are updated in
    place and returned."""
    g = g.float() * scale
    if donate:
        mu = mu.mul_(b1).add_((1 - b1) * g)
        nu = nu.mul_(b2).add_((1 - b2) * g * g)
    else:
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
    del g
    pf = p.float()
    upd = lr * (mu / bc1 / (torch.sqrt(nu / bc2) + eps) + weight_decay * pf)
    if donate and p.dtype == torch.float32:
        return p.sub_(upd), mu, nu
    newp = (pf - upd).to(p.dtype)
    return (p.copy_(newp) if donate else newp), mu, nu


def _check(p, g, mu, nu, scalars) -> None:
    """Raise on what the kernel does not take, on either device: p f32
    or bf16 and g of p's dtype (autograd gives a gradient its leaf's),
    mu and nu f32, all four contiguous and of one shape; ``scale``,
    ``lr``, ``bc1`` and ``bc2`` 0-d f32; all on one device."""
    for name, t, dtypes in (("p", p, FLOAT_CODES), ("g", g, (p.dtype,)),
                            ("mu", mu, (torch.float32,)),
                            ("nu", nu, (torch.float32,))):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {list(dtypes)}, got "
                            f"{t.dtype}")
        if t.shape != p.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, p "
                             f"{tuple(p.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        check_device(t, name)
    for name, t in zip(("scale", "lr", "bc1", "bc2"), scalars):
        if (not isinstance(t, torch.Tensor) or t.dim() != 0
                or t.dtype != torch.float32):
            raise TypeError(f"{name} must be a 0-d float32 tensor")
    devices = {t.device for t in (p, g, mu, nu, *scalars)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")


def adamw_leaf(p, g, mu, nu, scale, lr, bc1, bc2, *, b1: float, b2: float,
               eps: float, weight_decay: float, donate: bool) -> Leaf:
    """:func:`adamw_leaf_plain`'s result: the plain version for CPU
    tensors, one launch of the kernel for CUDA ones (or a raise; none
    for an empty leaf).  ``scale``, ``lr``, ``bc1`` and ``bc2`` are 0-d
    f32 tensors on the leaf's device, read there by the kernel.  Without
    ``donate`` the new p, mu and nu are allocated here."""
    scalars = (scale, lr, bc1, bc2)
    _check(p, g, mu, nu, scalars)
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              donate=donate)
    if p.device.type == "cpu":
        return adamw_leaf_plain(p, g, mu, nu, *scalars, **kw)
    out = (p, mu, nu) if donate else (torch.empty_like(p),
                                      torch.empty_like(mu),
                                      torch.empty_like(nu))
    n = p.numel()
    if n == 0 or ADAMW.charged((p, g, mu, nu, *scalars, *out),
                               lambda: adamw_cost(n, p.dtype, g.dtype)):
        return out
    ADAMW.launch(
        p.device, (n,),
        p.data_ptr(), out[0].data_ptr(), g.data_ptr(), mu.data_ptr(),
        out[1].data_ptr(), nu.data_ptr(), out[2].data_ptr(), n,
        *(t.data_ptr() for t in scalars),
        b1, 1 - b1, b2, 1 - b2, eps, weight_decay,
        FLOAT_CODES[p.dtype],
    )
    return out
