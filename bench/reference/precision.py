"""The precisions the reference computes in.

A configuration states the dtype its products and activations are
held in (``torch_dtype``, ``compute_dtype``) beside f32 masters; the
reference computes in it (``float32`` or ``bfloat16``).  A control
computes one step below: ``mm="float8_e4m3fn"`` rounds both operands of
every linear layer to FP8 E4M3 with one scale for the whole tensor (its
largest magnitude at 448, E4M3's largest finite value), as FP8 training
recipes do; the gradient passes through the rounding unchanged.
"""

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
E4M3_MAX = 448.0


def rounded(x: torch.Tensor, mm: str) -> torch.Tensor:
    """``x`` with its values rounded to ``mm`` (none for ``"none"``),
    in ``x``'s dtype; its gradient is the identity."""
    if mm == "none":
        return x
    if mm != "float8_e4m3fn":
        raise ValueError(f"no rounding to {mm}")
    xd = x.detach().float()
    scale = xd.abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = ((xd / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return q + (x - x.detach())


def linear(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype,
           mm: str = "none") -> torch.Tensor:
    """``x @ w`` with both operands cast to ``dt`` (then rounded to
    ``mm``), the product in ``dt``."""
    return rounded(x.to(dt), mm) @ rounded(w.to(dt), mm)
