"""The card's published peaks, which every roofline share and ``mfu``
of the benchmark divides by.

One NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet, dense rates at
the full 700 W power limit.  ``tf32x3`` is the rate of an f32 product
taken as three TF32 products on the tensor cores (the port's split-TF32
kernels), a third of the TF32 rate.
"""

PEAK_FLOPS = {
    "bf16": 989e12,
    "tf32": 495e12,
    "tf32x3": 165e12,
    "f32": 67e12,
}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops_by_dtype, nbytes: float) -> float:
    """The least time the card could take for this work: the larger of
    each dtype's operations over its own peak, summed, and the bytes over
    the memory's bandwidth."""
    t_ops = sum(f / PEAK_FLOPS[d] for d, f in flops_by_dtype.items())
    return max(t_ops, nbytes / HBM_BYTES_PER_S)
