"""Model FLOPs of a step (bf16 GEMMs and causal attention, 3 x forward, no
recompute) over the bf16 peak, over the window's mean step time."""

from bench.lib import readers


def read(run):
    return readers.step_mfu(run, with_bytes=False)
