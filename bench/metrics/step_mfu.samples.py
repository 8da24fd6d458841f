"""A step's counted bound (its FLOPs over each dtype's peak, or its bytes
over the bandwidth, the larger) over the window's mean step time."""

from bench.lib import readers


def read(run):
    return readers.step_mfu(run, with_bytes=True)
