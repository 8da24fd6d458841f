"""AdamW's bytes (p, g, mu, nu read once; p, mu, nu written once) over
the bandwidth, over the device time of the kernels launched inside the
trainer's adamw_update call."""

from bench.lib import readers


def read(run):
    return readers.adamw(run)
