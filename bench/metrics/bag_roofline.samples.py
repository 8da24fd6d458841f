"""The grouped bag's forward bytes (distinct rows read once, ids, head
and outputs once) over the bandwidth, over the device time of the
kernels launched inside the model's embedding_bags call."""

from bench.lib import readers


def read(run):
    return readers.bag(run)
