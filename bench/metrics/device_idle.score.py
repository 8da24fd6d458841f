"""The share of the traced stretch in which no kernel, copy or fill ran
on the device."""

from bench.lib import readers


def read(run):
    return readers.idle(run)
