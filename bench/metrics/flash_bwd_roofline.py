"""Each attention backward's bound over the device time under the
attention Function's backward op."""

from bench.lib import readers


def read(run):
    return readers.flash(run, "attention_bwd")
