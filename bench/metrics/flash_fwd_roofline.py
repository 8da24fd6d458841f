"""Each attention forward's bound (causal FLOPs over the bf16 peak, or its
bytes over the bandwidth) over the device time under the attention
Function's forward op, remat recomputes included."""

from bench.lib import readers


def read(run):
    return readers.flash(run, "attention_fwd")
