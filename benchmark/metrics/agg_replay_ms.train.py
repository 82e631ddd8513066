"""Host ms per step of the port's `fused_agg.replay` spans (the fused
aggregation's backward, replayed under autograd), over the traced window's
steps."""
from harness import readers


def read(r):
    return readers.program_span_ms(r, "train", "fused_agg.replay")
