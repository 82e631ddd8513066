"""Host ms per query of the port's `fused_agg.replay` spans (the fused
aggregation's backward, replayed under autograd), over the traced window's
querys."""
from harness import readers


def read(r):
    return readers.program_span_ms(r, "query", "fused_agg.replay")
