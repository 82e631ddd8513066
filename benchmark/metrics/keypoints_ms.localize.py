"""Host ms per query of the port's `localize.keypoints` span (the keypoint
draw from the coarse points), over the traced window's queries."""
from harness import readers


def read(r):
    return readers.program_span_ms(r, "query", "localize.keypoints")
