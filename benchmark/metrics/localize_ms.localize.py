"""Host ms per query of the port's `localize` span (scene context,
keypoints and matching), over the traced window's queries."""
from harness import readers


def read(r):
    return readers.program_span_ms(r, "query", "localize")
