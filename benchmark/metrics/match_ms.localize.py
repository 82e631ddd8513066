"""Host ms per query of the port's `localize.match` span (the coarse-to-fine
matching of the keypoints to the query), over the traced window's queries."""
from harness import readers


def read(r):
    return readers.program_span_ms(r, "query", "localize.match")
