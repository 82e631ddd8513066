"""Host ms per query of the port's `refine.grad` spans (each gradient of the
refinement's loss), over the traced window's queries."""
from harness import readers


def read(r):
    return readers.program_span_ms(r, "query", "refine.grad")
