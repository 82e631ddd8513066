"""Host ms per query of the port's `localize.context` span (the scene context
of the 10 support views), over the traced window's queries."""
from harness import readers


def read(r):
    return readers.program_span_ms(r, "query", "localize.context")
