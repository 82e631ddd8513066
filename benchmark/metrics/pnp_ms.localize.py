"""Host ms per query of the port's `pnp` span (the RANSAC PnP solve), over the
traced window's queries."""
from harness import readers


def read(r):
    return readers.program_span_ms(r, "query", "pnp")
