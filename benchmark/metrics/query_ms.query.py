"""Host ms per query in the traced run: its whole window (spans on) over the
queries completed in it, a query ending when its pose is on the host."""
from harness import readers


def read(r):
    return readers.traced_item_ms(r, "query")
