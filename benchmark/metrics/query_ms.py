"""Host ms per query: the whole window over the queries completed in it (a
query ends when its pose is on the host)."""
from harness import readers


def read(r):
    return readers.per_item_ms(r, "query")
