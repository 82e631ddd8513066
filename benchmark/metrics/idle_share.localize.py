"""% of the profiled queries with no device activity."""
from harness import readers


def read(r):
    return readers.idle_share(r, "query")
