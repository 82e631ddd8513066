"""Kernel launches per query in the profiled window."""
from harness import readers


def read(r):
    return readers.launches(r, "query")
