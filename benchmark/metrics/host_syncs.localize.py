"""Calls that blocked the host inside `span:query`, per profiled query."""
from harness import readers


def read(r):
    return readers.host_syncs(r, "query")
