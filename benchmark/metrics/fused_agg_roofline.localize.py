"""The fused aggregation's share of its roofline in the profiled queries."""
from harness import readers


def read(r):
    return readers.roofline(r, "query")
