"""The whole query's share of the card's bf16 peak."""
from harness import readers


def read(r):
    return readers.mfu(r, "query")
