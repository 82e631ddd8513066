"""Kernel launches per train step in the profiled window."""
from harness import readers


def read(r):
    return readers.launches(r, "train")
