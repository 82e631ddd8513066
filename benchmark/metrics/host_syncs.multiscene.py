"""Calls that blocked the host inside `span:step`, per profiled step."""
from harness import readers


def read(r):
    return readers.host_syncs(r, "train")
