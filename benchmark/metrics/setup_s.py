"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, the model, the weights, the traffic, the warm-up."""


def read(r):
    return r.setup_s if not r.trace else None
