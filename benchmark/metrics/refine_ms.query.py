"""Device ms per query inside refine_pose, by CUDA events."""
from harness import readers


def read(r):
    return readers.span_ms(r, "query", "refine")
