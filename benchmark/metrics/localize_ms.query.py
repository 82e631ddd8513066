"""Device ms per query inside localize_parts (context, keypoints, matching), by CUDA events."""
from harness import readers


def read(r):
    return readers.span_ms(r, "query", "localize")
