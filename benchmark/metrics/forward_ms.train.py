"""Device ms per step inside train_forward, by CUDA events."""
from harness import readers


def read(r):
    return readers.span_ms(r, "train", "forward")
