"""Device ms per step from the end of train_forward to the end of
apply_gradients (the backward and the update), by CUDA events."""
from harness import readers


def read(r):
    return readers.span_ms(r, "train", "backward")
