"""Host ms per train step: the whole window, closed by a synchronize after
the last step started in it, over its steps."""
from harness import readers


def read(r):
    return readers.per_item_ms(r, "train")
