"""Host ms per train step in the traced run: its whole window (spans on),
closed by a synchronize after its last step, over its steps."""
from harness import readers


def read(r):
    return readers.traced_item_ms(r, "train")
