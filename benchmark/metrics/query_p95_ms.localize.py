"""95th percentile of the host ms per query over the traced window's queries
(each from the last one's pose on the host to its own); none under 200
queries, which leave fewer than 10 beyond it. samples(): the queries it
was read from, in the result's `samples`."""
from harness import readers


def read(r):
    return readers.item_quantile_ms(r, "query", 0.95)


def samples(r):
    return len(r.item_ms)
